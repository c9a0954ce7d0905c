#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no final line) on failure:

  1. device — the card's name and power limit; build every CUDA kernel of
     the port from ``paddle_tpu_torch/kernels/csrc`` (one nvcc per
     source, started together);
  2. kernels — each kernel's wrapper against its plain PyTorch version
     over a sweep of shapes and dtypes, then timed at the serving path's
     shapes beside its plain version, its bound and, where one exists, one
     PyTorch library call computing the same function (timed only as a
     yardstick): ``decode_attention`` (168 cases: sq 1 to 512, lengths
     around a split boundary, past S_max and 0; 16-bit elements each
     within their own limit; at the four serving shapes two calls
     bit-identical and a planted fault of the split model — a dropped
     split, a shifted query offset — at 4x that limit or more; its 16-bit
     kernels' SASS on wgmma / TMA with no spills), then the
     decode-block pair
     (``decode_block_attn``, ``decode_block_mlp``, and
     ``decode_block_layer``), timed beside the port's unfused layer, then
     the four fused-norm kernels (RMSNorm / LayerNorm forward and
     backward) at the decode, prefill-chunk and train shapes;
  2b. gemv — the bf16 GEMV behind every decode-block projection and ring
     hop (``decode_block.gemv``): a 144-case sweep (rows 1-17, every input
     transform, activation and dtype mix, 1-3 segments) and the 14
     serving shapes each within one bf16 ulp of the plain version, two
     calls bit-identical, the plain model of its summation order inside
     that limit and two planted faults of it outside, its SASS on TMA and
     the tensor cores with no spills, a CUDA graph of one fused decode
     layer replaying to the eager bits; each shape timed beside its plain
     version, its bound and one library product;
  2c. tiny — gpt_tiny and llama_tiny (head_dim 16, zero-padded to the
     kernels' 64) served on the card with the CPU's greedy tokens, and the
     flash kernels at head_dim 16 and 32 against their plain versions;
  3. serving — ``ServingEngine`` over ``GPTForCausalLM(gpt3_6_7b())`` at
     full width (random bf16 weights drawn on the card from a seeded
     generator): 8 requests, prefix-cache hits, chunked prefill, greedy
     and seeded sampling, in two passes (cold, then warm: fresh prompts
     of the same lengths and sharing) on one engine, once on the unfused
     decode step, then on ``fused_decode=True``.  Each engine captures
     its decode step as one CUDA graph at its first decode step and its
     prefill chunk as one graph per chunk width at the first chunk of
     that width, and replays them after (``capture_counts`` 1 decode and
     one a width its plans ran, ``serving.compiles`` and the ``compile``
     events their sum).  Kernel launch counts are zeroed just before each
     run and read just after, and must cover every layer (and every
     norm) of the eager call before each capture and of each capture; a
     decode replay's logits equal the eager body's from the same state,
     a replayed prefill chunk's last logits and K/V rows the eager
     body's bit for bit, with the same kernels under torch.profiler;
     TTFT cold and warm, capture ms per width, each prefill chunk's wall
     time and busy share; on GPT, the unfused engine's warm-up requests
     again on two fresh engines, the second ``record_events=True`` under
     the port's ``Profiler``: the same ``capture_counts``, one
     ``serving.step`` event a step and each request's lane in the
     export, its source gone after ``close()``;
  4. parity — an f32 model of gpt_small width at 2 layers: the fused
     and unfused engines' greedy tokens equal ``generate``'s for 3
     requests;
  5. Llama serving — the same over ``LlamaForCausalLM(llama_7b())`` at
     full width and depth (Llama-2-7B, max_seq 4096): 8 requests of 128
     to 3072 prompt tokens, unfused then ``fused_decode=True``;
  6. Llama parity — an f32 GQA Llama (hidden 768, 12 heads over 4 kv
     heads, 2 layers): engines == ``generate``, and two ``FusedAdamW``
     train steps on the card and on the CPU agree; both parity phases
     also serve tp=2 engines (both shards on the card) on the three
     rungs ``tp_fused_block``, ``tp_fused`` and ``unfused``, whose greedy
     tokens must equal ``generate``'s;
  6b. tp kernels — the sharded decode block's three kernels
     (``ring_entry_hop``, ``ring_exit_hop``, ``decode_block_attn_tp``)
     against their plain versions at every ring seam and the per-shard
     attention shapes of gpt3_6_7b and llama_7b at tp=2, then timed
     beside the plain version, the bound and (for the hops) one library
     product;
  6c. tp serving — ``ServingEngine(tensor_parallel=2,
     devices=["cuda:0", "cuda:0"])``: the full-depth gpt3_6_7b on
     ``tp_fused_block`` then ``tp_fused``, then llama_7b on
     ``tp_fused_block``, the same requests as the tp=1 phases, with the
     launch counts held to their equations (the two shards share the
     card: the ring hops are copies on it, no interconnect is measured);
  6d. serving:spec — speculative decoding at full width and depth on four
     engines (gpt3_6_7b unfused and fused, llama_7b unfused, gpt3_6_7b at
     tp=2 ``tp_fused_block``), each at ``spec_k=4`` and at ``spec_k=0``
     on the reference's speculative traffic (8 slots, 16 requests of 64
     greedy tokens, a 256-token prefix tiled from a 4-token phrase, then
     32-token turns tiled from 2 words), a warm-up pass and a measured
     pass: one verify capture per engine, ``serving.compiles`` the sum of
     the captures, the launch equations; a replayed verify step's logits
     and window K/V rows bit-identical to its eager body's; the verify
     logits at each window position within a stated bound of sequential
     decode steps over the same tokens, the greedy argmax equal wherever
     the sequential top-2 gap exceeds twice the largest difference or
     twice that bound (at least one past the bound), a wrong verify step
     planted (the window one position late) above the bound;
     ``decode_attention`` at the verify width on the engine's own cache
     against its plain version, and the plain version with the causal
     tail off above the same element limit.  Reports decode tokens/s against
     spec_k=0, the acceptance rate, verify and decode step p50 and the
     requests whose tokens equal spec_k=0's; then ``decode_attention`` at
     the verify width (8 x 5 queries) at 1024 and 3072 cached rows timed
     against the split kernel's decode call and its bound, and
     ``decode_block_attn`` at gpt3_6_7b width at 2048 and 3072 rows
     (each head's output within its elements' own limit, a dropped tile
     and a missed fresh row planted in the plain version above it);
  6e. serving:chaos — fault-tolerant serving at full width and depth
     (``FaultToleranceConfig(backoff_base_s=0)``, a ``FaultInjector``, 8
     slots, 12 requests of 8 greedy tokens and a follow-up request):
     ``nan_logits`` on gpt3_6_7b unfused, fused, unfused at spec_k=4 (on
     a verify step) and tp=2 ``tp_fused_block`` fails exactly the
     poisoned request, every other request and the follow-up on the
     poisoned slot equal a fault-free run's; ``step`` x (retries + 1)
     quarantines gpt3_6_7b unfused, llama_7b (max_seq 4096: the rebuild
     must free the old plane first to fit) and tp=2 ``tp_fused``: the
     in-flight requests fail, the queued ones equal a fault-free run's,
     one decode capture more, the rebuild's peak memory under the first
     build's plus the graph pool, its seconds; the ``fused_decode`` rung
     (fused -> unfused, ``tp_fused_block`` -> ``tp_fused``) with one new
     decode capture and the follow-up equal to the new path's; the
     ``spec_verify`` rung: no verify replay after it;
  6f. serving:durable — the journal and the AOT store on gpt3_6_7b at
     full width and depth, unfused, ``spec_k=4``: a cold engine serves
     the 8 serving requests; ``build_engine_store`` captures the 130
     legs (128 prefill widths, decode, verify) on a build engine, which
     then serves them and a second pass uninterrupted; a warm engine on
     the store with a ``Journal`` attaches every leg at construction
     (``aot_status`` warm, ``aot.loads`` 130, 2 launches a leg), serves
     with no capture and no launch, tokens and first decode / verify
     logits equal to the cold engine's, its ledger conserved; its
     journal crashes mid-way through the second pass, a fresh warm
     engine takes ids past the old ones and serves ``replay()``, each
     stream completing the first incarnation's into the uninterrupted
     run's; a ``step`` fault quarantines it: the rebuild re-attaches with
     no capture, the queued requests equal the fault-free run's, one
     terminal record for each failed request; a child process with no
     ``nvcc`` and an empty build directory installs the store's
     libraries and serves one request with the parent's tokens.
     Prints attach seconds, the graph pool, first-pass TTFT warm and
     cold, the rebuild's seconds and peak, the store's size;
  7. train kernels — on an emptied card, the three flash-attention
     kernels (forward, dq, dk/dv) and fused AdamW against their plain
     versions over a sweep (flash: f32 / bf16 / f16, head_dim 64 / 128,
     at and around the forward's 128-row tiles, Sq < Sk, Sq > Sk, GQA,
     views of a fused QKV; 16-bit elements each within their own limit),
     the 16-bit instantiations of the forward, dq and dkv held to wgmma
     and TMA in the built library's SASS (HGMMA and UTMALDG, no HMMA; the
     backward's with no STL / LDL spills), two backward calls at each
     train shape bit-identical, then timed at the train path's shapes
     (q/k/v [2, 2048, 32, 128] bf16 causal; AdamW on one [4096, 16384]
     weight) beside the plain version, the bound and a library yardstick
     (SDPA forward / backward, ``torch.optim.AdamW(fused=True)``);
  7b. varlen — the segment-id variant of the three flash kernels against
     their plain versions over a sweep (f32 / bf16 / f16, head_dim 64 /
     128, causal and not, GQA, padding ids, a segment with no keys, ids in
     no order), then ``flash_attn_unpadded`` forward and backward through
     autograd at 32 heads x 128 (gpt3_6_7b / llama_7b) over 8 packed
     documents in 8192 tokens, bf16, causal: one launch of each kernel and
     no dense call, the result against the plain version over head groups,
     each kernel timed beside its plain version, its bound (visible pairs)
     and SDPA with the block-diagonal causal mask; then a causal call with
     packs that differ takes the dense form;
  8. train — ``GPTHybridTrainer`` at every width of gpt3_6_7b with 12 of
     its 32 layers, batch 2 x 2048, ``FusedAdamW(multi_precision=True)``,
     one repeated batch: 2 warm-up steps, then 6 steps with the counts
     zeroed just before and read just after (each flash kernel 12 x 6,
     each LayerNorm kernel 25 x 6, fused_adamw parameter tensors x 6);
     the loss falls, every parameter gets a finite gradient and every qkv
     weight a nonzero one; one step under torch.profiler;
  9. train parity — an f32 model of gpt_small width at 2 layers: two
     ``FusedAdamW`` train steps on the card and on the CPU (plain
     versions) from the same weights agree;
 10. hybrid train — ``fleet.init`` + ``get_hybrid_communicate_group()`` +
     ``GPTHybridTrainer`` with every rank on the one card: f32 parity at
     gpt_small width (4 layers, seq 256, TF32 off, ``FusedAdamW``) of the
     serial trainer against ``{dp 2, mp 2, pp 2}`` (2 microbatches) and
     ``{pp 2, sharding 2}`` (ZeRO-3, VPP 2, 4 microbatches): losses at the
     reference oracle's rtol 2e-4 / 2e-3, every parameter within Adam's
     2·lr a step; then gpt3_6_7b widths at 8 of 32 layers, bf16, batch 4 x
     2048, ``FusedAdamW(multi_precision=True)``, the serial trainer, ``{mp
     2, pp 2}`` (4 microbatches, ZeRO-1) and ``{pp 2, sharding 2}`` (ZeRO-3,
     VPP 2, 4 microbatches): 2 warm-up and 6 timed steps each, the counts
     zeroed just before and read just after and held to the layout's
     prediction (``hybrid_want``), step 1's loss within 1e-2 of the serial
     trainer's; step p50, tokens/s, model-FLOP share, memory after the
     build and at the peak;
 10b. example train — the reference's fleet example
     (``paddle_tpu_torch/examples/train_gpt_hybrid.py``) on the card: (a)
     its flow (``fleet.init``, ``hcg.get_mesh()``, ``sp=True,
     remat=True``, ``FusedAdamW(multi_precision=True, grad_clip=
     ClipGradByGlobalNorm(1.0))``) at gpt3_6_7b widths, 8 of 32 layers,
     bf16, batch 4 x 2048, ``{mp 2, pp 2}``, 4 microbatches: step 1's loss
     against ``sp=False, remat=False`` from the same weights (within
     1e-2), 2 warm-up and 6 timed steps with the counts zeroed just before
     and read just after and held to ``hybrid_want`` (the flash and
     LayerNorm forwards twice a block), step p50, tokens/s, model-FLOP
     share, memory after the build and at the peak, one step profiled with
     the clip's device time; (b) the serial trainer with remat at 20
     layers, batch 2 x 2048, 2 steps, its peak memory; (c) auto-resume at
     2 layers: the example script trains 4 steps straight, then 2 steps
     under ``{mp 2, pp 2}``, ``save_auto_resume`` (free disk checked
     first), a serial trainer, ``load_auto_resume``, 2 steps within 1e-2
     of the straight run's, the bytes written and the seconds to save and
     load.  The train phases before it pass ``remat=False``;
 10c. semi-auto train — the reference's semi-auto Llama example
     (``paddle_tpu_torch/examples/train_llama_semi_auto.py``): llama_7b
     widths at 12 of 32 layers, bf16, batch 4 x 2048, the example's loss
     and ``AdamW(1e-3)``, built serial (``process_mesh=None``) and
     through ``shard_layer(llama_shard_fn)`` over ``dp 2 x mp 4`` (every
     rank on the card) from the same weights: rows 4-8 against their
     plain versions at the path's shapes and timed beside their bounds;
     4 ``Engine.fit`` steps each, the counts zeroed just before and read
     just after and held to ``semi_auto_want`` (flash L x dp x mp, RMSNorm
     2L + 1 a step), every gradient of step 1 and each step's loss held
     sharded against serial, step p50, tokens/s, model-FLOP share, peak
     memory; then 4 sharded steps under the port's
     ``Profiler`` (GPU target, ``scheduler=(1, 3)``,
     ``export_chrome_tracing``): the export holds the host events and
     rows 4-8's kernels, ``summary()`` and the device busy share printed;
 10d. moe train — the reference's expert-parallel GPT-MoE
     (``GPTMoEHybridTrainer``) at the repo's production MoE width
     (gpt3_6_7b widths, 8 experts, top-2 naive gate, capacity 1.25, aux
     0.01, bf16) cut to 2 of 32 layers, batch 4 x 2048,
     ``FusedAdamW(multi_precision=True)``: rows 4-6 and 9-11 against their
     plain versions at the path's shapes and timed beside their bounds and
     a library call; the serial trainer, ``{ep 2, pp 2, sharding 2}``
     (ZeRO-1, 2 microbatches) and ``{dp 2, ep 2, mp 2}``, every rank on the
     card, built from the same weights and freed in turn: step 1 at
     microbatches 1 against serial (the loss within 1e-2, the share of
     tokens whose top-2 set flips a layer), 4 timed steps with the counts
     zeroed just before and read just after and held to ``moe_want``,
     step p50, tokens/s, the model-FLOP share over the active parameters,
     memory, ``expert_util`` / ``token_keep_rate`` a layer; one step of
     the serial and the example's layout under the port's ``Profiler``
     split into dense GEMMs, expert bmm, dispatch and combine, flash,
     norms, AdamW and the rest; then ``examples/train_moe_ep.py`` at its
     defaults on the card;
 10e. wmt train — BASELINE config #2, the ``nn.Transformer``
     encoder-decoder at the repo's WMT row (a shared 32k x 512 embedding,
     Transformer-base 6 + 6, a 32k head; 76.9M parameters in 255
     tensors), bf16, batch 32 x 512, ``FusedAdamW(NoamDecay(512, 4000),
     beta2 0.997, epsilon 1e-9, multi_precision=True)``, seeded token
     ids: rows 4-6 and 9-11 against their plain versions at the phase's
     shapes (row 4 also at decoding's one query row against 1, 7, 32
     and 512 keys) and timed beside their bounds and a library call;
     step 1 in f32 against bf16 at dropout 0; (a) the recipe (padded
     sources, the key-padding and causal masks, ``cross_entropy`` with
     the pad ignored and label smoothing 0.1, dropout 0.1 everywhere:
     every attention call dense) and (b) the flash route (attention
     dropout 0, full-length sources: 12 flash calls and 6 dense a
     forward), 2 warm-up and 6 timed
     steps each with the counts zeroed just before and read just after
     and held to ``wmt_want``: step p50, tokens/s, the model-FLOP share,
     peak memory, one step under torch.profiler by kind (GEMM, dense
     attention, cross entropy, LayerNorm, AdamW, flash, the rest); (b)
     one MHA call flash against dense; (c) cached decoding
     (``decoder.gen_cache``, 32 steps of one token for the 32 rows) held
     to the uncached causal decoder, ms a step;
 11. Llama train — ``LlamaForCausalLM(llama_7b())`` with 12 of its 32
     layers, batch 1 x 4096: forward, ``loss``, backward, one
     ``FusedAdamW(multi_precision=True)`` step; 2 warm-up and 6 counted
     steps (each flash kernel 12, each RMSNorm kernel 25, fused_adamw 111
     per step); the loss falls, gradients are finite and every RMSNorm
     weight's is nonzero; one step under torch.profiler.

Each phase prints its peak device memory.  The last lines are a JSON
object describing every kernel, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA card;
imports nothing of JAX.

    python3 chip_smoke.py --serve-ab PARENT_CHECKOUT

runs this file's GPT and Llama serving phases (TTFT, decode step and its
profiled kernel time, wall time and busy share, each prefill chunk's
device time by kind and by kernel) and gpt3_6_7b at tp=2 on ``tp_fused_block``, and times
``decode_attention`` (card and host time a call), the 14 GEMV shapes, the
decode-block halves and the block / hop wrappers' host time, on another
checkout's package and on this one's in turns (parent, this, this,
parent), each in its own process, to compare two commits on one card;
then compares the SASS of the kernels this checkout keeps (the f32 GEMV,
the attention kernels) with the other's build.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the device every phase runs on
DEVICE = "cuda"

# published H100 SXM peaks (dense): HBM bandwidth and bf16 tensor rate;
# f32 work outside the tensor cores peaks at 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# the full-width serving engine
ENGINE_KW = dict(num_slots=8, min_bucket=16, block_len=16, prefill_chunk=512)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 10, windows: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: the median over
    ``windows`` windows of the mean over ``iters`` back-to-back calls, by
    CUDA events, after a warm-up (one slow window, such as the first after
    the card idled, does not move the median)."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


# ----------------------------------------------------------- attention
def attention_bound(q, k_cache, seq_lens, causal: bool = True):
    """Least time (ms) the card needs for one decode-attention call on
    these inputs, and what bounds it: the bytes it must move (q once,
    the K/V rows the lengths make visible once, the output once) over
    HBM bandwidth, or its multiply-adds (QK and PV over each query's
    visible keys) over the dtype's peak rate."""
    b, sq, h, d = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    es = q.element_size()
    lens = [int(x) for x in seq_lens.tolist()]
    kv_rows = sum(min(max(n, 0), s_max) for n in lens)
    nbytes = 2 * b * sq * h * d * es + 2 * kv_rows * kvh * d * es
    visible = 0
    for n in lens:
        for t in range(sq):
            hi = min(n, s_max, n - sq + t + 1) if causal else min(n, s_max)
            visible += max(hi, 0)
    flops = 4 * d * h * visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k_cache, v_cache, seq_lens, causal: bool = True):
    """The same function as one library call (timed as a yardstick
    only): scaled_dot_product_attention with the equivalent boolean
    mask, on pre-transposed views."""
    import torch
    import torch.nn.functional as F
    b, sq, h, d = q.shape
    s_max = k_cache.shape[1]
    kpos = torch.arange(s_max, device=q.device)[None, None, None, :]
    lens = seq_lens.long()[:, None, None, None]
    mask = kpos < lens
    if causal:
        qpos = torch.arange(sq, device=q.device)[None, None, :, None]
        mask = mask & (kpos <= lens - sq + qpos)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_cache, v_cache))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


DECODE_OPS = ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL")
# a planted fault must read at least this many times its elements' own
# limit (``row_reading``), so that the check is shown to have room to fail
FAULT_READING = 4.0
# the serving paths' decode-attention shapes (bf16): at gpt3_6_7b width, a
# decode step over 8 slots of a 2048-row cache filled to 1024 and a
# 512-wide prefill chunk whose last query sits at row 1536; at llama_7b
# width, a decode step over 8 slots of a 4096-row cache at ragged lengths
# up to 3104 (a 3072-token prompt and 32 new tokens) and the last
# 512-wide chunk of that prompt
DECODE_SHAPES = {
    "decode": ((8, 1, 32, 128), (8, 2048, 32, 128), [1024] * 8),
    "prefill": ((1, 512, 32, 128), (1, 2048, 32, 128), [1536]),
    "llama_decode": ((8, 1, 32, 128), (8, 4096, 32, 128),
                     [160, 672, 1056, 1568, 2080, 2592, 3104, 3104]),
    "llama_prefill": ((1, 512, 32, 128), (1, 4096, 32, 128), [3072]),
}


def phase_kernels(card: str):
    """Hold the kernel against its plain version over the sweep, then
    check and time it at the serving paths' shapes: two calls
    bit-identical, two planted faults read above the limit, the 16-bit
    kernels' SASS on wgmma / TMA with no spills.  Returns the kernel's
    record (without launches) and the max abs error at those shapes."""
    import torch
    from paddle_tpu_torch.kernels import _build, sass
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    split = da._SPLIT_ROWS

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # f32: only the summation order differs; 16-bit: the output cast and
    # (tensor-core path) the 16-bit P of the P V product.  16-bit outputs
    # are also held element by element to the flash phases' limit
    # (``row_reading`` <= 1: 2 ulps of the element + 2 ulps of its row's
    # largest |value| + 1e-4), far below atol 2e-2 at outputs of ~0.03
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
           torch.float16: dict(atol=2e-2, rtol=2e-2)}
    worst, reads = {}, {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (64, 128):
            for rep in (1, 4):
                for sq in (1, 7, 48, 64, 65, 128, 512):
                    b, h, s_max = 7, 8, 1024
                    q = rand((b, sq, h, d), dtype)
                    k = rand((b, s_max, h // rep, d), dtype)
                    v = rand((b, s_max, h // rep, d), dtype)
                    # ragged: 1, S_max, past S_max, shorter than sq, a
                    # split's last row, the next split's first row, and 0
                    lens = torch.tensor([1, s_max, s_max + 37,
                                         max(sq - 3, 0), split, split + 1,
                                         0], dtype=torch.int32, device=dev)
                    for causal in (True, False):
                        out = decode_attention(q, k, v, lens,
                                               causal_tail=causal)
                        torch.cuda.synchronize()
                        ref = decode_attention_reference(
                            q, k, v, lens, causal_tail=causal)
                        err = (out.float() - ref.float()).abs().max().item()
                        key = str(dtype).replace("torch.", "")
                        worst[key] = max(worst.get(key, 0.0), err)
                        read = (0.0 if dtype == torch.float32
                                else row_reading(out, ref))
                        reads[key] = max(reads.get(key, 0.0), read)
                        if not torch.allclose(out.float(), ref.float(),
                                              **tol[dtype]) or read > 1.0:
                            raise AssertionError(
                                f"decode_attention disagrees with its plain "
                                f"version: dtype={dtype} D={d} rep={rep} "
                                f"sq={sq} causal={causal} max_abs_err={err} "
                                f"element reading {read}")
                        if not torch.all(out[6] == 0):
                            raise AssertionError(
                                f"decode_attention: a row of length 0 gave "
                                f"nonzero output: dtype={dtype} D={d} "
                                f"rep={rep} sq={sq} causal={causal}")
                        cases += 1
    log(f"[kernels] decode_attention sweep: {cases} cases within "
        f"tolerance (f32 atol 1e-4; bf16/f16 atol/rtol 2e-2 and every "
        f"element within its own limit; sq 1, 7, 48, 64, 65, 128, 512; "
        f"lengths 1, S_max, past S_max, sq - 3, the {split}-row split's "
        f"last row, the next split's first, 0 (exactly 0 out)); max abs "
        f"err {json.dumps(worst)}, largest element reading "
        f"{json.dumps(reads)}")

    # the 16-bit kernels as built: the chunk kernel on wgmma and TMA (HGMMA,
    # UTMALDG, no mma.sync HMMA), neither with local-memory spills (STL /
    # LDL), the split kernel's K / V through TMA
    lib = str(_build._library_path("decode_attention"))
    kernel_sass = {k: sass.instruction_counts(lib, k, DECODE_OPS)
                   for k in ("chunk_wgmma_kernel", "decode_split_kernel")}
    chunk, dsplit = (kernel_sass["chunk_wgmma_kernel"],
                     kernel_sass["decode_split_kernel"])
    if len(chunk) != 4 or any(
            c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] != 0
            or c["STL"] != 0 or c["LDL"] != 0 for c in chunk.values()):
        raise AssertionError(f"chunk_wgmma_kernel's instantiations (bf16/f16 "
                             f"x head_dim 64/128) must each hold HGMMA and "
                             f"UTMALDG and no HMMA, STL or LDL: "
                             f"{json.dumps(chunk)}")
    if len(dsplit) != 8 or any(c["UTMALDG"] == 0 or c["STL"] != 0
                               or c["LDL"] != 0 for c in dsplit.values()):
        raise AssertionError(f"decode_split_kernel's instantiations (bf16/f16 "
                             f"x head_dim 64/128 x 1 or 4 heads) must each "
                             f"hold UTMALDG and no STL or LDL: "
                             f"{json.dumps(dsplit)}")
    log(f"[kernels] SASS of the 16-bit decode kernels (cuobjdump -sass; "
        f"HGMMA wgmma, UTMALDG TMA loads, HMMA mma.sync, STL / LDL spills): "
        f"{json.dumps(kernel_sass)}")

    # a planted fault at each Llama shape, made by the split model: split
    # 1's partial dropped (decode) and every query's offset shifted by one
    # (chunk); each must read at least FAULT_READING times its elements'
    # own limit
    faults = {"llama_decode": dict(drop=1), "llama_prefill": dict(shift=1)}
    rec = {}
    err_main = 0.0
    for name, (qs, ks, lens) in DECODE_SHAPES.items():
        q = rand(qs, torch.bfloat16)
        k = rand(ks, torch.bfloat16)
        v = rand(ks, torch.bfloat16)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, seq_lens)
        again = decode_attention(q, k, v, seq_lens)
        ref = decode_attention_reference(q, k, v, seq_lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        read = row_reading(out, ref)
        if not torch.allclose(out.float(), ref.float(),
                              **tol[torch.bfloat16]) or read > 1.0:
            raise AssertionError(f"decode_attention disagrees at the {name} "
                                 f"shape: max_abs_err={err}, element "
                                 f"reading {read}")
        if not torch.equal(out, again):
            raise AssertionError(f"decode_attention: two calls at the {name} "
                                 f"shape differ")
        err_main = max(err_main, err)
        fault = {}
        if name in faults:
            model = decode_split(q, k, v, seq_lens, split)
            wrong = decode_split(q, k, v, seq_lens, split, **faults[name])
            model_read = row_reading(out, model)
            fault_read = row_reading(wrong, ref)
            if model_read > 1.0:
                raise AssertionError(f"the split model disagrees with the "
                                     f"kernel at the {name} shape: element "
                                     f"reading {model_read}")
            if fault_read < FAULT_READING:
                raise AssertionError(f"the planted fault {faults[name]} at "
                                     f"the {name} shape reads only "
                                     f"{fault_read} (want >= "
                                     f"{FAULT_READING})")
            fault = {"planted_fault": faults[name],
                     "planted_fault_reading": fault_read,
                     "planted_fault_max_abs_err":
                         (wrong.float() - ref.float()).abs().max().item(),
                     "split_model_reading": model_read}
            log(f"[kernels] decode_attention {name}: the split model (split "
                f"{split}) agrees with the kernel (element reading "
                f"{model_read:.3g}); with the planted fault {faults[name]} "
                f"it reads {fault_read:.3g} against the plain version "
                f"(max abs err {fault['planted_fault_max_abs_err']:.3g}), "
                f"above {FAULT_READING}")
        if qs[1] > 1:
            n, sq = lens[0], qs[1]
            tiles = sum(len(t) for _, comp in
                        chunk_walk(n, sq, ks[1], True).values()
                        for t in comp.values())
            visible = sum(max(0, min(n, n - sq + t + 1)) for t in range(sq))
            log(f"[kernels] decode_attention {name}: the chunk walk's model "
                f"computes {tiles} (64-query group, 128-key tile) pairs a "
                f"head, {tiles * 64 * 128} (query, key) pairs for {visible} "
                f"visible")
        bound, bound_by = attention_bound(q, k, seq_lens)
        ms = time_ms(lambda: decode_attention(q, k, v, seq_lens))
        # the card's own time: back to back, a call of ~0.05 ms can wait
        # on the wrapper's host time (checks, three tensor maps encoded)
        dev_ms = device_ms(lambda: decode_attention(q, k, v, seq_lens))
        plain_ms = time_ms(lambda: decode_attention_reference(q, k, v,
                                                              seq_lens))
        library_ms = time_ms(sdpa_call(q, k, v, seq_lens))
        rec[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "max_abs_err": err, "element_reading": read,
                     "bit_identical": True, **fault,
                     "q": list(qs), "kv": list(ks), "seq_lens": lens}
        log(f"[kernels] decode_attention {name} q{list(qs)} kv{list(ks)} "
            f"seq_lens {lens} bf16: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}); max abs err {err:.3g}, element "
            f"reading {read:.3g}; two calls bit-identical (card: {card})")
    rec["sass"] = kernel_sass
    rec["sweep_cases"] = cases
    rec["sweep_max_abs_err"] = worst
    rec["sweep_element_reading"] = reads
    return rec, err_main


# --------------------------------------------------------- decode block
def block_case(g, *, b, s_max, heads, kv_heads, dh, ffn, dtype, wiring,
               act="gelu_tanh", biases=None):
    """Random inputs of one decode-block layer on the card: ``(x, k, v,
    kw)`` where ``kw`` are ``decode_block_layer``'s keywords.  ``wiring``
    "gpt" is LayerNorm, every bias, ``act``, MHA; "llama" is RMSNorm, no
    bias, rotary, SwiGLU.  ``biases`` (a set of names) keeps only those
    biases."""
    import torch
    dev = torch.device(DEVICE)
    d = heads * dh

    def r(*shape, scale=0.05):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    gpt = wiring == "gpt"
    kw = dict(kv_heads=kv_heads, head_dim=dh, norm="layer" if gpt else "rms",
              eps1=1e-5, eps2=1e-5, norm1_w=r(d) + 1, norm1_b=r(d),
              wq=r(d, heads * dh), wk=r(d, kv_heads * dh),
              wv=r(d, kv_heads * dh), bq=r(heads * dh), bkv=r(kv_heads * dh),
              bv=r(kv_heads * dh), wo=r(heads * dh, d), bo=r(d),
              norm2_w=r(d) + 1, norm2_b=r(d), w1=r(d, ffn), b1=r(ffn),
              w2=r(ffn, d), b2=r(d), act=act)
    names = ("norm1_b", "bq", "bkv", "bv", "bo", "norm2_b", "b1", "b2")
    keep = set(names) if gpt and biases is None else set(biases or ())
    for n in names:
        if n not in keep:
            kw[n] = None
    if not gpt:
        kw["w_gate"] = r(d, ffn)
        ang = torch.rand((b, dh // 2), generator=g, device=dev) * 3.0
        kw["rope_cos"] = torch.cat([ang.cos()] * 2, -1)
        kw["rope_sin"] = torch.cat([ang.sin()] * 2, -1)
    x = r(b, 1, d, scale=1.0)
    k = r(b, s_max, kv_heads, dh, scale=1.0)
    v = r(b, s_max, kv_heads, dh, scale=1.0)
    return x, k, v, kw


_ATTN_KEYS = ("norm1_w", "norm1_b", "wq", "wk", "wv", "bq", "bkv", "bv")
_MLP_KEYS = ("wo", "bo", "norm2_w", "norm2_b", "w1", "b1", "w2", "b2")


def attn_call(fn, x, k, v, pos, kw, **extra):
    """``decode_block_attn`` (or its plain version ``fn``) on a layer's
    keywords."""
    return fn(x, k, v, pos, *(kw[n] for n in _ATTN_KEYS),
              kv_heads=kw["kv_heads"], head_dim=kw["head_dim"],
              norm=kw["norm"], eps=kw["eps1"], rope_cos=kw.get("rope_cos"),
              rope_sin=kw.get("rope_sin"), **extra)


def attn_reading(got, want, head_dim: int) -> float:
    """``row_reading`` of a ``decode_block_attn`` output ``[B, 1, H*Dh]``
    with one head of one slot as a row."""
    return row_reading(got.reshape(got.shape[0], -1, head_dim),
                       want.reshape(want.shape[0], -1, head_dim))


def attn_faults(x, k, v, pos, kw, block_k, want) -> dict:
    """Two planted faults of ``decode_block_attn``, made by its plain
    version with a wrong attention call: the last full ``block_k`` tile
    before each slot's fresh row dropped, and the fresh row itself missed
    (``pos`` keys in place of ``pos + 1``).  Each must read above 1
    against ``want`` (``attn_reading``): the check fails it.  Their
    readings."""
    import torch
    from paddle_tpu_torch.kernels import decode_block as db
    right = db.decode_attention_reference

    def tile_dropped(q, kc, vc, lens, scale=None, causal_tail=True):
        kpos = torch.arange(kc.shape[1], device=kc.device)[None, :]
        end = ((lens.long() - 1) // block_k * block_k)[:, None]
        keep = (kpos < end - block_k) | (kpos >= end)
        rep = q.shape[2] // kc.shape[2]
        if scale is None:
            scale = q.shape[-1] ** -0.5
        s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                         kc.repeat_interleave(rep, 2).float()) * scale
        s = s.masked_fill(~(keep & (kpos < lens.long()[:, None]))
                          [:, None, None, :], float("-inf"))
        return torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1),
                            vc.repeat_interleave(rep, 2).float()
                            ).to(q.dtype)

    def fresh_missed(q, kc, vc, lens, scale=None, causal_tail=True):
        return right(q, kc, vc, lens - 1, scale=scale,
                     causal_tail=causal_tail)

    out = {}
    for name, wrong in (("tile dropped", tile_dropped),
                        ("fresh row missed", fresh_missed)):
        db.decode_attention_reference = wrong
        try:
            bad, _, _ = attn_call(db.decode_block_attn_reference, x,
                                  k.clone(), v.clone(), pos, kw)
        finally:
            db.decode_attention_reference = right
        out[name] = attn_reading(bad, want, kw["head_dim"])
        if out[name] <= 1.0:
            raise AssertionError(f"decode_block_attn: the planted fault "
                                 f"{name} reads only {out[name]}: the check "
                                 f"cannot see it")
    return out


def mlp_call(fn, x, attn, kw, **extra):
    """``decode_block_mlp`` (or its plain version ``fn``) on a layer's
    keywords."""
    if "act" in kw:                     # a SwiGLU layer has none
        extra["act"] = kw["act"]
    return fn(x, attn, *(kw[n] for n in _MLP_KEYS), kw.get("w_gate"),
              norm=kw["norm"], eps=kw["eps2"], **extra)


def block_bounds(x, kw, seq_pos, s_max):
    """Least time (ms) of each half at these inputs, and what bounds it.
    Bytes: every weight, bias and norm vector once, the live K/V rows
    ``kpos < min(pos, S-1)`` once, the fresh K/V rows written once, the
    activations in and out once.  Operations: the projections' and the
    attention's multiply-adds at these positions, over the peak rate of
    the inputs' dtype."""
    b, _, d = x.shape
    es = x.element_size()
    kv, dh = kw["kv_heads"], kw["head_dim"]
    hd = kw["wq"].shape[1]
    ffn = kw["w1"].shape[1]
    gated = kw.get("w_gate") is not None
    posw = [min(max(int(p), 0), s_max - 1) for p in seq_pos]

    def n(*names):
        return sum(kw[m].numel() for m in names if kw.get(m) is not None)
    attn_bytes = es * (n(*_ATTN_KEYS) + b * d + b * hd
                       + 2 * kv * dh * (sum(posw) + b))
    attn_ops = 2 * b * d * (hd + 2 * kv * dh) + 4 * hd * sum(p + 1
                                                             for p in posw)
    mlp_bytes = es * (n(*_MLP_KEYS, "w_gate") + 2 * b * d + b * hd)
    mlp_ops = 2 * b * (hd * d + d * ffn * (2 if gated else 1) + ffn * d)
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    out = {}
    for name, nbytes, ops in (("attn", attn_bytes, attn_ops),
                              ("mlp", mlp_bytes, mlp_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        out[name + "_bytes"] = nbytes
    return out


def _ulp_ok(got, want, dtype, atol: float = 0.0) -> bool:
    """Slabs agree: f32 within atol 1e-4; bf16 within one bf16 ulp of the
    plain version's value (f32 projections summed in another order may
    round the stored row differently), plus ``atol`` for values near 0."""
    import torch
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return bool(torch.allclose(got, want, atol=1e-4, rtol=0.0))
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    return bool(((got - want).abs() <= ulp + atol).all())


def phase_block_kernels(card: str):
    """Hold ``decode_block_layer``, ``decode_block_attn`` and
    ``decode_block_mlp`` against their plain versions over the sweep and
    at one layer of each served model (gpt3_6_7b, llama_7b), and time each
    half there beside its plain version, its bound and the model's unfused
    layer.  Returns the records of the two kernels (without launches)."""
    import torch
    from paddle_tpu_torch.kernels.decode_block import (
        decode_block_attn, decode_block_attn_reference, decode_block_layer,
        decode_block_mlp, decode_block_mlp_reference, decode_block_reference,
        plan_decode_block)
    from paddle_tpu_torch.models import gpt3_6_7b
    from paddle_tpu_torch.models.gpt import GPTBlock
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    # f32: only the summation order differs; bf16: the attention output
    # and y are cast once, the K/V rows may round one ulp apart
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    b, s_max = 4, 256
    # (heads, kv_heads, head_dim, ffn, wiring, extra keywords, block_k)
    cases = []
    for dh in (64, 128):
        cases.append((8, 8, dh, 4 * 8 * dh, "gpt", {}, None))
        cases.append((8, 2, dh, 3 * 8 * dh, "llama", {}, None))
    cases += [
        (8, 8, 64, 2048, "gpt", dict(act="gelu"), None),            # exact
        (8, 4, 128, 2048, "gpt", dict(biases={"bq", "bo", "b2"}), None),
        (8, 2, 128, 1024, "llama", {}, 32),      # shared-memory tile path
        (4, 4, 16, 256, "gpt", {}, None),        # gpt_tiny's head_dim
    ]
    worst = {}
    n_checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for heads, kvh, dh, ffn, wiring, extra, bk in cases:
            x, k0, v0, kw = block_case(g, b=b, s_max=s_max, heads=heads,
                                       kv_heads=kvh, dh=dh, ffn=ffn,
                                       dtype=dtype, wiring=wiring, **extra)
            tiles = {} if bk is None else dict(block_k=bk)
            ragged = torch.tensor([0, s_max // 2, s_max - 1, s_max],
                                  dtype=torch.int32, device=dev)
            scalar = torch.tensor(100, dtype=torch.int32, device=dev)
            for pos in (ragged, scalar):
                what = (f"dtype={dname} wiring={wiring} H={heads} KH={kvh} "
                        f"Dh={dh} F={ffn} {extra} block_k={bk} "
                        f"pos={pos.tolist()}")
                posw = pos.expand(b).long().clamp(0, s_max - 1)
                k1, v1 = k0.clone(), v0.clone()
                y, _, _ = decode_block_layer(x, k1, v1, pos, **kw, **tiles)
                k2, v2 = k0.clone(), v0.clone()
                yr, _, _ = decode_block_reference(x, k2, v2, pos, **kw)
                a1, _, _ = attn_call(decode_block_attn, x, k0.clone(),
                                     v0.clone(), pos, kw, **tiles)
                ar, _, _ = attn_call(decode_block_attn_reference, x,
                                     k0.clone(), v0.clone(), pos, kw)
                m1 = mlp_call(decode_block_mlp, x, ar, kw)
                mr = mlp_call(decode_block_mlp_reference, x, ar, kw)
                torch.cuda.synchronize()
                for name, got, want in (("decode_block_layer", y, yr),
                                        ("decode_block_attn", a1, ar),
                                        ("decode_block_mlp", m1, mr)):
                    err = (got.float() - want.float()).abs().max().item()
                    key = f"{name} {dname}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    if not torch.allclose(got.float(), want.float(),
                                          **tol[dtype]):
                        raise AssertionError(
                            f"{name} disagrees with its plain version: "
                            f"{what} max_abs_err={err}")
                for name, got, want, before in (("k", k1, k2, k0),
                                                ("v", v1, v2, v0)):
                    if not _ulp_ok(got, want, dtype):
                        err = (got.float() - want.float()).abs().max().item()
                        raise AssertionError(
                            f"decode_block_layer's {name} slab disagrees with "
                            f"the plain version's: {what} max_abs_err={err}")
                    changed = (got != before).flatten(2).any(-1)   # [b, S]
                    changed[torch.arange(b, device=dev), posw] = False
                    if bool(changed.any()):
                        raise AssertionError(
                            f"decode_block_layer changed a {name} slab row "
                            f"other than min(pos, S-1): {what}")
                n_checked += 1
    log(f"[kernels] decode_block sweep: {n_checked} cases (f32/bf16 x GPT/"
        f"Llama wiring x head_dim 64/128, exact gelu, mixed biases, the "
        f"tile path, head_dim 16; ragged pos 0/mid/S-1/S and a scalar pos) "
        f"within tolerance (f32 atol 1e-4; bf16 atol/rtol 2e-2, slabs one "
        f"bf16 ulp, only row min(pos, S-1) changed); max abs err "
        f"{json.dumps(worst)}")

    # each served model's decode shape: one layer (random bf16 weights)
    # over 8 slots of its full-length slabs, timed beside its plain
    # version, its bound and the model's unfused layer.  gpt3_6_7b: a
    # 2048-row cache filled to 1024, LayerNorm, gelu_tanh, every bias;
    # llama_7b: a 4096-row cache at ragged positions near 3000 (the
    # served prompts reach 3072), RMSNorm, rotary, SwiGLU at ffn 11008
    from paddle_tpu_torch.models import llama_7b
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               fused_rope_tables)
    rec = {"attn": {}, "mlp": {}}
    for model in ("gpt3_6_7b", "llama_7b"):
        bsz = 8
        if model == "gpt3_6_7b":
            cfg = gpt3_6_7b()
            layer = GPTBlock(cfg, device=dev, dtype=torch.bfloat16,
                             generator=g).eval()
            kw = layer.decode_block_weights()
            heads, ffn = cfg.num_heads, cfg.ffn_size
            pos = torch.full((bsz,), 1024, dtype=torch.int32, device=dev)
        else:
            cfg = llama_7b()
            layer = LlamaDecoderLayer(cfg, device=dev, dtype=torch.bfloat16,
                                      generator=g).eval()
            heads, ffn = cfg.num_heads, cfg.intermediate_size
            pos = torch.tensor([2976, 2990, 2999, 3000, 3013, 3047, 3080,
                                3103], dtype=torch.int32, device=dev)
            kw = layer.decode_block_weights()
            kw["rope_cos"], kw["rope_sin"] = fused_rope_tables(pos, cfg)
        s_max, dh, kvh = cfg.max_seq_len, cfg.head_dim, kw["kv_heads"]
        x = torch.randn((bsz, 1, cfg.hidden_size), generator=g,
                        device=dev).to(torch.bfloat16)
        k = torch.randn((bsz, s_max, kvh, dh), generator=g,
                        device=dev).to(torch.bfloat16)
        v = torch.randn_like(k)
        plan, why = plan_decode_block(
            max_seq=s_max, hidden=cfg.hidden_size, heads=heads,
            kv_heads=kvh, head_dim=dh, ffn=ffn, batch=bsz, itemsize=2,
            gated=kw.get("w_gate") is not None)
        if plan is None:
            raise AssertionError(f"no decode-block plan at {model}: {why}")
        bk, bf = plan["block_k"], plan["block_f"]
        what = (f"{model} layer: x[{bsz},1,{cfg.hidden_size}] "
                f"kv[{bsz},{s_max},{kvh},{dh}] pos {pos.tolist()} bf16")
        with torch.no_grad():
            k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
            ar, _, _ = attn_call(decode_block_attn_reference, x, k2, v2, pos,
                                 kw)
            a1, _, _ = attn_call(decode_block_attn, x, k1, v1, pos, kw,
                                 block_k=bk)
            mr = mlp_call(decode_block_mlp_reference, x, ar, kw)
            m1 = mlp_call(decode_block_mlp, x, ar, kw, block_f=bf)
            torch.cuda.synchronize()
            errs = {"attn": (a1.float() - ar.float()).abs().max().item(),
                    "mlp": (m1.float() - mr.float()).abs().max().item()}
            # the attention output element by element (one head as a
            # row), and two planted faults of it that must read above
            attn_read = attn_reading(a1, ar, dh)
            if attn_read > 1.0:
                raise AssertionError(f"decode_block_attn disagrees at the "
                                     f"{what}: element reading {attn_read}, "
                                     f"max_abs_err {errs['attn']}")
            attn_fault = attn_faults(x, k, v, pos, kw, bk, ar)
            if not torch.allclose(m1.float(), mr.float(),
                                  **tol[torch.bfloat16]):
                raise AssertionError(f"decode_block_mlp disagrees at the "
                                     f"{what}: max_abs_err {errs['mlp']}")
            # the fresh rows are 4096-long f32 dot products summed in
            # another order, so a value near 0 (cancellation) may miss one
            # bf16 ulp of itself: 1e-5 of the largest value plus one ulp
            # (the norm kernels' bound, norm_excess)
            posw = pos.long().clamp(0, s_max - 1)
            for name, got, want, before in (("k", k1, k2, k), ("v", v1, v2,
                                                                v)):
                excess = norm_excess(got, want, 1e-5)
                if excess > 0:
                    err = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"decode_block_attn's {name} slab "
                                         f"disagrees with the plain "
                                         f"version's at the {what}: "
                                         f"max_abs_err {err}, excess "
                                         f"{excess}")
                changed = (got != before).flatten(2).any(-1)
                changed[torch.arange(bsz, device=dev), posw] = False
                if bool(changed.any()):
                    raise AssertionError(f"decode_block_attn changed a {name} "
                                         f"slab row other than min(pos, S-1) "
                                         f"at the {what}")
            del k1, v1, k2, v2
            if model == "gpt3_6_7b":
                args = (x, (k, v, pos))
            else:
                # the unfused path's tables: bf16 [B, 1, head_dim/2]
                cos, sin = (t.to(torch.bfloat16)[:, None, :dh // 2]
                            for t in (kw["rope_cos"], kw["rope_sin"]))
                args = (x, cos, sin, (k, v, pos))
            times = {
                "attn": time_ms(lambda: attn_call(decode_block_attn, x, k, v,
                                                  pos, kw, block_k=bk)),
                "attn_plain": time_ms(lambda: attn_call(
                    decode_block_attn_reference, x, k, v, pos, kw)),
                "mlp": time_ms(lambda: mlp_call(decode_block_mlp, x, ar, kw,
                                                block_f=bf)),
                "mlp_plain": time_ms(lambda: mlp_call(
                    decode_block_mlp_reference, x, ar, kw)),
                "layer": time_ms(lambda: decode_block_layer(
                    x, k, v, pos, **kw, block_k=bk, block_f=bf)),
                "unfused_layer": time_ms(lambda: layer(*args)),
            }
        bounds = block_bounds(x, kw, pos.tolist(), s_max)
        shape = f"{what}, block_k {bk}, block_f {bf}"
        for half in ("attn", "mlp"):
            bound, bound_by = bounds[half]
            rec[half][model] = {
                "ms": times[half], "plain_ms": times[half + "_plain"],
                "bound_ms": bound, "bound_by": bound_by,
                "bound_bytes": bounds[half + "_bytes"],
                "max_abs_err": errs[half], "layer_ms": times["layer"],
                "unfused_layer_ms": times["unfused_layer"], "shape": shape}
            if half == "attn":
                rec[half][model].update(element_reading=attn_read,
                                        planted_fault_readings=attn_fault)
            log(f"[kernels] decode_block_{half} {shape}: kernel "
                f"{times[half]:.4f} ms, plain {times[half + '_plain']:.4f} "
                f"ms, bound {bound:.4f} ms ({bound_by}, "
                f"{bounds[half + '_bytes'] / 1e6:.1f} MB); max abs err "
                f"{errs[half]:.3g}"
                + (f", element reading {attn_read:.3g}, planted faults read "
                   f"{json.dumps(attn_fault)}" if half == "attn" else "")
                + f" (card: {card})")
        log(f"[kernels] one {model} layer at that shape: fused pair "
            f"{times['layer']:.4f} ms, unfused layer forward "
            f"{times['unfused_layer']:.4f} ms, bound "
            f"{bounds['attn'][0] + bounds['mlp'][0]:.4f} ms (card: {card})")
        del layer, kw, k, v, args
        torch.cuda.empty_cache()
    for half in ("attn", "mlp"):
        # the record's headline is the gpt3_6_7b shape, as in earlier runs
        rec[half] = {**rec[half]["gpt3_6_7b"], "llama_7b": rec[half]["llama_7b"],
                     "sweep_max_abs_err": {
                         k_: e for k_, e in worst.items()
                         if k_.startswith(f"decode_block_{half} ")}}
    return rec


# ----------------------------------------------------------------- GEMV
# every serving shape of the GEMV (csrc/gemv.cuh), as the wrappers launch
# it: (name, K, output columns of each weight segment, rows, input
# transform, f32 input, f32 output, residual dtype or None, activation,
# biases).  The tp=1 projections at 8 slots: decode_block_attn's QKV (norm
# with the row statistics, f32 out), decode_block_mlp's out-projection
# (+ the bf16 residual x, f32 out), up (norm of the f32 xm, GeLU or the
# SwiGLU pair) and down (the f32 activation, SwiGLU read as [up | gate],
# + the f32 residual, bf16 out); the tp=2 ring hops at 4 rows.
GEMV_SHAPES = (
    ("gpt_qkv", 4096, (4096, 4096, 4096), 8, 1, False, True, None, 0, True),
    ("gpt_out", 4096, (4096,), 8, 0, False, True, "bf16", 0, True),
    ("gpt_up", 4096, (16384,), 8, 1, True, True, None, 1, True),
    ("gpt_down", 16384, (4096,), 8, 0, True, False, "f32", 0, True),
    ("llama_qkv", 4096, (4096, 4096, 4096), 8, 1, False, True, None, 0,
     False),
    ("llama_out", 4096, (4096,), 8, 0, False, True, "bf16", 0, False),
    ("llama_up_gate", 4096, (11008, 11008), 8, 1, True, True, None, 0,
     False),
    ("llama_down", 11008, (4096,), 8, 2, True, False, "f32", 0, False),
    ("tp2_qkv_hop", 4096, (6144,), 4, 0, False, False, None, 0, True),
    ("tp2_mlp_up_hop", 4096, (8192,), 4, 0, False, False, None, 0, True),
    ("tp2_llama_up_hop", 4096, (11008,), 4, 0, False, False, None, 0,
     False),
    ("tp2_out_proj_hop", 2048, (4096,), 4, 0, False, False, None, 0, False),
    ("tp2_down_hop", 8192, (4096,), 4, 4, False, False, None, 0, False),
    ("tp2_llama_down_hop", 5504, (4096,), 4, 3, False, False, None, 0,
     False),
)


# the GEMV shapes behind each kernel of the kernels line
GEMV_BY_KERNEL = {
    "decode_block_attn": ("gpt_qkv", "llama_qkv"),
    "decode_block_mlp": ("gpt_out", "gpt_up", "gpt_down", "llama_out",
                         "llama_up_gate", "llama_down"),
    "ring_entry_hop": ("tp2_qkv_hop", "tp2_mlp_up_hop", "tp2_llama_up_hop"),
    "ring_exit_hop": ("tp2_out_proj_hop", "tp2_down_hop",
                      "tp2_llama_down_hop"),
}


def gemv_case(g, k, widths, rows, in_mode, x32, res, bias, scale=0.05,
              dev=None):
    """Random bf16 inputs of one GEMV on the card: ``(x, weights, biases,
    kw)`` for ``decode_block.gemv`` / ``gemv_reference``."""
    import torch
    dev = dev or torch.device(DEVICE)
    bf = torch.bfloat16

    def r(*shape, s=scale, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)
    f32 = torch.float32
    x = r(rows, 2 * k if in_mode in (2, 3) else k, s=1.0,
          dtype=f32 if x32 else bf)
    ws = [r(k, w) for w in widths]
    bs = [r(w) if bias else None for w in widths]
    n = sum(widths)
    kw = {}
    if res is not None:
        kw["res"] = r(rows, n, s=1.0, dtype=f32 if res == "f32" else bf)
    if in_mode == 1:
        kw["stats"] = torch.stack([
            torch.randn(rows, generator=g, device=dev),
            torch.rand(rows, generator=g, device=dev) + 0.5], 1).contiguous()
        kw["norm_w"], kw["norm_b"] = r(k) + 1, r(k)
    return x, ws, bs, dict(kw, in_mode=in_mode)


def gemv_bound(k, widths, rows, in_mode, x32, o32, res, bias):
    """Least time (ms) of one GEMV and what bounds it: its weights, input
    rows (both halves for SwiGLU), norm vectors, biases, residual and
    output read or written once; operations: 2 rows K N."""
    import torch
    n = sum(widths)
    xe, oe = 4 if x32 else 2, 4 if o32 else 2
    nbytes = (2 * k * n + rows * k * xe * (2 if in_mode in (2, 3) else 1)
              + (4 * k if in_mode == 1 else 0) + (2 * n if bias else 0)
              + rows * n * oe + (rows * n * (4 if res == "f32" else 2)
                                 if res else 0))
    return _bound(nbytes, 2 * rows * k * n, torch.bfloat16) + (nbytes,)


def phase_gemv(card: str):
    """The bf16 GEMV of csrc/gemv.cuh (``decode_block.gemv``, the kernel
    behind every projection of ``decode_block_attn`` / ``_mlp`` and every
    ring hop): a sweep over input transforms, activations, rows (1 to 17),
    segments and input / residual / output dtypes, then each serving shape
    (GEMV_SHAPES), each bf16 element within one bf16 ulp of the plain
    version's value (+1e-4 near 0; ``_ulp_ok``); two calls bit-identical;
    the plain model of the kernel's summation order within that limit and
    two planted faults of it (a K tile dropped, a tile read one row late)
    outside it; the kernel's SASS on TMA with no local-memory spills; a
    CUDA graph of one fused decode layer replaying to the eager call's
    bits; each shape timed beside its plain version, its bound and one
    library product.  Returns the records."""
    import torch
    from paddle_tpu_torch.kernels import _build, sass
    from paddle_tpu_torch.kernels.decode_block import (
        _stream_plan, _sm_count, decode_block_layer, gemv, gemv_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bf = torch.bfloat16
    ulp_atol = 1e-4

    def check(what, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not _ulp_ok(got, want, bf, ulp_atol):
            raise AssertionError(f"gemv disagrees with its plain version "
                                 f"beyond one bf16 ulp: {what} max_abs_err="
                                 f"{err}")
        return err

    # the sweep: every transform, activation and dtype mix over ragged
    # shapes (K 232, strips of 200 / 136+64 / 128+8+264 columns)
    worst, n_sweep = 0.0, 0
    for rows in (1, 3, 4, 5, 8, 13, 16, 17):
        for in_mode in range(6):
            for widths in ((200,), (136, 64), (128, 8, 264)):
                x32 = in_mode % 2 == 1
                res = (None, "bf16", "f32")[(rows + in_mode) % 3]
                act = (rows + len(widths)) % 3
                o32 = (in_mode + rows) % 2 == 0
                x, ws, bs, kw = gemv_case(g, 232, widths, rows, in_mode,
                                          x32, res, True, scale=0.2)
                bs = [b if i != 1 else None for i, b in enumerate(bs)]
                got = gemv(x, ws, bs, act=act, out_f32=o32, **kw)
                want = gemv_reference(x, ws, bs, act=act, out_f32=o32, **kw)
                worst = max(worst, check(
                    f"rows {rows} in_mode {in_mode} widths {widths} act "
                    f"{act} x f32 {x32} res {res} out f32 {o32}", got, want))
                n_sweep += 1
    log(f"[gemv] sweep: {n_sweep} cases (rows 1-17, in_mode 0-5, act 0-2, "
        f"1-3 segments, ragged strips, bf16 / f32 input, residual and "
        f"output) within one bf16 ulp (+{ulp_atol}); max abs err {worst:.3g}")

    rec = {"sweep_cases": n_sweep, "sweep_max_abs_err": worst, "shapes": {}}
    for (name, k, widths, rows, in_mode, x32, o32, res, act,
         bias) in GEMV_SHAPES:
        x, ws, bs, kw = gemv_case(g, k, widths, rows, in_mode, x32, res, bias)
        got = gemv(x, ws, bs, act=act, out_f32=o32, **kw)
        again = gemv(x, ws, bs, act=act, out_f32=o32, **kw)
        want = gemv_reference(x, ws, bs, act=act, out_f32=o32, **kw)
        err = check(name, got, want)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"gemv at {name}: two calls differ")
        plan = _stream_plan(k, tuple(widths), rows, in_mode, x32,
                            _sm_count(dev))
        # the plain model of the summation order, and two planted faults
        model = gemv_reference(x, ws, bs, act=act, out_f32=o32, plan=plan,
                               **kw)
        check(f"{name} (plain model of the kernel's order)", got, model)
        faults = {}
        for fault in (dict(drop=plan["kT"] // 2),
                      dict(late=plan["kT"] + 1)):
            bad = gemv_reference(x, ws, bs, act=act, out_f32=o32, plan=plan,
                                 **fault, **kw)
            ok = _ulp_ok(got, bad, bf, ulp_atol)
            fe = (got.float() - bad.float()).abs().max().item()
            faults[next(iter(fault))] = fe
            if ok:
                raise AssertionError(f"gemv at {name}: the planted fault "
                                     f"{fault} passes the one-ulp check")
        # timing: 4 weight copies in turn (beyond the 50 MB L2)
        cases = [(x, ws, bs, kw)] + [
            gemv_case(g, k, widths, rows, in_mode, x32, res, bias)
            for _ in range(3)]
        cat = [(c[0][:, :k].to(bf).contiguous(), torch.cat(c[1], 1),
                torch.cat(c[2]) if bias else None) for c in cases]
        state = {"i": 0}

        def pick():
            state["i"] = (state["i"] + 1) % 4
            return state["i"]

        def kern():
            c = cases[pick()]
            return gemv(c[0], c[1], c[2], act=act, out_f32=o32, **c[3])

        def plain():
            c = cases[pick()]
            return gemv_reference(c[0], c[1], c[2], act=act, out_f32=o32,
                                  **c[3])

        def lib():
            xb, w, b = cat[pick()]
            return torch.addmm(b, xb, w) if b is not None else xb @ w
        bound, bound_by, nbytes = gemv_bound(k, widths, rows, in_mode, x32,
                                             o32, res, bias)
        r = {"ms": time_ms(kern), "device_ms": device_ms(kern),
             "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
             "library_device_ms": device_ms(lib), "bound_ms": bound,
             "bound_by": bound_by, "bound_bytes": nbytes,
             "max_abs_err": err, "bit_identical": True,
             "fault_max_abs_err": faults,
             "plan": {key: plan[key] for key in ("grid", "ksplit", "units",
                                                 "stages")},
             "shape": f"x[{rows},{x.shape[1]}] "
                      f"w[{k},{'+'.join(map(str, widths))}] in_mode "
                      f"{in_mode} act {act} bf16 (4 weight copies in turn)"}
        rec["shapes"][name] = r
        log(f"[gemv] {name} {r['shape']}: kernel device {r['device_ms']:.4f}"
            f" ms (events {r['ms']:.4f}), library device "
            f"{r['library_device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
            f" bound {bound:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB); "
            f"{r['plan']}; max abs err {err:.3g}, planted faults "
            f"{json.dumps({f: round(e, 4) for f, e in faults.items()})} "
            f"(card: {card})")
        del cases, cat

    counts = sass.instruction_counts(
        str(_build._library_path("decode_block")), "gemv_stream_kernel",
        ("UTMALDG", "UBLKCP", "HMMA", "STL", "LDL"))
    if not counts:
        raise AssertionError("gemv_stream_kernel not found in the SASS")
    for fname, c in counts.items():
        if c["UTMALDG"] + c["UBLKCP"] == 0 or c["HMMA"] == 0 \
                or c["STL"] or c["LDL"]:
            raise AssertionError(f"{fname}: SASS {c}: want TMA copies "
                                 f"(UTMALDG / UBLKCP), HMMA and no "
                                 f"local-memory spills (STL / LDL)")
    rec["sass"] = counts
    log(f"[gemv] SASS {json.dumps(counts)}")

    # a CUDA graph of one fused decode layer (bf16, Llama wiring: the qkv
    # GEMV with its norm, attention, the MLP's three GEMVs) replays to the
    # eager call's bits
    xl, kl, vl, kwl = block_case(g, b=8, s_max=512, heads=16, kv_heads=4,
                                 dh=128, ffn=5504, dtype=bf, wiring="llama")
    pos = torch.tensor([0, 7, 100, 200, 300, 400, 510, 511],
                       dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ye, ke, ve = decode_block_layer(xl, kl.clone(), vl.clone(), pos, **kwl)
        kg, vg = kl.clone(), vl.clone()
        decode_block_layer(xl, kg.clone(), vg.clone(), pos, **kwl)  # warm
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        yg, _, _ = decode_block_layer(xl, kg, vg, pos, **kwl)
    graph.replay()
    torch.cuda.synchronize()
    same = (torch.equal(yg, ye) and torch.equal(kg, ke)
            and torch.equal(vg, ve))
    if not same:
        raise AssertionError("a CUDA graph of decode_block_layer does not "
                             "replay to the eager call's bits")
    rec["graph_replay_bit_identical"] = True
    log("[gemv] CUDA graph of one fused decode layer (llama wiring, 8 slots, "
        "bf16) replays to the eager call's bits")
    del graph, xl, kl, vl, kwl
    torch.cuda.empty_cache()
    return rec


def phase_tiny_serving(card: str):
    """gpt_tiny and llama_tiny (head_dim 16: the attention kernels take it
    zero-padded to 64) served through ``ServingEngine`` on the card and on
    the CPU from the same weights: the greedy tokens agree and the card's
    run launched the decode-attention kernel; then the flash kernels at
    head_dim 16 and 32 against their plain versions."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)
    from paddle_tpu_torch.serving import ServingEngine
    out = {}
    for family, cls, cfg in (("gpt", GPTForCausalLM, gpt_tiny()),
                             ("llama", LlamaForCausalLM, llama_tiny())):
        cpu = cls(cfg, device="cpu").eval()
        card_m = cls(cfg, device=DEVICE).eval()
        card_m.load_state_dict({k: v.to(DEVICE)
                                for k, v in cpu.state_dict().items()})
        rs = np.random.RandomState(5)
        prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (9, 40, 4)]
        tokens = {}
        decode_attention.launches = 0
        for where, model in (("cpu", cpu), ("cuda", card_m)):
            eng = ServingEngine(model, num_slots=3, min_bucket=8,
                                block_len=16, prefill_chunk=16)
            rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_until_complete(300)
            tokens[where] = [eng.purge(r).tokens for r in rids]
            eng.close()
        if decode_attention.launches == 0:
            raise AssertionError(f"{family}_tiny on the card never launched "
                                 f"decode_attention")
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{family}_tiny (head_dim {cfg.head_dim}): "
                                 f"greedy tokens on the card {tokens['cuda']}"
                                 f" != the CPU's {tokens['cpu']}")
        out[family] = {"head_dim": cfg.head_dim,
                       "decode_attention_launches": decode_attention.launches,
                       "tokens": tokens["cuda"]}
        log(f"[tiny] {family}_tiny, head_dim {cfg.head_dim}: greedy tokens "
            f"on the card equal the CPU's for {len(prompts)} requests "
            f"({decode_attention.launches} decode_attention launches)")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    worst = 0.0
    for d in (16, 32):
        q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE)
                       for shape in ((2, 80, 4, d), (2, 96, 2, d),
                                     (2, 96, 2, d), (2, 80, 4, d)))
        o1, l1 = flash_attention_fwd(q, k, v, causal=True)
        o2, l2 = flash_attention_fwd_reference(q, k, v, causal=True)
        delta = (do * o2).sum(-1).transpose(1, 2).contiguous()
        pairs = [(o1, o2), (l1, l2),
                 (flash_attention_bwd_dq(q, k, v, do, l2, delta, causal=True),
                  flash_attention_bwd_dq_reference(q, k, v, do, l2, delta,
                                                   causal=True))]
        pairs += list(zip(
            flash_attention_bwd_dkv(q, k, v, do, l2, delta, causal=True),
            flash_attention_bwd_dkv_reference(q, k, v, do, l2, delta,
                                              causal=True)))
        for got, want in pairs:
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got, want, atol=1e-4, rtol=0):
                raise AssertionError(f"flash kernels at head_dim {d}: "
                                     f"max_abs_err {err}")
    out["flash_max_abs_err"] = worst
    log(f"[tiny] flash forward / dq / dkv at head_dim 16 and 32 (f32, "
        f"causal, GQA) within atol 1e-4 of the plain versions: max abs err "
        f"{worst:.3g} (card: {card})")
    return out


# ------------------------------------------------- sharded decode block
# tensor-parallel serving on one card: both shards of the tp=2 mesh on the
# same device (the ring hops are copies on that card; no interconnect is
# measured)
TP = 2
TP_DEVICES = ["cuda:0"] * TP
TP_NOTE = ("; two shards on one card: the hops are same-device copies, no "
           "NVLink measured")
# the ring seams of one layer at tp=2 (hop rows B/tp = 4 at num_slots 8):
# (model, seam, kind, K, N, exit activation)
TP_SEAMS = (("gpt3_6_7b", "qkv", "entry", 4096, 6144, None),
            ("gpt3_6_7b", "mlp_up", "entry", 4096, 8192, None),
            ("gpt3_6_7b", "out_proj", "exit", 2048, 4096, "none"),
            ("gpt3_6_7b", "mlp_down", "exit", 8192, 4096, "gelu_tanh"),
            ("llama_7b", "qkv", "entry", 4096, 6144, None),
            ("llama_7b", "mlp_up", "entry", 4096, 11008, None),
            ("llama_7b", "out_proj", "exit", 2048, 4096, "none"),
            ("llama_7b", "mlp_down", "exit", 5504, 4096, "swiglu"))


def _bound(nbytes: int, ops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hop_bound(rows: int, k: int, n: int, es: int, bias: bool, gated: bool,
              dtype):
    """Least time (ms) of one ring hop and what bounds it.  Bytes: the
    weight block, the input rows (both halves for SwiGLU), the bias and
    the output once; operations: the hop's multiply-adds over the dtype's
    peak rate."""
    nbytes = es * (k * n + rows * k * (2 if gated else 1) + rows * n
                   + (n if bias else 0))
    return _bound(nbytes, 2 * rows * k * n, dtype) + (nbytes,)


def attn_tp_bound(b: int, heads: int, kv_heads: int, dh: int, posw, es: int,
                  dtype):
    """Least time (ms) of one shard's attention block: the live K/V rows
    ``kpos < min(pos, S-1)`` of its kv heads read once, q/k/v read and
    the output and fresh K/V rows written once; operations: QK and PV
    multiply-adds over each query head's live rows and the fresh one."""
    live = sum(posw)
    nbytes = es * (2 * live * kv_heads * dh + b * (heads + 2 * kv_heads) * dh
                   + b * heads * dh + 2 * b * kv_heads * dh)
    return _bound(nbytes, 4 * heads * dh * (live + b), dtype) + (nbytes,)


def device_ms(fn, iters: int = 40) -> float:
    """The card's own time for one call of ``fn`` in ms: every kernel and
    copy it launched, summed over ``iters`` calls under torch.profiler.
    Unlike ``time_ms`` it leaves out the gaps while the host enqueues the
    next call, which a small kernel behind a Python wrapper cannot hide."""
    return sum(device_ms_by_kernel(fn, iters).values())


def device_ms_by_kernel(fn, iters: int = 40) -> dict:
    """``device_ms`` of ``fn`` split by kernel name (ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {k: ms / iters for k, ms in kernel_ms(prof).items()}


def _cycled(make, n: int = 4):
    """``n`` inputs from ``make`` and a function returning them in turn:
    a timed loop over them streams from device memory, not from the 50 MB
    L2 cache, as a serving step finds each layer's weights."""
    items = [make() for _ in range(n)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return items[state["i"]]
    return items, nxt


# the per-shard attention's timed shapes at tp=2 (8 slots, 16 of 32 kv
# heads x 128): S_max, the positions (gpt3_6_7b filled to 1024, llama_7b
# near 3000) and rotary
ATTN_TP_SHARDS = {
    "gpt3_6_7b": (2048, [1024] * 8, False),
    "llama_7b": (4096, [2976, 2990, 2999, 3000, 3013, 3047, 3080, 3103],
                 True)}


def attn_tp_shard(g, model: str):
    """One shard's ``decode_block_attn_tp`` inputs at ``ATTN_TP_SHARDS
    [model]`` (bf16 from ``g``): q, k, v as column views of one fused row,
    4 slab pairs and a function returning them in turn (``_cycled``), the
    positions and the keyword arguments."""
    import torch
    from paddle_tpu_torch.models import llama_7b
    from paddle_tpu_torch.models.llama import fused_rope_tables
    s_max, pos, rope = ATTN_TP_SHARDS[model]
    b, kvh, dh = len(pos), 16, 128
    dev = torch.device(DEVICE)

    def r(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    qkv = r((b, 3 * kvh * dh))
    q, k, v = (qkv[:, :kvh * dh], qkv[:, kvh * dh:2 * kvh * dh],
               qkv[:, 2 * kvh * dh:])
    slabs, nxt = _cycled(lambda: (r((b, s_max, kvh, dh)),
                                  r((b, s_max, kvh, dh))))
    cos, sin = fused_rope_tables(pos, llama_7b()) if rope else (None, None)
    return q, k, v, slabs, nxt, pos, dict(kv_heads=kvh, head_dim=dh,
                                          rope_cos=cos, rope_sin=sin)


def ulp_reading(got, want, atol: float = 1e-4) -> float:
    """Largest ratio of a bf16 element's error to ``_ulp_ok``'s limit of
    it (one bf16 ulp of the plain value + ``atol``; <= 1 passes)."""
    g32, w32 = got.float(), want.float()
    return ((g32 - w32).abs() / (_ulps(w32, 7) + atol)).max().item()


# (kv heads, rep, head_dim, S_max, rotary) of the split kernel's own
# checks: the gpt3_6_7b shard (one head a block), a GQA group of 4 and one
# of 8 (4 heads a block, two blocks a kv head: one writes the fresh row)
ATTN_TP_SPLIT_CASES = ((16, 1, 128, 2048, False), (2, 4, 64, 1024, True),
                       (4, 8, 128, 1024, True))


def check_attn_tp_split(card: str) -> dict:
    """The bf16 split kernel of ``decode_block_attn_tp``
    (``attn_tp_split_kernel``) beyond the sweep: positions on split edges,
    every slab row from min(pos, S-1) on holding NaN, two calls
    bit-identical, a CUDA graph replaying to the eager bits with the slab
    row written, the split model within the kernel's limit and two faults
    planted in it (a dropped split, the fresh row not folded) at
    ``FAULT_READING`` times it or more, the shared memory of each launch
    as the plan approves it, and its SASS (TMA loads, no spills)."""
    import ctypes

    import torch
    from paddle_tpu_torch.kernels import _build, sass
    from paddle_tpu_torch.kernels import decode_block_tp as dbt
    from paddle_tpu_torch.kernels.decode_block_tp import (
        decode_block_attn_tp, decode_block_attn_tp_reference)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    bf = torch.bfloat16
    split = dbt._SPLIT_ROWS
    b = ENGINE_KW["num_slots"]
    rec = {"cases": []}

    def r(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    for kvh, rep, dh, s_max, rope in ATTN_TP_SPLIT_CASES:
        # live rows end inside split 0, on its last row, on split 1's
        # first row, on split 1's last and split 2's first; none; S-1; past S
        pos = torch.tensor([split - 1, split, split + 1, 2 * split,
                            2 * split + 1, 0, s_max - 1, s_max + 5],
                           dtype=torch.int32, device=dev)
        posw = pos.long().clamp(0, s_max - 1)
        nq = kvh * rep * dh
        qkv = r((b, nq + 2 * kvh * dh))
        q, k, v = (qkv[:, :nq], qkv[:, nq:nq + kvh * dh],
                   qkv[:, nq + kvh * dh:])
        ks, vs = r((b, s_max, kvh, dh)), r((b, s_max, kvh, dh))
        cos = sin = None
        if rope:
            ang = torch.rand((b, dh // 2), generator=g, device=dev) * 3.0
            cos, sin = torch.cat([ang.cos()] * 2, -1), \
                torch.cat([ang.sin()] * 2, -1)
        kw = dict(kv_heads=kvh, head_dim=dh, rope_cos=cos, rope_sin=sin)
        what = (f"q[{b},{nq}] kv[{b},{s_max},{kvh},{dh}] rep {rep} rope "
                f"{rope} pos {pos.tolist()}")
        k1, v1, k2, v2 = ks.clone(), vs.clone(), ks.clone(), vs.clone()
        out, _, _ = decode_block_attn_tp(q, k, v, k1, v1, pos, **kw)
        ref, _, _ = decode_block_attn_tp_reference(q, k, v, k2, v2, pos,
                                                   **kw)
        again, _, _ = decode_block_attn_tp(q, k, v, ks.clone(), vs.clone(),
                                           pos, **kw)
        model = attn_tp_split(q, k, v, ks, vs, pos, split_rows=split, **kw)
        torch.cuda.synchronize()
        read, model_read = ulp_reading(out, ref), ulp_reading(out, model)
        if read > 1.0 or not (_ulp_ok(k1, k2, bf) and _ulp_ok(v1, v2, bf)):
            raise AssertionError(f"decode_block_attn_tp's split kernel "
                                 f"disagrees with its plain version: {what}: "
                                 f"element reading {read}")
        if model_read > 1.0:
            raise AssertionError(f"the split model disagrees with the kernel: "
                                 f"{what}: element reading {model_read}")
        if not torch.equal(out, again):
            raise AssertionError(f"decode_block_attn_tp: two calls differ: "
                                 f"{what}")
        # NaN in every slab row from min(pos, S-1) on: those rows are
        # masked (row posw is this call's write), so the output keeps its
        # bits
        kn, vn = ks.clone(), vs.clone()
        stale = torch.arange(s_max, device=dev)[None, :] >= posw[:, None]
        kn[stale], vn[stale] = float("nan"), float("nan")
        nan_out, _, _ = decode_block_attn_tp(q, k, v, kn, vn, pos, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(nan_out, out) and bool(nan_out.isfinite().all())):
            raise AssertionError(f"decode_block_attn_tp: NaN in the slab rows "
                                 f"past min(pos, S-1) changed the output: "
                                 f"{what}")
        case = {"shape": what, "element_reading": read,
                "split_model_reading": model_read,
                "max_abs_err": (out.float() - ref.float()).abs().max().item()}
        if rep == 1:
            # planted faults of the model, against the plain version
            for name, fault in (("dropped split", dict(drop=1)),
                                ("fresh row not folded", dict(fold=False))):
                wrong = attn_tp_split(q, k, v, ks, vs, pos, split_rows=split,
                                      **fault, **kw)
                fr = ulp_reading(wrong, ref)
                if fr < FAULT_READING:
                    raise AssertionError(f"the planted fault {name} reads only "
                                         f"{fr} (want >= {FAULT_READING}): "
                                         f"{what}")
                case[f"planted_fault_reading {name}"] = fr
            # a CUDA graph of one call replays to the eager bits
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            kg, vg = ks.clone(), vs.clone()
            with torch.cuda.stream(side):
                decode_block_attn_tp(q, k, v, kg.clone(), vg.clone(), pos,
                                     **kw)  # warm: the side stream's buffers
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                og, _, _ = decode_block_attn_tp(q, k, v, kg, vg, pos, **kw)
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(og, out) and torch.equal(kg, k1)
                    and torch.equal(vg, v1)):
                raise AssertionError(f"a CUDA graph of decode_block_attn_tp "
                                     f"does not replay to the eager call's "
                                     f"bits (output and slab row): {what}")
            case["graph_replay_bit_identical"] = True
            del graph
        rec["cases"].append(case)
        log(f"[kernels] decode_block_attn_tp split kernel {what}: element "
            f"reading {read:.3g} (<= 1: one bf16 ulp + 1e-4), the split "
            f"model {model_read:.3g}; two calls bit-identical; NaN in every "
            f"row past min(pos, S-1) leaves the bits; "
            f"{json.dumps({k_: v_ for k_, v_ in case.items() if 'fault' in k_ or 'graph' in k_})}")
        del qkv, ks, vs, k1, v1, k2, v2, kn, vn

    # the launch's shared memory is what the plan approves
    lib = _build.load("decode_block_tp")
    smem = {}
    for dtype, dh, rep in ((2, 128, 1), (2, 64, 1), (2, 128, 4), (2, 64, 8),
                           (0, 128, 1), (2, 16, 1)):
        es = 2 if dtype == 2 else 4
        bk, want = dbt._attn_tp_plan(2048, rep, dh, es, dbt.SMEM_BUDGET)
        a = dbt._TpAttnArgs()
        a.B, a.H, a.KH, a.Dh, a.S = 8, 16 * rep, 16, dh, 2048
        a.block_k, a.dtype = bk, dtype
        got = lib.decode_block_tp_attention_smem(ctypes.addressof(a))
        smem[f"dtype {dtype} dh {dh} rep {rep}"] = got
        if got != want:
            raise AssertionError(f"decode_block_attn_tp at dtype {dtype} "
                                 f"head_dim {dh} rep {rep} takes {got} bytes "
                                 f"of shared memory; the plan approves {want}")
    rec["smem"] = smem
    counts = sass.instruction_counts(
        str(_build._library_path("decode_block_tp")), "attn_tp_split_kernel",
        DECODE_OPS)
    if len(counts) != 4 or any(c["UTMALDG"] == 0 or c["STL"] != 0
                               or c["LDL"] != 0 for c in counts.values()):
        raise AssertionError(f"attn_tp_split_kernel's instantiations (bf16 x "
                             f"head_dim 64/128 x 1 or 4 heads) must each hold "
                             f"UTMALDG and no STL or LDL: {json.dumps(counts)}")
    rec["sass"] = counts
    log(f"[kernels] decode_block_attn_tp: shared memory of each launch as the "
        f"plan approves it {json.dumps(smem)}; SASS of attn_tp_split_kernel "
        f"{json.dumps(counts)} (card: {card})")
    torch.cuda.empty_cache()
    return rec


def phase_tp_kernels(card: str):
    """Hold the sharded decode block's three kernels (``ring_entry_hop``,
    ``ring_exit_hop``, ``decode_block_attn_tp``) against their plain
    versions on the card at every ring seam and the per-shard attention
    shapes of gpt3_6_7b and llama_7b at tp=2, f32 and bf16, and both ring
    drivers on the one-card mesh; then time each at the gpt3_6_7b shape
    (and the llama_7b ones) beside its plain version, its bound and, for
    the hops, one library call computing the same product.  Returns the
    three kernels' records (without launches)."""
    import torch
    from paddle_tpu_torch.distributed import Mesh
    from paddle_tpu_torch.kernels.decode_block_tp import (
        decode_block_attn_tp, decode_block_attn_tp_reference,
        ring_entry_hop, ring_entry_hop_reference, ring_entry_matmul,
        ring_entry_matmul_reference, ring_exit_hop, ring_exit_hop_reference,
        ring_exit_matmul, ring_exit_matmul_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    # a single kernel and its plain version sum the same f32 terms in
    # another order and cast once: in bf16 they agree to one output ulp
    # (plus 1e-4 for values near 0).  Only the exit ring driver, whose
    # bf16 accumulator adds partials that may cancel, keeps atol/rtol 2e-2
    ulp_atol = 1e-4
    rows = ENGINE_KW["num_slots"] // TP

    def r(shape, dtype, scale=0.05):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def check(name, got, want, dtype, what, worst, ulp=True):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        key = f"{name} {str(dtype).replace('torch.', '')}"
        worst[key] = max(worst.get(key, 0.0), err)
        ok = _ulp_ok(got, want, dtype, ulp_atol) if ulp else \
            torch.allclose(got.float(), want.float(), **tol[dtype])
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{what} max_abs_err={err}")

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for model, seam, kind, k, n, act in TP_SEAMS:
            what = (f"{model} {seam} hop x[{rows},{k}] w[{k},{n}] act={act} "
                    f"{dtype}")
            w = r((k, n), dtype)
            if kind == "entry":
                x, b = r((rows, k), dtype, 1.0), r((n,), dtype)
                check("ring_entry_hop", ring_entry_hop(x, w, b),
                      ring_entry_hop_reference(x, w, b), dtype, what, worst)
            else:
                y = r((rows, k * (2 if act == "swiglu" else 1)), dtype, 1.0)
                check("ring_exit_hop", ring_exit_hop(y, w, act),
                      ring_exit_hop_reference(y, w, act), dtype, what, worst)
        # the ring drivers on the one-card mesh: hops + ppermute copies
        mesh = Mesh(TP_DEVICES)
        hs = [r((rows, 4096), dtype, 1.0) for _ in range(TP)]
        ws = [r((4096, 6144), dtype) for _ in range(TP)]
        bs = [r((6144,), dtype) for _ in range(TP)]
        for got, want in zip(ring_entry_matmul(hs, ws, bs, mesh),
                             ring_entry_matmul_reference(hs, ws, bs, mesh)):
            check("ring_entry_hop", got, want, dtype,
                  f"ring_entry_matmul over {TP_DEVICES}", worst)
        ys = [r((TP * rows, 2048), dtype, 1.0) for _ in range(TP)]
        wo = [r((2048, 4096), dtype) for _ in range(TP)]
        for got, want in zip(ring_exit_matmul(ys, wo, mesh),
                             ring_exit_matmul_reference(ys, wo, mesh)):
            check("ring_exit_hop", got, want, dtype,
                  f"ring_exit_matmul over {TP_DEVICES}", worst, ulp=False)
        del hs, ws, bs, ys, wo
    # per-shard attention: gpt3_6_7b / llama_7b at tp=2 (16 of 32 kv heads
    # per shard, head_dim 128) and the GQA parity Llama's shard (2 kv heads
    # x rep 3, head_dim 64); ragged positions with 0 and S; q/k/v as
    # column views of one fused row, as the entry ring delivers them
    att = (("gpt3_6_7b", 16, 1, 128, 2048, False),
           ("llama_7b", 16, 1, 128, 4096, True),
           ("llama_parity", 2, 3, 64, 1024, True))
    n_att = 0
    for dtype in (torch.float32, torch.bfloat16):
        for model, kvh, rep, dh, s_max, rope in att:
            b = ENGINE_KW["num_slots"]
            pos = torch.tensor([0, 1, 63, 64, s_max // 2, s_max - 2,
                                s_max - 1, s_max], dtype=torch.int32,
                               device=dev)
            nq = kvh * rep * dh
            qkv = r((b, nq + 2 * kvh * dh), dtype, 1.0)
            q, k, v = (qkv[:, :nq], qkv[:, nq:nq + kvh * dh],
                       qkv[:, nq + kvh * dh:])
            ks, vs = r((b, s_max, kvh, dh), dtype, 1.0), \
                r((b, s_max, kvh, dh), dtype, 1.0)
            cos = sin = None
            if rope:
                ang = torch.rand((b, dh // 2), generator=g, device=dev) * 3.0
                cos = torch.cat([ang.cos()] * 2, -1)
                sin = torch.cat([ang.sin()] * 2, -1)
            k1, v1, k2, v2 = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            kw = dict(kv_heads=kvh, head_dim=dh, rope_cos=cos, rope_sin=sin)
            a1, _, _ = decode_block_attn_tp(q, k, v, k1, v1, pos, **kw)
            a2, _, _ = decode_block_attn_tp_reference(q, k, v, k2, v2, pos,
                                                      **kw)
            what = (f"{model} shard: q[{b},{nq}] kv[{b},{s_max},{kvh},{dh}] "
                    f"pos {pos.tolist()} {dtype}")
            check("decode_block_attn_tp", a1, a2, dtype, what, worst)
            posw = pos.long().clamp(0, s_max - 1)
            for name, got, want, before in (("k", k1, k2, ks),
                                            ("v", v1, v2, vs)):
                if not _ulp_ok(got, want, dtype):
                    err = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"decode_block_attn_tp's {name} "
                                         f"slab disagrees with the plain "
                                         f"version's: {what} max_abs_err "
                                         f"{err}")
                changed = (got != before).flatten(2).any(-1)
                changed[torch.arange(b, device=dev), posw] = False
                if bool(changed.any()):
                    raise AssertionError(f"decode_block_attn_tp changed a "
                                         f"{name} slab row other than "
                                         f"min(pos, S-1): {what}")
            n_att += 1
            del qkv, ks, vs, k1, v1, k2, v2
    log(f"[kernels] decode_block_tp sweep: {2 * len(TP_SEAMS)} hops, 4 ring "
        f"drivers on {TP_DEVICES}, {n_att} attention cases within tolerance "
        f"(f32 atol 1e-4; bf16 one output ulp + {ulp_atol}, the exit ring "
        f"driver atol/rtol 2e-2; slabs one bf16 ulp, only row "
        f"min(pos, S-1) changed); max abs err {json.dumps(worst)}")
    split_checks = check_attn_tp_split(card)

    # timings, bf16: the gpt3_6_7b QKV entry hop and out-proj exit hop, the
    # per-shard attention at 8 slots filled to 1024; the llama_7b gated
    # up / SwiGLU down hops and its attention near position 3000
    bf = torch.bfloat16
    rec = {}

    def hop_record(name, model, k, n, act):
        gated = act == "swiglu"
        if name == "ring_entry_hop":
            items, nxt = _cycled(lambda: (r((rows, k), bf, 1.0),
                                          r((k, n), bf), r((n,), bf)))

            def kern():
                return ring_entry_hop(*nxt())

            def plain():
                return ring_entry_hop_reference(*nxt())

            def lib():
                x, w, b = nxt()
                return torch.addmm(b, x, w)
        else:
            items, nxt = _cycled(lambda: (
                r((rows, k * (2 if gated else 1)), bf, 1.0), r((k, n), bf)))

            def kern():
                return ring_exit_hop(*nxt(), act)

            def plain():
                return ring_exit_hop_reference(*nxt(), act)

            def lib():
                return torch.matmul(*nxt())
            # the library yardstick is one product without an activation
            lib = lib if act == "none" else None
        extra = () if name == "ring_entry_hop" else (act,)
        kernel_fn = ring_entry_hop if name == "ring_entry_hop" \
            else ring_exit_hop
        plain_fn = ring_entry_hop_reference if name == "ring_entry_hop" \
            else ring_exit_hop_reference
        err = (kernel_fn(*items[0], *extra).float()
               - plain_fn(*items[0], *extra).float()).abs().max().item()
        bound, bound_by, nbytes = hop_bound(
            rows, k, n, 2, name == "ring_entry_hop", gated, bf)
        out = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lib) if lib is not None else None,
               "device_ms": device_ms(kern),
               "library_device_ms": device_ms(lib) if lib is not None
               else None,
               "bound_ms": bound, "bound_by": bound_by, "bound_bytes": nbytes,
               "max_abs_err": err,
               "shape": f"{model} tp={TP}: x[{rows},{k * (2 if gated else 1)}]"
                        f" w[{k},{n}] act={act} bf16 (4 weight copies in "
                        f"turn)"}
        lib_ms, lib_dev = out["library_ms"], out["library_device_ms"]
        log(f"[kernels] {name} {out['shape']}: kernel {out['ms']:.4f} ms "
            f"(device {out['device_ms']:.4f}), plain {out['plain_ms']:.4f} "
            f"ms, library "
            f"{'none' if lib_ms is None else '%.4f ms' % lib_ms}"
            f"{'' if lib_dev is None else ' (device %.4f)' % lib_dev}"
            f", bound {bound:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB); "
            f"max abs err {err:.3g} (card: {card})")
        del items
        return out

    rec["ring_entry_hop"] = hop_record("ring_entry_hop", "gpt3_6_7b", 4096,
                                       6144, None)
    rec["ring_entry_hop"]["gpt3_6_7b_mlp_up"] = hop_record(
        "ring_entry_hop", "gpt3_6_7b", 4096, 8192, None)
    rec["ring_entry_hop"]["llama_7b"] = hop_record(
        "ring_entry_hop", "llama_7b", 4096, 11008, None)
    rec["ring_exit_hop"] = hop_record("ring_exit_hop", "gpt3_6_7b", 2048,
                                      4096, "none")
    rec["ring_exit_hop"]["gpt3_6_7b_mlp_down"] = hop_record(
        "ring_exit_hop", "gpt3_6_7b", 8192, 4096, "gelu_tanh")
    rec["ring_exit_hop"]["llama_7b"] = hop_record(
        "ring_exit_hop", "llama_7b", 5504, 4096, "swiglu")

    def attn_record(model):
        s_max, pos, _ = ATTN_TP_SHARDS[model]
        q, k, v, slabs, nxt, pos, kw = attn_tp_shard(g, model)
        ks, vs = slabs[0]
        b, kvh, dh = len(pos), 16, 128
        a1, _, _ = decode_block_attn_tp(q, k, v, ks.clone(), vs.clone(), pos,
                                        **kw)
        a2, _, _ = decode_block_attn_tp_reference(q, k, v, ks.clone(),
                                                  vs.clone(), pos, **kw)
        err = (a1.float() - a2.float()).abs().max().item()
        posw = [min(max(int(p), 0), s_max - 1) for p in pos.tolist()]
        bound, bound_by, nbytes = attn_tp_bound(b, kvh, kvh, dh, posw, 2, bf)

        def kern():
            return decode_block_attn_tp(q, k, v, *nxt(), pos, **kw)
        out = {"ms": time_ms(kern), "device_ms": device_ms(kern),
               "plain_ms": time_ms(lambda: decode_block_attn_tp_reference(
                   q, k, v, ks, vs, pos, **kw)),
               "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
               "bound_bytes": nbytes, "max_abs_err": err,
               "shape": f"{model} tp={TP} shard: q[{b},{kvh * dh}] "
                        f"kv[{b},{s_max},{kvh},{dh}] pos {pos.tolist()} bf16 "
                        f"(4 slab copies in turn)"}
        log(f"[kernels] decode_block_attn_tp {out['shape']}: kernel "
            f"{out['ms']:.4f} ms (device {out['device_ms']:.4f}), plain "
            f"{out['plain_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB); no single "
            f"library call appends and rotates; max abs err {err:.3g} (card: "
            f"{card})")
        return out

    rec["decode_block_attn_tp"] = attn_record("gpt3_6_7b")
    rec["decode_block_attn_tp"]["llama_7b"] = attn_record("llama_7b")
    rec["decode_block_attn_tp"]["split_checks"] = split_checks
    for name in rec:
        rec[name]["sweep_max_abs_err"] = {
            k_: e for k_, e in worst.items() if k_.startswith(name + " ")}
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------- fused norms
NORM_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "layer_norm_fwd",
                "layer_norm_bwd")
NORM_EPS = 1e-5
# the norm kernels' timed rows of x [rows, 4096] bf16
NORM_SHAPES = {"decode": 8, "prefill": 512, "train": 4096}
# norm_times' rows and dtypes: the three bf16 shapes, and the train rows
# in f32
NORM_TIMED = {**{k: (rows, "bfloat16") for k, rows in NORM_SHAPES.items()},
              "train_f32": (4096, "float32")}
_MANTISSA = {"bfloat16": 7, "float16": 10}


def norm_excess(got, want, rel: float) -> float:
    """How far ``got`` lies outside its tolerance of ``want`` (<= 0:
    inside): ``rel · max(1, max |want|)``, plus one ulp of each value
    when ``got`` is a 16-bit type (the kernel and the plain version
    round the same f32 arithmetic once; their sums differ in order)."""
    import torch
    g32, w32 = got.float(), want.float()
    tol = rel * max(1.0, w32.abs().max().item())
    excess = (g32 - w32).abs() - tol
    bits = _MANTISSA.get(str(got.dtype).replace("torch.", ""))
    if bits is not None:
        excess = excess - torch.exp2(torch.floor(torch.log2(
            w32.abs().clamp_min(1e-30))) - bits)
    return excess.max().item()


def norm_bound(name: str, rows: int, h: int, es: int, wes: int):
    """Least time (ms) of one norm kernel call at these shapes, and what
    bounds it.  Bytes: x (and g) read once, y (or dx) written once, w
    (and b) read once, the f32 statistics written (forward) or read
    (backward) once, dw (and db) written once.  Operations: the f32
    arithmetic per element (forward RMS 4, LN 7; backward RMS 10, LN 14)
    over the card's 67 TFLOP/s f32 rate."""
    ln = name.startswith("layer")
    n_vec = 2 if ln else 1
    if name.endswith("fwd"):
        nbytes = 2 * rows * h * es + n_vec * h * wes + n_vec * rows * 4
        ops = (7 if ln else 4) * rows * h
    else:
        nbytes = 3 * rows * h * es + h * wes + n_vec * rows * 4 \
            + n_vec * h * wes
        ops = (14 if ln else 10) * rows * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def norm_calls(x, w, b, gy):
    """Each norm kernel's wrapper and its plain version on the same
    inputs, as ``{kernel: [(output, got, want, rel)]}``; the backward
    calls take the plain forward's statistics."""
    import torch
    from paddle_tpu_torch.kernels import fused_norm as fn
    ry, rrstd = fn.rms_norm_fwd_reference(x, w, NORM_EPS)
    y, rstd = fn.rms_norm_fwd(x, w, NORM_EPS)
    rdx, rdw = fn.rms_norm_bwd_reference(x, w, rrstd, gy)
    dx, dw = fn.rms_norm_bwd(x, w, rrstd, gy)
    rly, rmean, rlrstd = fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)
    ly, mean, lrstd = fn.layer_norm_fwd(x, w, b, NORM_EPS)
    rldx, rldw, rldb = fn.layer_norm_bwd_reference(x, w, rmean, rlrstd, gy)
    ldx, ldw, ldb = fn.layer_norm_bwd(x, w, rmean, rlrstd, gy)
    torch.cuda.synchronize()
    return {"rms_norm_fwd": [("y", y, ry, 1e-5), ("rstd", rstd, rrstd, 1e-5)],
            "rms_norm_bwd": [("dx", dx, rdx, 1e-5), ("dw", dw, rdw, 1e-4)],
            "layer_norm_fwd": [("y", ly, rly, 1e-5), ("mean", mean, rmean,
                                                     1e-5),
                               ("rstd", lrstd, rlrstd, 1e-5)],
            "layer_norm_bwd": [("dx", ldx, rldx, 1e-5), ("dw", ldw, rldw,
                                                        1e-4),
                               ("db", ldb, rldb, 1e-4)]}


# the sweep's rows too long for a backward row held in registers (and
# the lengths on either side of that limit): h 4097 (scalar), 4100 (f32),
# 8192 / 8200 (16-bit), and LayerNorm's 32768 and RMSNorm's 65536, which
# the backward refused before it summed dw / db outside shared memory
NORM_LONG_H = (4097, 4100, 8192, 8200, 32768, 65536)
# the new backward kernels' instantiations: the row kernel and the long-
# row kernel (5 dtype pairs x vector or scalar x RMS or LN each) and the
# column sum (3 weight dtypes)
NORM_BWD_KERNELS = 43


def phase_norm_kernels(card: str):
    """Hold the four fused-norm kernels against their plain versions over
    the sweep (rows 1, 3, 8, 512, 4096 x h 64, 768, 4096, 1000 and 777,
    and rows 1, 7, 300 x the ``NORM_LONG_H`` lengths, x f32 / bf16 / f16,
    bf16 also with f32 weights), check that two backward runs and a CUDA
    graph's replay agree bit for bit (no atomics), that no instantiation
    of the LayerNorm forward's or the backward's register kernels spills,
    then time each kernel at the decode [8, 4096], prefill-chunk
    [512, 4096] and train [4096, 4096] bf16 shapes beside its plain
    version, its bound and PyTorch's own norm (forward, and its autograd
    backward).  Returns the four kernels' records (without launches)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import _build, sass
    from paddle_tpu_torch.kernels import fused_norm as fn
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def inputs(rows, h, dtype, wdtype):
        def r(*shape):
            return torch.randn(shape, generator=g, device=dev)
        return ((r(rows, h) * 2 + 0.5).to(dtype), (r(h) * 0.5 + 1).to(wdtype),
                (r(h) * 0.3).to(wdtype), r(rows, h).to(dtype))

    worst = {}
    n = 0
    cases = [(rows, h) for rows in (1, 3, 8, 512, 4096)
             for h in (64, 768, 4096, 1000, 777)]
    cases += [(rows, h) for rows in (1, 7, 300) for h in NORM_LONG_H]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        wdtypes = (dtype, torch.float32) if dtype == torch.bfloat16 \
            else (dtype,)
        for wdtype in wdtypes:
            for rows, h in cases:
                calls = norm_calls(*inputs(rows, h, dtype, wdtype))
                what = f"x {dtype} w {wdtype} rows={rows} h={h}"
                for kernel, outs in calls.items():
                    for out, got, want, rel in outs:
                        excess = norm_excess(got, want, rel)
                        if excess > 0:
                            err = (got.float() - want.float()).abs() \
                                .max().item()
                            raise AssertionError(
                                f"{kernel} {out} disagrees with its "
                                f"plain version: {what} max_abs_err "
                                f"{err} (beyond tolerance by {excess})")
                        key = (f"{kernel} {out} "
                               f"{str(dtype).replace('torch.', '')}")
                        err = (got.float() - want.float()).abs().max() \
                            .item()
                        worst[key] = max(worst.get(key, 0.0), err)
                n += 1
    log(f"[norm-kernels] sweep: {n} cases (rows 1/3/8/512/4096 x h "
        f"64/768/4096/1000/777 and rows 1/7/300 x h {NORM_LONG_H}, x f32, "
        f"bf16, bf16 with f32 weights, f16) within tolerance (over "
        f"max(1, max |plain|): f32 1e-5, 16-bit 1e-5 plus one output ulp, "
        f"dw/db 1e-4); max abs err "
        f"{json.dumps(worst)}")

    x, w, b, gy = inputs(4096, 4096, torch.bfloat16, torch.bfloat16)
    _, rstd = fn.rms_norm_fwd_reference(x, w, NORM_EPS)
    _, mean, lrstd = fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)
    first = (fn.rms_norm_bwd(x, w, rstd, gy),
             fn.layer_norm_bwd(x, w, mean, lrstd, gy))
    second = (fn.rms_norm_bwd(x, w, rstd, gy),
              fn.layer_norm_bwd(x, w, mean, lrstd, gy))
    for a, c in zip(first, second):
        if not all(torch.equal(p, q) for p, q in zip(a, c)):
            raise AssertionError("two runs of a norm backward kernel on the "
                                 "same inputs differ: the sums are not "
                                 "deterministic")
    for rows in (8, 4096):
        xs = x[:rows]
        if not all(torch.equal(p, q) for p, q in zip(
                fn.layer_norm_fwd(xs, w, b, NORM_EPS),
                fn.layer_norm_fwd(xs, w, b, NORM_EPS))):
            raise AssertionError(f"two runs of layer_norm_fwd at [{rows}, "
                                 f"4096] bf16 differ")
    # a CUDA graph of both backwards replays to the eager calls' bits
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn.rms_norm_bwd(x, w, rstd, gy)  # warm
        fn.layer_norm_bwd(x, w, mean, lrstd, gy)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = (fn.rms_norm_bwd(x, w, rstd, gy),
                    fn.layer_norm_bwd(x, w, mean, lrstd, gy))
    graph.replay()
    torch.cuda.synchronize()
    for a, c in zip(first, captured):
        if not all(torch.equal(p, q) for p, q in zip(a, c)):
            raise AssertionError("a CUDA graph of the norm backwards does "
                                 "not replay to the eager calls' bits")
    del graph, captured
    log("[norm-kernels] two backward runs at [4096, 4096] bf16 and a CUDA "
        "graph's replay of both agree bit for bit (dx, dw, db), and two "
        "layer_norm_fwd runs at [8, 4096] and [4096, 4096] (y, mean, rstd)")
    # the LayerNorm forward and the backward hold their rows in registers:
    # no spills
    lib = str(_build._library_path("fused_norm"))
    ln_sass = sass.instruction_counts(lib, "ln_fwd_rows_kernel",
                                      ("STL", "LDL"))
    if len(ln_sass) != 30 or any(c["STL"] or c["LDL"]
                                 for c in ln_sass.values()):
        raise AssertionError(f"ln_fwd_rows_kernel's 30 instantiations (5 "
                             f"dtype pairs x vector or scalar x 4 or 8 "
                             f"groups a thread in one wave, and the vector "
                             f"ones' walk) must hold no STL / LDL: "
                             f"{json.dumps(ln_sass)}")
    bwd_sass = sass.instruction_counts(lib, "norm_bwd_", ("STL", "LDL"))
    if len(bwd_sass) != NORM_BWD_KERNELS or any(
            c["STL"] or c["LDL"] for c in bwd_sass.values()):
        raise AssertionError(f"the backward's {NORM_BWD_KERNELS} "
                             f"instantiations (norm_bwd_rows_kernel, "
                             f"norm_bwd_long_kernel, norm_bwd_sum_kernel) "
                             f"must hold no STL / LDL: "
                             f"{json.dumps(bwd_sass)}")
    log(f"[norm-kernels] no STL / LDL in the {len(ln_sass)} "
        f"ln_fwd_rows_kernel and {len(bwd_sass)} backward instantiations")

    lib_rms = getattr(F, "rms_norm", None)
    recs = {k: {"shapes": {}} for k in NORM_KERNELS}
    h = 4096
    for shape, rows in NORM_SHAPES.items():
        x, w, b, gy = inputs(rows, h, torch.bfloat16, torch.bfloat16)
        errs = {k: max((got.float() - want.float()).abs().max().item()
                       for _, got, want, _ in outs)
                for k, outs in norm_calls(x, w, b, gy).items()}
        _, rstd = fn.rms_norm_fwd_reference(x, w, NORM_EPS)
        _, mean, lrstd = fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)
        xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
        lib_ln_y = F.layer_norm(xr, (h,), wr, br, NORM_EPS)
        lib_rms_y = None if lib_rms is None else lib_rms(xr, (h,), wr,
                                                         NORM_EPS)
        calls = {
            "rms_norm_fwd": (
                lambda: fn.rms_norm_fwd(x, w, NORM_EPS),
                lambda: fn.rms_norm_fwd_reference(x, w, NORM_EPS),
                None if lib_rms is None else
                (lambda: lib_rms(x, (h,), w, NORM_EPS))),
            "rms_norm_bwd": (
                lambda: fn.rms_norm_bwd(x, w, rstd, gy),
                lambda: fn.rms_norm_bwd_reference(x, w, rstd, gy),
                None if lib_rms is None else
                (lambda: torch.autograd.grad(lib_rms_y, (xr, wr), gy,
                                             retain_graph=True))),
            "layer_norm_fwd": (
                lambda: fn.layer_norm_fwd(x, w, b, NORM_EPS),
                lambda: fn.layer_norm_fwd_reference(x, w, b, NORM_EPS),
                lambda: F.layer_norm(x, (h,), w, b, NORM_EPS)),
            "layer_norm_bwd": (
                lambda: fn.layer_norm_bwd(x, w, mean, lrstd, gy),
                lambda: fn.layer_norm_bwd_reference(x, w, mean, lrstd, gy),
                lambda: torch.autograd.grad(lib_ln_y, (xr, wr, br), gy,
                                            retain_graph=True)),
        }
        for name, (kern, plain, lib) in calls.items():
            bound, bound_by = norm_bound(name, rows, h, 2, 2)
            r = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                 "library_ms": None if lib is None else time_ms(lib),
                 "bound_ms": bound, "bound_by": bound_by,
                 "max_abs_err": errs[name],
                 "shape": f"x [{rows},{h}] bf16, w/b [{h}] bf16"}
            recs[name]["shapes"][shape] = r
            log(f"[norm-kernels] {name} {r['shape']} ({shape}): kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{'none' if r['library_ms'] is None else round(r['library_ms'], 4)} "
                f"ms, bound {bound:.4f} ms ({bound_by}); max abs err "
                f"{errs[name]:.3g} (card: {card})")
        del lib_ln_y, lib_rms_y, xr, wr, br
    for name, rec in recs.items():
        rec.update(rec["shapes"]["train"])
        rec["sweep_max_abs_err"] = {k: e for k, e in worst.items()
                                    if k.startswith(name + " ")}
    recs["layer_norm_fwd"]["sass_spills"] = {
        k: c["STL"] + c["LDL"] for k, c in ln_sass.items()}
    for name in ("rms_norm_bwd", "layer_norm_bwd"):
        recs[name]["sass_spills"] = {k: c["STL"] + c["LDL"]
                                     for k, c in bwd_sass.items()}
    # events, device and host time on 4 copies of x (and g) in turn,
    # beside the library's
    for name, times in norm_times().items():
        recs[name]["cycled"] = times
        for shape, t in times.items():
            lib = {k: t[f"library_{k}"] for k in ("ms", "device_ms",
                                                  "host_us")}
            log(f"[norm-kernels] {name} x [{t['rows']},4096] {t['dtype']}, "
                f"4 copies in turn: kernel {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f}, host {t['host_us']:.2f} us a call), "
                f"library {json.dumps(lib)}, bound {t['bound_ms']:.4f} ms; "
                f"device ms by kernel {json.dumps(t['device_by_kernel'])} "
                f"(card: {card})")
    torch.cuda.empty_cache()
    return recs


# -------------------------------------------------------------- serving
# the requests each served model gets, in two waves: (prompt length,
# shares the 512-token prefix, seed or None for greedy)
SERVE_WAVES = {
    "gpt": ([(1536, True, None), (128, False, None), (700, False, 11),
             (300, False, None)],
            [(1024, True, None), (900, True, 23), (640, True, None),
             (1200, False, None)]),
    # Llama-2-7B's 4096 context: one prompt runs past GPT's 2048
    "llama": ([(3072, True, None), (128, False, None), (700, False, 11),
               (300, False, None)],
              [(2600, True, None), (900, True, 23), (640, True, None),
               (1200, False, None)]),
}


def phase_serving(card: str, family: str):
    """Build the family's published model at full width and depth once
    (``gpt3_6_7b`` or ``llama_7b``), then serve the same 8 requests
    through ``ServingEngine`` twice on that model: the unfused decode
    step, then (after that engine is closed) ``fused_decode=True``.
    Returns each run's launch counts and metrics."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_6_7b, llama_7b)
    from paddle_tpu_torch.serving import ServingEngine

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    t0 = time.perf_counter()
    if family == "gpt":
        cfg = gpt3_6_7b()
        model = GPTForCausalLM(cfg, device=DEVICE, generator=gen).eval()
        widths = (f"hidden {cfg.hidden_size}, {cfg.num_heads} heads x "
                  f"{cfg.head_dim}, ffn {cfg.ffn_size}")
    else:
        cfg = llama_7b()
        model = LlamaForCausalLM(cfg, device=DEVICE, generator=gen).eval()
        widths = (f"hidden {cfg.hidden_size}, {cfg.num_heads} heads x "
                  f"{cfg.head_dim} ({cfg.kv_heads} kv heads), ffn "
                  f"{cfg.intermediate_size}")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    name = "gpt3_6_7b" if family == "gpt" else "llama_7b"
    log(f"[serving:{family}] {name}: {cfg.num_layers} layers, {widths}, "
        f"vocab {cfg.vocab_size}, max_seq {cfg.max_seq_len}, bf16, "
        f"{n_params / 1e9:.3f}B params, built on the card in "
        f"{time.perf_counter() - t0:.1f} s (full depth, no cut)")
    # a short round through each path first, so that neither measured
    # run pays the card's first-call costs (library handles, allocator
    # growth, the first call of each GEMM shape)
    rs = np.random.RandomState(3)
    warm = [rs.randint(0, cfg.vocab_size, (n,))
            for n in (600, 64, 300, 130, 700, 64, 1000, 200)]
    for fused in (False, True):
        eng = ServingEngine(model, fused_decode=fused, **ENGINE_KW)
        eng.serve_batch(warm, max_new_tokens=4)
        eng.close()
    runs = {path: serve_run(model, card, fused=path == "fused",
                            waves=SERVE_WAVES[family])
            for path in ("unfused", "fused")}
    if family == "gpt":
        runs["unfused"][1]["record_events"] = serving_record_events(
            model, card, warm)
    u, f = runs["unfused"][1], runs["fused"][1]
    log(f"[serving:{family}] fused vs unfused on the same model and "
        f"requests: decode step p50 {f['decode_step_ms_p50']} vs "
        f"{u['decode_step_ms_p50']} ms, {f['tokens_per_s']:.1f} vs "
        f"{u['tokens_per_s']:.1f} tokens/s, TTFT p50 {f['ttft_p50_ms']} vs "
        f"{u['ttft_p50_ms']} ms (card: {card})")
    del model
    torch.cuda.empty_cache()
    return runs


def serving_record_events(model, card: str, prompts) -> dict:
    """The unfused engine's requests served twice on fresh engines, the
    second with ``record_events=True`` under the port's ``Profiler``
    (host events only: ``targets=[ProfilerTarget.CPU]``, so no device
    tracer runs through the graph captures): both capture their graphs
    exactly as often, the export holds one ``serving.step`` event a step
    and each request's lane, and ``close()`` detaches the engine's
    source."""
    import shutil
    import tempfile

    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           export_chrome_tracing,
                                           load_profiler_result)
    from paddle_tpu_torch.profiler import profiler as prof_mod
    from paddle_tpu_torch.serving import ServingEngine
    tag = "[serving:gpt:record_events]"
    eng = ServingEngine(model, **ENGINE_KW)
    eng.serve_batch(prompts, max_new_tokens=8)
    want = dict(eng.core.capture_counts)
    eng.close()
    root = tempfile.mkdtemp(prefix="record_events_")
    try:
        eng = ServingEngine(model, record_events=True, **ENGINE_KW)
        source = eng.core.metrics.tracer.chrome_events
        p = Profiler(targets=[ProfilerTarget.CPU],
                     trace_dir=os.path.join(root, "device"),
                     on_trace_ready=export_chrome_tracing(
                         os.path.join(root, "export")))
        with p:
            eng.serve_batch(prompts, max_new_tokens=8)
        got = dict(eng.core.capture_counts)
        steps = eng.core._step_index
        events = load_profiler_result(p.last_export)["traceEvents"]
        eng.close()
        attached = source in prof_mod._trace_sources
    finally:
        shutil.rmtree(root, ignore_errors=True)
    step_events = sum(1 for e in events if e.get("cat") == "host"
                      and e["name"] == "serving.step")
    lanes = len({e["tid"] for e in events if e.get("cat") == "request"})
    ranges = sum(1 for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "serving.step")
    rec = {"capture_counts": got, "capture_counts_without": want,
           "steps": steps, "serving_step_events": step_events,
           "record_function_ranges": ranges, "request_lanes": lanes,
           "attached_after_close": attached}
    log(f"{tag} {len(prompts)} requests of 8 tokens: capture_counts "
        f"{json.dumps(got)} (record_events=False {json.dumps(want)}), "
        f"{step_events} serving.step host events and {ranges} record_function "
        f"ranges for {steps} steps, {lanes} request lanes in the export; "
        f"source attached after close(): {attached} (card: {card})")
    if got != want or step_events != steps or ranges != steps \
            or lanes != len(prompts) or attached:
        raise AssertionError(f"{tag} {json.dumps(rec)}")
    return rec


def phase_serving_tp(card: str, tp1: dict):
    """Tensor-parallel serving at tp=2 with both shards on the card
    (``devices=TP_DEVICES``): the full-depth gpt3_6_7b served through
    ``ServingEngine(tensor_parallel=2)`` on the sharded decode-block
    kernels (``fused_decode=True`` -> ``tp_fused_block``) and then the
    composed ring (``tp_fused``), on one model; then llama_7b on
    ``tp_fused_block``.  The same requests as the tp=1 phases, whose
    results ``tp1`` (per family) are printed beside these."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_6_7b, llama_7b)
    from paddle_tpu_torch.serving import ServingEngine

    out = {}
    for family, paths in (("gpt", (True, False)), ("llama", (True,))):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(1234)
        if family == "gpt":
            cfg = gpt3_6_7b()
            model = GPTForCausalLM(cfg, device=DEVICE, generator=gen).eval()
        else:
            cfg = llama_7b()
            model = LlamaForCausalLM(cfg, device=DEVICE,
                                     generator=gen).eval()
        # a short round through each path first (first-call costs)
        rs = np.random.RandomState(3)
        warm = [rs.randint(0, cfg.vocab_size, (n,))
                for n in (600, 64, 300, 130, 700, 64, 1000, 200)]
        for fused in paths:
            eng = ServingEngine(model, fused_decode=fused, tensor_parallel=TP,
                                devices=TP_DEVICES, **ENGINE_KW)
            eng.serve_batch(warm, max_new_tokens=4)
            eng.close()
        runs = {}
        for fused in paths:
            launches, res = serve_run(model, card, fused,
                                      SERVE_WAVES[family], tp=TP)
            runs[res["decode_path"]] = (launches, res)
        for path, (_, res) in runs.items():
            base = tp1[family]["fused" if path == "tp_fused_block"
                               else "unfused"][1]
            log(f"[serving:{family}:{path}] tp={TP} vs tp=1 "
                f"{base['decode_path']} on the same requests: "
                f"{res['tokens_per_s']:.1f} vs {base['tokens_per_s']:.1f} "
                f"tokens/s, TTFT p50 {res['ttft_p50_ms']} vs "
                f"{base['ttft_p50_ms']} ms, decode step p50 "
                f"{res['decode_step_ms_p50']} vs {base['decode_step_ms_p50']}"
                f" ms, busy share {res['decode_profile'].get('busy_share')} "
                f"vs {base['decode_profile'].get('busy_share')}, peak "
                f"{res['peak_mem_gb']:.1f} vs {base['peak_mem_gb']:.1f} GB "
                f"(card: {card}{TP_NOTE})")
        out[family] = runs
        del model
        free_card()
    return out


# ------------------------------------------------- speculative decoding
# the reference's speculative traffic (bench.py's speculative serving row):
# 8 slots, 16 greedy requests of 64 new tokens at spec_k 4; each prompt a
# 256-token prefix tiled from one 4-token phrase, then a 32-token turn
# tiled from 2 words of its own
SPEC_K = 4
SPEC_SLOTS, SPEC_REQUESTS, SPEC_NEW = 8, 16, 64
SPEC_PREFIX, SPEC_TURN = 256, 32
# the one-step check's bound: each verify window position's bf16 logits
# against a sequential decode step's over the same tokens (every layer,
# GEMMs of 8 x 5 rows against 8, attention by the chunk kernel against the
# split kernel or the fused block), each row within this share of its
# largest |logit| (8 bf16 ulps of it).  On an H100 the two differ by
# 1.0-1.7 % of it at every position (32 layers of bf16 residual), and a
# window read one position late by 7 % (gpt3_6_7b's random greedy output
# makes its positions alike) to 57 % (llama_7b); the attention's causal
# tail off moves them 1.6-2.4 %, inside the bf16 spread, so the element
# checks of decode_attention at the verify width are what see that fault
SPEC_LOGIT_BOUND = 2.0 ** -5
# decode_attention at the verify width: 8 slots x 5 queries of 32 heads x
# 128 (gpt3_6_7b and llama_7b) over a 4096-row cache at these lengths
VERIFY_HEADS, VERIFY_HEAD_DIM, VERIFY_S_MAX = 32, 128, 4096
VERIFY_ROWS = (1024, 3072)
# decode_block_attn (row 2) at gpt3_6_7b width over a 4096-row cache at
# these positions: the cache lengths where the fused step lost to the
# unfused one
BLOCK_LONG_S_MAX = 4096
BLOCK_LONG_ROWS = (2048, 3072)
# the engines of the phase: (label, family, fused_decode, tp)
SPEC_ENGINES = (("gpt_unfused", "gpt", False, 1),
                ("gpt_fused", "gpt", True, 1),
                ("llama_unfused", "llama", False, 1),
                ("gpt_tp2_tp_fused_block", "gpt", True, TP))


def serving_kernels() -> tuple:
    """Every kernel wrapper a serving run may launch."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    from paddle_tpu_torch.kernels.decode_block import (decode_block_attn,
                                                       decode_block_mlp)
    from paddle_tpu_torch.kernels.decode_block_tp import (
        decode_block_attn_tp, ring_entry_hop, ring_exit_hop)
    return (decode_attention, decode_block_attn, decode_block_mlp,
            *(getattr(fn, k) for k in NORM_KERNELS), ring_entry_hop,
            ring_exit_hop, decode_block_attn_tp)


def spec_prompts(vocab: int) -> list:
    """The speculative traffic's 16 prompts, drawn as the reference draws
    them (``RandomState(13)``: the phrase, then each turn's 2 words)."""
    import numpy as np
    rs = np.random.RandomState(13)
    prefix = np.tile(rs.randint(0, vocab, (4,)), SPEC_PREFIX // 4)
    return [np.concatenate([prefix, np.tile(rs.randint(0, vocab, (2,)),
                                            SPEC_TURN // 2)])
            for _ in range(SPEC_REQUESTS)]


def spec_want(eng, layers: int, tp: int, fused: bool) -> dict:
    """The launch equations of a speculative engine's run, from its pass
    counts (the eager call before each capture, and the capture; never a
    replay): prefill chunks and verify steps run ``decode_attention`` and
    the model's norms (at tp=2 on each shard; verify through the ring
    program on a ``tp_fused_block`` engine), decode steps the path's own
    decode kernels."""
    core = eng.core
    pp = core.eager_prefill_chunks + core.capture_counts["prefill"]
    dp = core.eager_decode_steps + core.capture_counts["decode"]
    vp = core.eager_verify_steps + core.capture_counts["verify"]
    llama = hasattr(core.model, "llama")
    norm = "rms_norm_fwd" if llama else "layer_norm_fwd"
    want = {k.__name__: 0 for k in serving_kernels()}
    if tp == 1:
        unfused = pp + vp + (0 if fused else dp)
        want["decode_attention"] = layers * unfused
        want[norm] = (2 * layers + 1) * unfused + (dp if fused else 0)
        if fused:
            want["decode_block_attn"] = want["decode_block_mlp"] = \
                layers * dp
    else:
        want["decode_attention"] = layers * tp * (pp + vp)
        want[norm] = (2 * layers + 1) * tp * (pp + dp + vp)
        want["ring_entry_hop"] = want["ring_exit_hop"] = \
            layers * 2 * tp * tp * dp
        want["decode_block_attn_tp"] = layers * tp * dp
    return want


def spec_serve(model, card: str, label: str, spec_k: int, fused: bool,
               tp: int = 1):
    """Serve the speculative traffic twice on one ``ServingEngine(
    num_slots=8, spec_k=spec_k)`` of ``model`` (the reference's protocol:
    a warm-up pass that captures the graphs, then the measured pass of the
    same prompts), every launch count set to 0 just before the first pass
    and read just after the second and held to ``spec_want``.  Times each
    decode-only step of the measured pass on the host clock (its readback
    waits for the card), as a verify step where drafts were proposed, else
    a decode step.  Returns ``(engine, result)``; the caller closes the
    engine."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import ServingEngine

    kernels = serving_kernels()
    tp_kw = {} if tp == 1 else dict(tensor_parallel=tp,
                                    devices=TP_DEVICES[:tp])
    eng = ServingEngine(model, num_slots=SPEC_SLOTS, fused_decode=fused,
                        spec_k=spec_k, **tp_kw)
    path = ("fused" if fused else "unfused") if tp == 1 else \
        ("tp_fused_block" if fused else "tp_fused")
    tag = f"[serving:spec:{label}:k{spec_k}]"
    if eng.decode_path != path or eng.spec_on != (spec_k > 0):
        raise AssertionError(f"{tag} engine resolved {eng.decode_path!r} "
                             f"(spec_on {eng.spec_on}, "
                             f"{eng.spec_fallback_reason!r})")
    prompts = spec_prompts(model.cfg.vocab_size)
    drafts = eng.registry.get("spec.draft_tokens")
    step_ms = {"verify": [], "decode": []}

    def serve(timed: bool):
        rids = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        core = eng.core
        t0 = time.perf_counter()
        while True:
            decode_only = not core._prefills and not core.scheduler.waiting
            before = drafts.value
            t = time.perf_counter()
            left = eng.step()
            if timed and decode_only:
                kind = "verify" if drafts.value > before else "decode"
                step_ms[kind].append((time.perf_counter() - t) * 1e3)
            if not left:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return [eng.purge(r) for r in rids], wall

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    _, warm_s = serve(False)
    # the window's counters and events restart with the measured pass
    compiles = eng.registry.get("serving.compiles").value
    compiled = sum(a["count"] for *_, a in eng.tracer.events("compile"))
    eng.metrics.reset()
    outs, wall = serve(True)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    compiles += eng.registry.get("serving.compiles").value
    compiled += sum(a["count"] for *_, a in eng.tracer.events("compile"))
    core = eng.core
    want = spec_want(eng, model.cfg.num_layers, tp, fused)
    if launches != want:
        raise AssertionError(f"{tag} kernel launches {launches} != {want}: "
                             f"the main path bypassed a kernel")
    # one capture a program that ran (each after one eager call):
    # verify on a speculative engine, decode where a step proposed no
    # draft, one prefill graph a chunk width
    counts = dict(core.capture_counts)
    eager = {"prefill": core.eager_prefill_chunks,
             "decode": core.eager_decode_steps,
             "verify": core.eager_verify_steps}
    want_counts = {"prefill": len(core._prefill_graphs),
                   "decode": min(eager["decode"], 1),
                   "verify": int(spec_k > 0)}
    if counts != want_counts or eager != counts or \
            compiles != sum(counts.values()) or compiled != compiles or \
            eng.decode_graph_reason is not None:
        raise AssertionError(f"{tag} captures {counts} (want "
                             f"{want_counts}), eager calls {eager}, "
                             f"serving.compiles {compiles}, compile events "
                             f"{compiled}, graph reason "
                             f"{eng.decode_graph_reason!r}")
    for out in outs:
        if not (out.status == "finished" and len(out.tokens) == SPEC_NEW
                and all(0 <= t < model.cfg.vocab_size for t in out.tokens)):
            raise AssertionError(f"{tag} request {out.request_id} did not "
                                 f"finish with {SPEC_NEW} in-vocab tokens: "
                                 f"{out}")
    m = eng.metrics_dict()
    med = {kind: float(np.median(v)) if v else None
           for kind, v in step_ms.items()}
    res = {"decode_path": eng.decode_path, "tp": tp, "spec_k": spec_k,
           "tokens": [o.tokens for o in outs],
           "tokens_generated": m["tokens_generated"], "wall_s": wall,
           "warm_up_s": warm_s,
           "tokens_per_s": m["tokens_generated"] / wall,
           "engine_tokens_per_sec": m["tokens_per_sec"],
           "steps": m["steps"],
           "verify_step_ms_p50": med["verify"],
           "decode_step_ms_p50": med["decode"],
           "verify_steps_timed": len(step_ms["verify"]),
           "decode_steps_timed": len(step_ms["decode"]),
           "spec_draft_tokens": m["spec_draft_tokens"],
           "spec_accepted_tokens": m["spec_accepted_tokens"],
           "spec_acceptance_rate": m["spec_acceptance_rate"],
           "capture_counts": counts, "serving.compiles": compiles,
           "capture_ms": {p: s * 1e3 for p, s in
                          core.capture_seconds.items()},
           "launches": launches}
    log(f"{tag} {eng.decode_path}: {SPEC_REQUESTS} requests x {SPEC_NEW} "
        f"tokens, measured pass {wall:.3f} s, {res['tokens_per_s']:.1f} "
        f"tokens/s, {m['steps']} steps; verify step p50 "
        f"{med['verify']} ms ({len(step_ms['verify'])}), decode step p50 "
        f"{med['decode']} ms ({len(step_ms['decode'])}); acceptance "
        f"{m['spec_acceptance_rate']} ({m['spec_accepted_tokens']} of "
        f"{m['spec_draft_tokens']} drafts); captures {counts} == "
        f"serving.compiles {compiles}; launches {json.dumps(launches)} "
        f"(card: {card}{TP_NOTE if tp > 1 else ''})")
    return eng, res


def _on_capture_stream(core, fn) -> None:
    """``fn()`` on the engine's capture stream, joined to the current
    stream both ways (as the capture's eager warm-up runs a body)."""
    import torch
    from paddle_tpu_torch.serving.engine import _capture_stream
    stream = _capture_stream(core.device)
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn()
    current.wait_stream(stream)


def causal_tail_off_logits(core):
    """The engine's verify body run eagerly from its current state with a
    planted fault: its attention calls by the plain version with the
    causal tail off (each window query sees every window row).  A copy of
    the logits it leaves; the caller restores the window's rows."""
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention_reference)
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.serving import tp
    mods = (gpt, llama, tp)
    right = [m.decode_attention_auto for m in mods]

    def wrong(q, kc, vc, lens, scale=None, causal_tail=True):
        return decode_attention_reference(q, kc, vc, lens, scale=scale,
                                          causal_tail=False)
    for m in mods:
        m.decode_attention_auto = wrong
    try:
        _on_capture_stream(core, core._verify_body)
        return core._verify_logits.clone()
    finally:
        for m, fn in zip(mods, right):
            m.decode_attention_auto = fn


def verify_checks(eng, card: str, label: str) -> dict:
    """On a speculative engine whose 8 slots all decode (fresh requests of
    the traffic's shape), with every slot's window filled to spec_k
    tokens (its draft, then random ids):

      * the verify graph's replay against the verify body run eagerly from
        the same state: logits and the window's K/V rows bit-identical,
        ``seq_pos`` left as it was; both timed with CUDA events;
      * the one-step check: spec_k + 1 sequential decode steps (the
        engine's decode body, eagerly) over the same tokens from the same
        state, each position's logits within ``SPEC_LOGIT_BOUND`` of its
        row's largest |logit|; the greedy argmax equal wherever the
        sequential top-2 gap is above twice the largest difference or
        twice that bound (one position of the latter at least); a
        planted wrong verify step (the window one position late) above
        it, and one recorded (the causal tail off:
        ``causal_tail_off_logits``);
      * ``decode_attention`` at the verify width on the engine's own
        layer-0 slab (shard 0) at the window's lengths against its plain
        version (``row_reading`` <= 1), and the plain version with the
        causal tail off above that limit.

    The state is restored after each check (``seq_pos``, the last tokens,
    the window rows); the requests then finish."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    core, pool = eng.core, eng.core.pool
    k, n = core.spec_k, core.num_slots
    vocab = core.model.cfg.vocab_size
    tag = f"[spec:{label}]"
    rs = np.random.RandomState(29)
    prefix = spec_prompts(vocab)[0][:SPEC_PREFIX]
    rids = [eng.submit(np.concatenate([prefix, rs.randint(0, vocab,
                                                          (SPEC_TURN,))]),
                       max_new_tokens=4 * (k + 1)) for _ in range(n)]
    while core._prefills or core.scheduler.waiting:
        eng.step()
    torch.cuda.synchronize()
    if len(core._slots) != n:
        raise AssertionError(f"{tag} {len(core._slots)} of {n} slots busy")
    host = np.zeros((n, k + 1), np.int64)
    host[:, :k] = rs.randint(0, vocab, (n, k))
    spec = core._propose_drafts()
    if spec is not None:
        d, lens, _ = spec
        for r in range(n):
            host[r, :lens[r]] = d[r, :lens[r]]
    host[:, k] = k
    core._verify_io.copy_(torch.from_numpy(host))
    pos0, tok0 = pool.seq_pos.clone(), core._last_tok.clone()
    slabs = [t for row in (*pool.ks, *pool.vs)
             for t in (row if isinstance(row, list) else [row])]
    dev = slabs[0].device
    rows = torch.arange(n, device=dev)[:, None]
    cols = pos0.to(dev).long()[:, None] + torch.arange(k + 1, device=dev)

    def window():
        return [s[rows, cols] for s in slabs]
    saved = window()

    def restore():
        pool.seq_pos.copy_(pos0)
        core._last_tok.copy_(tok0)
        for s, r in zip(slabs, saved):
            s[rows, cols] = r

    runs = {}
    for name, fn in (("replay", core._verify_graph_step),
                     ("eager", lambda: _on_capture_stream(
                         core, core._verify_body))):
        restore()
        fn()
        torch.cuda.synchronize()
        runs[name] = {"logits": core._verify_logits.clone(),
                      "rows": window(),
                      "pos_kept": torch.equal(pool.seq_pos, pos0),
                      "ms": time_ms(fn, iters=5, warmup=2, windows=3)}
    r, e = runs["replay"], runs["eager"]
    exact = torch.equal(r["logits"], e["logits"]) and all(
        torch.equal(a, b) for a, b in zip(r["rows"], e["rows"]))
    if not (exact and r["pos_kept"] and e["pos_kept"]):
        raise AssertionError(f"{tag} a replayed verify step differs from its "
                             f"eager body (bit-identical {exact}) or moved "
                             f"seq_pos ({r['pos_kept']}, {e['pos_kept']})")
    # sequential decode over the window's tokens from the same state
    restore()
    ids = torch.cat([tok0[:, None].long(), core._verify_io[:, :k]], dim=1)
    seq = []
    t0 = time.perf_counter()
    for t in range(k + 1):
        core._last_tok.copy_(ids[:, t])
        _on_capture_stream(core, core._decode_body)
        seq.append(core._logits.clone())
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    restore()
    torch.cuda.synchronize()
    seq = torch.stack(seq, dim=1)
    ver = r["logits"]
    limit = SPEC_LOGIT_BOUND * seq.abs().amax(-1)        # [n, k + 1]

    def logit_reading(got, want, lim):
        return ((got - want).abs().amax(-1) / lim).max().item()
    reading = logit_reading(ver, seq, limit)
    max_diff = (ver - seq).abs().max().item()
    # the greedy argmax wherever the sequential top-2 gap exceeds twice
    # the largest difference or twice the bound (a verify within the
    # bound picks the same token there), at one position of the latter
    # at least: a set that does not shrink as the difference grows
    top2 = seq.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    past_bound = gap > 2 * limit
    sure = (gap > 2 * max_diff) | past_bound
    agree = ver.argmax(-1) == seq.argmax(-1)
    # two planted wrong verify steps held to the same bound: the window
    # read one position late, which must read above it, and the eager
    # verify body with its attention's causal tail off (each window query
    # sees every window row, by the plain version), recorded only: it
    # stays inside the bf16 spread (``SPEC_LOGIT_BOUND``)
    faults = {"window shifted by one": logit_reading(
        ver[:, 1:], seq[:, :-1], limit[:, :-1])}
    faults["causal tail off"] = logit_reading(
        causal_tail_off_logits(core), seq, limit)
    restore()
    torch.cuda.synchronize()
    log(f"{tag} verify logits against {k + 1} sequential decode steps of "
        f"the same tokens: max abs diff {max_diff:.4g}, reading "
        f"{reading:.3g} of the bound ({SPEC_LOGIT_BOUND} x each row's "
        f"largest |logit|); argmax equal at {int(agree[sure].sum())} of "
        f"{int(sure.sum())} positions (of {sure.numel()}) whose top-2 gap "
        f"exceeds twice the largest difference or, {int(past_bound.sum())}"
        f" of them, twice the bound; planted wrong verify steps read "
        f"{json.dumps(faults)} (the first wanted above 1) (card: {card})")
    if reading > 1.0 or not bool(agree[sure].all()) or \
            not bool(past_bound.any()):
        raise AssertionError(
            f"{tag} verify logits against sequential decode: reading "
            f"{reading} (bound {SPEC_LOGIT_BOUND} of each row's largest "
            f"|logit|), max abs diff {max_diff}; argmax equal at "
            f"{int(agree[sure].sum())} of {int(sure.sum())} positions whose "
            f"top-2 gap exceeds twice it or twice the bound, "
            f"{int(past_bound.sum())} past the bound (at least one wanted)")
    if faults["window shifted by one"] <= 1.0:
        raise AssertionError(f"{tag} the planted wrong verify step (the "
                             f"window shifted by one) reads only "
                             f"{faults['window shifted by one']} of the "
                             f"bound {SPEC_LOGIT_BOUND}: the check cannot "
                             f"see it")
    # decode_attention at the verify width on the engine's own cache
    slab_k, slab_v = slabs[0], slabs[len(slabs) // 2]
    cfg = core.model.cfg
    rep = cfg.num_heads // (getattr(cfg, "kv_heads", None) or cfg.num_heads)
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    q = torch.randn((n, k + 1, slab_k.shape[2] * rep, slab_k.shape[3]),
                    generator=g, device=dev).to(slab_k.dtype)
    lens = (pos0.to(dev) + k + 1).to(torch.int32)
    got = decode_attention(q, slab_k, slab_v, lens)
    want = decode_attention_reference(q, slab_k, slab_v, lens)
    torch.cuda.synchronize()
    attn_read = row_reading(got, want)
    attn_err = (got.float() - want.float()).abs().max().item()
    # a planted fault the element check must see: the causal tail off
    tail_off = row_reading(decode_attention_reference(
        q, slab_k, slab_v, lens, causal_tail=False), want)
    if attn_read > 1.0 or tail_off <= 1.0:
        raise AssertionError(f"{tag} decode_attention at the verify width "
                             f"q{list(q.shape)} over the engine's slab: "
                             f"element reading {attn_read} (max abs err "
                             f"{attn_err}); the plain version with the "
                             f"causal tail off reads {tail_off} (want > 1)")
    eng.run_until_complete()
    for rid in rids:
        eng.purge(rid)
    out = {"bit_identical": True, "replay_ms": r["ms"], "eager_ms": e["ms"],
           "sequential_decode_s": seq_s,
           "logit_reading": reading, "logit_max_abs_diff": max_diff,
           "logit_bound": SPEC_LOGIT_BOUND,
           "planted_fault_readings": faults,
           "argmax_checked": int(sure.sum()),
           "argmax_past_bound": int(past_bound.sum()),
           "argmax_positions": int(sure.numel()),
           "attention_reading": attn_read, "attention_max_abs_err": attn_err,
           "attention_causal_tail_off_reading": tail_off,
           "attention_q": list(q.shape), "attention_lens": lens.tolist()}
    log(f"{tag} replayed verify step vs its eager body from the same state: "
        f"logits and the {len(slabs)} window K/V row blocks bit-identical, "
        f"seq_pos kept; CUDA events {r['ms']:.3f} ms a replay, "
        f"{e['ms']:.3f} ms an eager body; the logits within the bound of "
        f"sequential decode (above).  decode_attention q{list(q.shape)} "
        f"over the engine's slab at lengths {lens.tolist()}: element reading "
        f"{attn_read:.3g}, the causal tail off (planted, plain version) "
        f"{tail_off:.3g} (card: {card})")
    return out


def verify_attention(card: str) -> dict:
    """``decode_attention`` at the verify width (8 slots x 5 queries of 32
    heads x 128, bf16, over a 4096-row cache) at ``VERIFY_ROWS`` cached
    rows: at ragged lengths with the causal tail (a row shorter than the
    window included) and at the timed uniform lengths against the plain
    version (``row_reading`` <= 1), two calls bit-identical, the plain
    version with the causal tail off above that limit at the ragged
    lengths; timed (CUDA events and torch.profiler) beside the plain
    version, the bound, the split kernel's decode call over the same
    cache (sq = 1) and SDPA."""
    import torch
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(37)
    b, sq = SPEC_SLOTS, SPEC_K + 1
    h, d, s_max = VERIFY_HEADS, VERIFY_HEAD_DIM, VERIFY_S_MAX

    def r(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q, q1 = r((b, sq, h, d)), r((b, 1, h, d))
    k, v = r((b, s_max, h, d)), r((b, s_max, h, d))
    out = {}
    for rows in VERIFY_ROWS:
        ragged = [rows, rows - 1, rows - 3, rows - 127, rows - 128,
                  rows // 2 + 7, sq, 3]
        uniform = [rows] * b
        reads = {}
        for name, lens in (("uniform", uniform), ("ragged", ragged)):
            lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = decode_attention(q, k, v, lens)
            again = decode_attention(q, k, v, lens)
            want = decode_attention_reference(q, k, v, lens)
            torch.cuda.synchronize()
            reads[name] = row_reading(got, want)
            err = (got.float() - want.float()).abs().max().item()
            if reads[name] > 1.0 or not torch.equal(got, again):
                raise AssertionError(
                    f"decode_attention at the verify width q{list(q.shape)} "
                    f"kv{list(k.shape)} lengths {lens.tolist()}: element "
                    f"reading {reads[name]} (max abs err {err}), two calls "
                    f"bit-identical {torch.equal(got, again)}")
        # a planted fault the element check must see: the plain version
        # with the causal tail off, at the ragged lengths
        tail_off = row_reading(decode_attention_reference(
            q, k, v, lens, causal_tail=False), want)
        if tail_off <= 1.0:
            raise AssertionError(f"decode_attention at the verify width: "
                                 f"the causal tail off reads only {tail_off}")
        lens = torch.tensor(uniform, dtype=torch.int32, device=dev)
        call = lambda: decode_attention(q, k, v, lens)
        split = lambda: decode_attention(q1, k, v, lens)
        bound, bound_by = attention_bound(q, k, lens)
        split_bound, _ = attention_bound(q1, k, lens)
        rec = {"ms": time_ms(call), "device_ms": device_ms(call),
               "plain_ms": time_ms(lambda: decode_attention_reference(
                   q, k, v, lens)),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": time_ms(sdpa_call(q, k, v, lens)),
               "split_ms": time_ms(split), "split_device_ms":
                   device_ms(split), "split_bound_ms": split_bound,
               "element_reading": max(reads.values()),
               "causal_tail_off_reading": tail_off,
               "q": [b, sq, h, d], "kv": [b, s_max, h, d], "rows": rows,
               "ragged_lens": ragged}
        rec["over_split"] = rec["device_ms"] / rec["split_device_ms"]
        rec["over_bound"] = rec["device_ms"] / bound
        out[f"verify_{rows}"] = rec
        log(f"[kernels] decode_attention at the verify width q{[b, sq, h, d]}"
            f" kv{[b, s_max, h, d]} bf16, {rows} rows: kernel "
            f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), plain "
            f"{rec['plain_ms']:.4f}, sdpa {rec['library_ms']:.4f}, bound "
            f"{bound:.4f} ({bound_by}; device time {rec['over_bound']:.2f}x "
            f"it); decode_split_kernel at sq = 1 over the same cache "
            f"{rec['split_ms']:.4f} (device {rec['split_device_ms']:.4f}, "
            f"bound {split_bound:.4f}): {rec['over_split']:.2f}x; element "
            f"reading {rec['element_reading']:.3g} (ragged lengths "
            f"{ragged} too; the causal tail off there, planted in the plain "
            f"version, {tail_off:.3g}) (card: {card})")
    return out


def block_attn_long(card: str) -> dict:
    """``decode_block_attn`` (row 2) at gpt3_6_7b width over 8 slots of a
    4096-row cache at ``BLOCK_LONG_ROWS``: against its plain version
    (``attn_reading`` <= 1, two planted faults above it:
    ``attn_faults``), then timed (CUDA events and torch.profiler)
    beside the plain version, its bound, the unfused path's attention at
    the same cache (``decode_attention`` at sq = 1) and the unfused layer
    forward."""
    import torch
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    from paddle_tpu_torch.kernels.decode_block import (
        decode_block_attn, decode_block_attn_reference, plan_decode_block)
    from paddle_tpu_torch.models import gpt3_6_7b
    from paddle_tpu_torch.models.gpt import GPTBlock
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    cfg = gpt3_6_7b()
    b, s_max, h, dh = SPEC_SLOTS, BLOCK_LONG_S_MAX, cfg.num_heads, \
        cfg.head_dim
    layer = GPTBlock(cfg, device=dev, dtype=torch.bfloat16,
                     generator=g).eval()
    kw = layer.decode_block_weights()
    plan, why = plan_decode_block(
        max_seq=s_max, hidden=cfg.hidden_size, heads=h, kv_heads=h,
        head_dim=dh, ffn=cfg.ffn_size, batch=b, itemsize=2, gated=False)
    if plan is None:
        raise AssertionError(f"no decode-block plan at gpt3_6_7b width, "
                             f"S_max {s_max}: {why}")
    bk = plan["block_k"]
    x = torch.randn((b, 1, cfg.hidden_size), generator=g,
                    device=dev).to(torch.bfloat16)
    k = torch.randn((b, s_max, h, dh), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn_like(k)
    q1 = torch.randn((b, 1, h, dh), generator=g,
                     device=dev).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for rows in BLOCK_LONG_ROWS:
            pos = torch.full((b,), rows, dtype=torch.int32, device=dev)
            got, _, _ = attn_call(decode_block_attn, x, k.clone(), v.clone(),
                                  pos, kw, block_k=bk)
            want, _, _ = attn_call(decode_block_attn_reference, x, k.clone(),
                                   v.clone(), pos, kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            read = attn_reading(got, want, dh)
            if read > 1.0:
                raise AssertionError(f"decode_block_attn at {rows} rows "
                                     f"disagrees: element reading {read}, "
                                     f"max_abs_err {err}")
            faults = attn_faults(x, k, v, pos, kw, bk, want)
            call = lambda: attn_call(decode_block_attn, x, k, v, pos, kw,
                                     block_k=bk)
            lens = pos + 1
            split = lambda: decode_attention(q1, k, v, lens)
            bound, bound_by = block_bounds(x, kw, pos.tolist(), s_max)["attn"]
            rec = {"ms": time_ms(call), "device_ms": device_ms(call),
                   "plain_ms": time_ms(lambda: attn_call(
                       decode_block_attn_reference, x, k, v, pos, kw)),
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": None, "max_abs_err": err,
                   "element_reading": read,
                   "planted_fault_readings": faults,
                   "split_attention_device_ms": device_ms(split),
                   "unfused_layer_ms": time_ms(lambda: layer(x, (k, v,
                                                                 pos))),
                   "rows": rows, "kv": [b, s_max, h, dh], "block_k": bk}
            rec["over_bound"] = rec["device_ms"] / bound
            out[f"rows_{rows}"] = rec
            log(f"[kernels] decode_block_attn at gpt3_6_7b width, 8 slots "
                f"at {rows} of {s_max} rows: kernel {rec['ms']:.4f} ms "
                f"(device {rec['device_ms']:.4f}, {rec['over_bound']:.2f}x "
                f"the bound {bound:.4f}, {bound_by}), plain "
                f"{rec['plain_ms']:.4f}; the unfused path's attention alone "
                f"(decode_split_kernel) device "
                f"{rec['split_attention_device_ms']:.4f}, the unfused layer "
                f"{rec['unfused_layer_ms']:.4f}; max abs err {err:.3g}, "
                f"element reading {read:.3g} (one head as a row); planted "
                f"faults read {json.dumps(faults)} (want > 1) (card: "
                f"{card})")
    del layer, k, v
    torch.cuda.empty_cache()
    return out


def phase_serving_spec(card: str) -> dict:
    """Speculative decoding at full width and depth (random bf16 weights
    from a seeded generator on the card), on the engines of
    ``SPEC_ENGINES``: gpt3_6_7b unfused and fused on one model, llama_7b
    unfused, and gpt3_6_7b at tp=2 ``tp_fused_block`` (both shards on the
    card) on a fresh model.  Each serves the speculative traffic at
    ``spec_k=4`` and at ``spec_k=0`` (``spec_serve``: one verify capture,
    ``serving.compiles`` the sum of the captures, the launch equations),
    then ``verify_checks`` on the speculative engine.  Reports decode
    tokens/s against spec_k=0, the acceptance rate, verify against decode
    step p50 and the token agreement with spec_k=0; then times
    ``decode_attention`` at the verify width (``verify_attention``) and
    ``decode_block_attn`` at long caches (``block_attn_long``)."""
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_6_7b, llama_7b)

    def build(family):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(1234)
        if family == "gpt":
            return GPTForCausalLM(gpt3_6_7b(), device=DEVICE,
                                  generator=gen).eval()
        return LlamaForCausalLM(llama_7b(), device=DEVICE,
                                generator=gen).eval()

    out = {"engines": {}}
    model, built = None, None
    for label, family, fused, tp in SPEC_ENGINES:
        if built != (family, tp):
            # a tensor-parallel engine re-lays its model: its own model
            model = None
            free_card()
            model, built = build(family), (family, tp)
        runs = {}
        for spec_k in (SPEC_K, 0):
            eng, runs[spec_k] = spec_serve(model, card, label, spec_k,
                                           fused, tp)
            if spec_k:
                runs[spec_k]["checks"] = verify_checks(eng, card, label)
            eng.close()
            eng = None
        s, base = runs[SPEC_K], runs[0]
        got, want = s.pop("tokens"), base.pop("tokens")
        same = [a == b for a, b in zip(got, want)]
        first = next((i for i, ok in enumerate(same) if not ok), None)
        # the first divergence: (request, token index, spec, spec_k=0)
        where = None
        if first is not None:
            a, b = got[first], want[first]
            t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            where = [first, t, a[t], b[t]]
        rec = {"spec": s, "base": base,
               "requests_identical": sum(same),
               "first_divergence": where,
               "tokens_per_s_ratio": s["tokens_per_s"] / base["tokens_per_s"]}
        out["engines"][label] = rec
        log(f"[serving:spec:{label}] spec_k={SPEC_K} vs 0 on the same model "
            f"and traffic: {s['tokens_per_s']:.1f} vs "
            f"{base['tokens_per_s']:.1f} decode tokens/s "
            f"({rec['tokens_per_s_ratio']:.3f}x), acceptance "
            f"{s['spec_acceptance_rate']}, verify step p50 "
            f"{s['verify_step_ms_p50']} ms vs decode step p50 "
            f"{base['decode_step_ms_p50']} ms; requests identical "
            f"{sum(same)} of {len(same)}, first divergence (request, token, "
            f"spec, spec_k=0) {where} "
            f"(card: {card}{TP_NOTE if tp > 1 else ''})")
    model = None
    free_card()
    out["verify_attention"] = verify_attention(card)
    out["block_attn_long"] = block_attn_long(card)
    return out


# ------------------------------------------------- fault-tolerant serving
# the chaos phase's traffic on every engine: 12 greedy requests of 8 tokens
# on 8 slots (4 wait in the queue), prompts of 65-128 random tokens (one
# chunk width, 128, and no radix hit), then follow-up requests after the
# wave; the speculative engines' prompts are 3-token phrases tiled, so
# their n-gram tables draft
CHAOS_KW = dict(num_slots=8, block_len=16, prefill_chunk=512)
CHAOS_REQUESTS, CHAOS_NEW = 12, 8
# the nan_logits fault fires at this hit of its site (each step with a
# live slot is one): the 4th such step, a decode (or verify) step over
# the first requests with the rest still prefilling or queued
CHAOS_POISON_AT = 3


def chaos_prompts(vocab: int, seed: int, tiled: bool = False) -> list:
    """The wave's prompts, then one follow-up prompt a slot."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(CHAOS_REQUESTS + CHAOS_KW["num_slots"]):
        n = int(rs.randint(65, 129))
        p = rs.randint(0, vocab, (3 if tiled else n,))
        out.append(np.tile(p, n // 3 + 1)[:n] if tiled else p)
    return out


def chaos_engine(model, tp: int, **kw):
    """One engine of the phase: ``CHAOS_KW``, the watchdog with no backoff
    sleep, an injector; tp=2 on both shards of the card."""
    from paddle_tpu_torch.serving import (FaultInjector,
                                          FaultToleranceConfig,
                                          ServingEngine)
    tp_kw = {} if tp == 1 else dict(tensor_parallel=tp,
                                    devices=TP_DEVICES[:tp])
    return ServingEngine(model, **CHAOS_KW, **tp_kw, **kw,
                         fault_tolerance=FaultToleranceConfig(
                             backoff_base_s=0.0),
                         faults=FaultInjector())


def chaos_serve(eng, prompts, cancel=None):
    """Serve ``prompts`` to the end on ``eng``; with ``cancel = (i, n)``
    cancel request ``i`` right after ``n`` steps.  Returns the outputs and,
    per request, the steps after which it was terminal."""
    rids = [eng.submit(p, max_new_tokens=CHAOS_NEW) for p in prompts]
    steps, done_at = 0, [None] * len(rids)
    while eng.core.scheduler.has_work():
        eng.step()
        steps += 1
        for i, rid in enumerate(rids):
            if done_at[i] is None and eng.result(rid).finished:
                done_at[i] = steps
        if cancel is not None and steps == cancel[1]:
            eng.cancel(rids[cancel[0]])
        if steps > 600:
            raise AssertionError(
                f"serving did not drain: {eng.core.stall_snapshot()}")
    return [eng.result(r) for r in rids], done_at


def chaos_clean(model, tp: int, prompts, cancel=None, follow: int = 1,
                **kw):
    """A fault-free engine's greedy tokens for the wave (``cancel`` as in
    ``chaos_serve``), then for the first ``follow`` follow-up requests
    served together."""
    eng = chaos_engine(model, tp, **kw)
    outs, _ = chaos_serve(eng, prompts[:CHAOS_REQUESTS], cancel)
    follow, _ = chaos_serve(
        eng, prompts[CHAOS_REQUESTS:CHAOS_REQUESTS + follow])
    if eng.metrics_dict()["faults"] or any(
            o.status not in ("finished", "cancelled") for o in outs + follow):
        raise AssertionError(f"clean run failed: {outs + follow}")
    eng.close()
    return [o.tokens for o in outs + follow]


def _chaos_check(tag: str, ok: bool, what) -> None:
    if not ok:
        raise AssertionError(f"{tag} {what}")


def chaos_nan(model, tp: int, label: str, card: str, tiled: bool = False,
              **kw) -> dict:
    """``nan_logits`` on one engine: NaN written in place into the lowest
    live slot's K row at the ``CHAOS_POISON_AT``-th step with a live slot.
    Exactly that slot's request fails with "non-finite"; every other
    request equals a fault-free engine's run in which that request is
    cancelled right after the step it failed at (a speculative step's
    kind, verify or decode, depends on every slot's drafts, so the clean
    run keeps the same batch); follow-up requests fill the slots up to
    the poisoned one, and the one on it, once ``adopt`` rewrote it, equals
    the clean run's like the others."""
    import torch
    tag = f"[serving:chaos:{label}:nan_logits]"
    vocab = model.cfg.vocab_size
    prompts = chaos_prompts(vocab, 71, tiled)
    kernels = serving_kernels()
    for k in kernels:
        k.launches = 0
    eng = chaos_engine(model, tp, **kw)
    core = eng.core
    poisoned, verified = [], []
    poison, verify = core._poison_slot, core._verify_dispatch

    def poison_slot(slot, step_i):
        poisoned.append((slot, step_i, core._slots[slot].req.request_id))
        poison(slot, step_i)

    def verify_dispatch(*a):
        verified.append(core._step_in_flight)
        return verify(*a)

    core._poison_slot, core._verify_dispatch = poison_slot, verify_dispatch
    core.faults.enable("nan_logits", at=CHAOS_POISON_AT)
    try:
        outs, done_at = chaos_serve(eng, prompts[:CHAOS_REQUESTS])
    finally:
        core.faults.disable("nan_logits")
    _chaos_check(tag, len(poisoned) == 1, f"poisoned {poisoned}")
    slot, step_i, victim = poisoned[0]
    rids = [eng.submit(p, max_new_tokens=CHAOS_NEW)
            for p in prompts[CHAOS_REQUESTS:CHAOS_REQUESTS + slot + 1]]
    eng.step()
    follow_slot = next(s for s, r in core.scheduler.running.items()
                       if r.request_id == rids[-1])
    eng.run_until_complete(200)
    follow = [eng.result(r) for r in rids]
    launches = {k.__name__: k.launches for k in kernels}
    path, spec_on = eng.decode_path, eng.spec_on
    eng.close()
    eng = core = None
    failed_after = done_at[victim]
    want = chaos_clean(model, tp, prompts, cancel=(victim, failed_after),
                       follow=slot + 1, **kw)
    kind = "verify" if step_i in verified else "decode"
    _chaos_check(tag, kind == ("verify" if spec_on else "decode"),
                 f"the poisoned step ran {kind}")
    _chaos_check(tag, outs[victim].status == "failed"
                 and "non-finite" in outs[victim].status_reason,
                 f"poisoned request: {outs[victim]}")
    same = [o.status == "finished" and o.tokens == w
            for i, (o, w) in enumerate(zip(outs + follow, want))
            if i != victim]
    _chaos_check(tag, all(same), f"requests equal to the clean run: {same}")
    _chaos_check(tag, follow_slot == slot,
                 f"the last follow-up took slot {follow_slot}, not the "
                 f"poisoned {slot}")
    attn = {"unfused": "decode_attention", "fused": "decode_block_attn",
            "tp_fused_block": "decode_block_attn_tp"}[path]
    _chaos_check(tag, launches[attn] > 0, f"launches {launches}")
    res = {"decode_path": path, "spec": spec_on, "poisoned_slot": slot,
           "poisoned_step": step_i, "poisoned_step_kind": kind,
           "poisoned_request": victim, "failed_after_steps": failed_after,
           "requests_equal": sum(same) + 1, "attention_wrapper": attn,
           "launches": launches}
    log(f"{tag} {path}{' spec_k=4' if spec_on else ''}: NaN into slot "
        f"{slot} K row 0 at engine step {step_i} ({kind}); request "
        f"{victim} failed ({outs[victim].status_reason!r}) after "
        f"{failed_after} steps; {sum(same)} of {len(same)} others, "
        f"{len(follow)} follow-ups included (the last on slot "
        f"{follow_slot}), equal the clean run; {attn} launches "
        f"{launches[attn]}"
        f" (card: {card}{TP_NOTE if tp > 1 else ''})")
    return res


def chaos_quarantine(model, tp: int, label: str, card: str,
                     want: list) -> dict:
    """``step`` fires (max_step_retries + 1) times in a row after the
    first decode step: 3 retries, then a quarantine.  The 8 in-flight
    requests fail with "quarantine", the 4 queued ones equal ``want`` (a
    fault-free engine's), ``capture_counts["decode"]`` goes up by one
    across the rebuild and the prefill captures by at most one a width
    served after it.  The rebuild's device memory: allocated before it,
    its peak, after it, against the first build's peak plus the graph
    pool (a rebuild that allocated before it freed would add a plane)."""
    import torch
    tag = f"[serving:chaos:{label}:quarantine]"
    prompts = chaos_prompts(model.cfg.vocab_size, 71)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = chaos_engine(model, tp)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    core = eng.core
    mem, counts = {}, []
    rebuild = core._rebuild_device_plane

    def rebuild_device_plane():
        torch.cuda.synchronize()
        counts.append(dict(core.capture_counts))
        mem["pool_gb"] = pool_gb(core._graph_pool) or 0.0
        mem["before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rebuild()
        torch.cuda.synchronize()
        mem["seconds"] = time.perf_counter() - t0
        mem["peak"] = torch.cuda.max_memory_allocated()
        mem["after"] = torch.cuda.memory_allocated()

    core._rebuild_device_plane = rebuild_device_plane
    retries = core.ft.max_step_retries
    core.faults.enable("step", at=1, times=retries + 1)
    try:
        outs, _ = chaos_serve(eng, prompts[:CHAOS_REQUESTS])
    finally:
        core.faults.disable("step")
    m = eng.metrics_dict()
    after = dict(core.capture_counts)
    path, widths = eng.decode_path, len(core._prefill_graphs)
    eng.close()
    eng = core = None
    inflight, queued = outs[:CHAOS_KW["num_slots"]], outs[CHAOS_KW["num_slots"]:]
    _chaos_check(tag, m["quarantines"] == 1 and m["step_retries"] == retries
                 and len(counts) == 1, f"metrics {m}")
    _chaos_check(tag, all(o.status == "failed" and "quarantine" in
                          o.status_reason for o in inflight),
                 f"in-flight: {[(o.status, o.status_reason) for o in inflight]}")
    same = [o.status == "finished" and o.tokens == w
            for o, w in zip(queued, want[CHAOS_KW["num_slots"]:])]
    _chaos_check(tag, all(same), f"queued requests equal clean: {same}")
    before = counts[0]
    _chaos_check(tag, before["decode"] == 1 and after["decode"] == 2
                 and before["prefill"] <= after["prefill"]
                 <= before["prefill"] + widths,
                 f"captures {before} -> {after}")
    bound = build_peak + mem["pool_gb"] * 1e9
    _chaos_check(tag, mem["peak"] <= bound,
                 f"rebuild peak {mem['peak'] / 1e9:.3f} GB over the first "
                 f"build's {build_peak / 1e9:.3f} GB + graph pool "
                 f"{mem['pool_gb']:.3f} GB")
    gb = {k: mem[k] / 1e9 for k in ("before", "peak", "after")}
    res = {"decode_path": path, "captures_before": before,
           "captures_after": after, "rebuild_s": mem["seconds"],
           "build_peak_gb": build_peak / 1e9, "pool_gb": mem["pool_gb"],
           **{f"{k}_gb": v for k, v in gb.items()},
           "queued_equal": sum(same)}
    log(f"{tag} {path}: {retries} retries then one quarantine; "
        f"{len(inflight)} in-flight failed, {sum(same)} of {len(queued)} "
        f"queued equal the clean run; captures {before} -> {after}; "
        f"memory allocated before {gb['before']:.3f} GB, rebuild peak "
        f"{gb['peak']:.3f} GB (first build's peak {build_peak / 1e9:.3f} GB"
        f" + graph pool {mem['pool_gb']:.3f} GB), after "
        f"{gb['after']:.3f} GB; rebuild {mem['seconds']:.3f} s "
        f"(card: {card}{TP_NOTE if tp > 1 else ''})")
    return res


def chaos_fused_rung(model, tp: int, label: str, card: str,
                     want: list) -> dict:
    """Two ``step`` faults on a fused engine after its first decode
    steps: the ``fused_decode`` rung drops the decode graph and moves the
    engine to ``unfused`` (tp=1) or ``tp_fused`` (tp=2); one new decode
    capture follows, every request finishes, and the follow-up request
    (all on the new path) equals ``want`` (that path's fault-free
    run)."""
    tag = f"[serving:chaos:{label}:fused_decode_rung]"
    prompts = chaos_prompts(model.cfg.vocab_size, 71)
    eng = chaos_engine(model, tp, fused_decode=True)
    core = eng.core
    first = eng.decode_path
    core.faults.enable("step", at=2, times=2)
    try:
        outs, _ = chaos_serve(eng, prompts[:CHAOS_REQUESTS])
    finally:
        core.faults.disable("step")
    follow, _ = chaos_serve(eng, prompts[CHAOS_REQUESTS:CHAOS_REQUESTS + 1])
    path, reason = eng.decode_path, eng.decode_fallback_reason
    counts = dict(core.capture_counts)
    degraded = eng.degraded_subsystems
    eng.close()
    eng = core = None
    _chaos_check(tag, first == ("fused" if tp == 1 else "tp_fused_block")
                 and path == ("unfused" if tp == 1 else "tp_fused")
                 and reason.startswith("degraded")
                 and degraded == ("fused_decode",),
                 f"{first} -> {path} ({reason!r}, {degraded})")
    _chaos_check(tag, counts["decode"] == 2, f"captures {counts}")
    _chaos_check(tag, all(o.status == "finished" for o in outs),
                 f"statuses {[o.status for o in outs]}")
    _chaos_check(tag, follow[0].tokens == want[CHAOS_REQUESTS],
                 f"follow-up {follow[0].tokens} vs {want[CHAOS_REQUESTS]}")
    log(f"{tag} {first} -> {path} ({reason[:60]!r}); captures {counts}; "
        f"{len(outs)} requests finished; the follow-up equals a fault-free "
        f"{path} engine's (card: {card}{TP_NOTE if tp > 1 else ''})")
    return {"from": first, "to": path, "captures": counts}


def chaos_spec_rung(model, label: str, card: str) -> dict:
    """Two ``spec_verify`` faults after two verify steps: speculation is
    bypassed, no verify replay runs after, every request finishes, a
    second wave drafts nothing."""
    tag = f"[serving:chaos:{label}:spec_verify_rung]"
    prompts = chaos_prompts(model.cfg.vocab_size, 72, tiled=True)
    eng = chaos_engine(model, 1, spec_k=SPEC_K)
    core = eng.core
    calls, after = [], []
    step = core._verify_graph_step

    def verify_graph_step():
        (after if core.spec_bypass else calls).append(core._step_in_flight)
        step()

    core._verify_graph_step = verify_graph_step
    core.faults.enable("spec_verify", at=2, times=2)
    try:
        outs, _ = chaos_serve(eng, prompts[:CHAOS_REQUESTS])
    finally:
        core.faults.disable("spec_verify")
    drafted = eng.metrics_dict()["spec_draft_tokens"]
    more, _ = chaos_serve(eng, prompts[CHAOS_REQUESTS:])
    m = eng.metrics_dict()
    counts = dict(core.capture_counts)
    bypass, reason = core.spec_bypass, eng.spec_fallback_reason
    eng.close()
    eng = core = None
    _chaos_check(tag, bypass and reason.startswith("degraded"),
                 f"bypass {bypass} ({reason!r})")
    _chaos_check(tag, len(calls) == 2 and not after
                 and counts["verify"] == 1
                 and m["spec_draft_tokens"] == drafted,
                 f"verify graph calls {calls} then {after}, captures "
                 f"{counts}, drafts {drafted} -> {m['spec_draft_tokens']}")
    _chaos_check(tag, all(o.status == "finished" for o in outs + more),
                 f"statuses {[o.status for o in outs + more]}")
    log(f"{tag} spec_verify faults 2 -> spec_bypass ({reason[:60]!r}); "
        f"verify graph ran at steps {calls}, none after; captures {counts};"
        f" {len(outs) + len(more)} requests finished (card: {card})")
    return {"verify_steps": calls, "captures": counts}


def phase_serving_chaos(card: str) -> dict:
    """Fault-tolerant serving at full width and depth (random bf16 weights
    from a seeded generator on the card), each engine ``CHAOS_KW`` with
    ``FaultToleranceConfig(backoff_base_s=0)`` and a ``FaultInjector``,
    closed before the next is built: gpt3_6_7b unfused, fused and unfused
    at ``spec_k=4`` (``nan_logits``), unfused (quarantine), fused (the
    ``fused_decode`` rung) and at ``spec_k=4`` (the ``spec_verify`` rung);
    llama_7b at max_seq 4096 unfused (quarantine: two planes and the
    weights would not fit on the card); gpt3_6_7b at tp=2 on both shards
    of the card, ``tp_fused_block`` (``nan_logits``, the rung to
    ``tp_fused``) and ``tp_fused`` (quarantine).  Each quarantine resets
    the peak memory statistics to read its rebuild's peak, so the peak
    ``run_phase`` prints covers only what follows the last one."""
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_6_7b, llama_7b)

    def build(family):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(1234)
        if family == "gpt":
            return GPTForCausalLM(gpt3_6_7b(), device=DEVICE,
                                  generator=gen).eval()
        return LlamaForCausalLM(llama_7b(), device=DEVICE,
                                generator=gen).eval()

    out = {}
    model = build("gpt")
    vocab = model.cfg.vocab_size
    want = chaos_clean(model, 1, chaos_prompts(vocab, 71))
    for label, kw in (("gpt_unfused", {}),
                      ("gpt_fused", dict(fused_decode=True)),
                      ("gpt_unfused_spec", dict(spec_k=SPEC_K))):
        out[f"{label}:nan_logits"] = chaos_nan(
            model, 1, label, card, tiled="spec" in label, **kw)
    out["gpt_unfused:quarantine"] = chaos_quarantine(model, 1, "gpt_unfused",
                                                     card, want)
    out["gpt_fused:fused_decode_rung"] = chaos_fused_rung(
        model, 1, "gpt_fused", card, want)
    out["gpt_unfused_spec:spec_verify_rung"] = chaos_spec_rung(
        model, "gpt_unfused_spec", card)
    model = None
    free_card()
    model = build("llama")
    want = chaos_clean(model, 1, chaos_prompts(model.cfg.vocab_size, 71))
    out["llama_unfused:quarantine"] = chaos_quarantine(
        model, 1, "llama_unfused", card, want)
    model = None
    free_card()
    # a tensor-parallel engine re-lays its model: a fresh one, shared by
    # the tp engines on this mesh
    model = build("gpt")
    want = chaos_clean(model, TP, chaos_prompts(vocab, 71))
    label = f"gpt_tp{TP}"
    out[f"{label}_tp_fused_block:nan_logits"] = chaos_nan(
        model, TP, f"{label}_tp_fused_block", card, fused_decode=True)
    out[f"{label}_tp_fused:quarantine"] = chaos_quarantine(
        model, TP, f"{label}_tp_fused", card, want)
    out[f"{label}_tp_fused_block:fused_decode_rung"] = chaos_fused_rung(
        model, TP, f"{label}_tp_fused_block", card, want)
    model = None
    free_card()
    return out


# ------------------------------------------------------ serving:durable
# the durable phase's engine: ENGINE_KW, unfused, speculating
DURABLE_KW = dict(ENGINE_KW, spec_k=SPEC_K)
# the journal's crash lands after this many steps of the second burst
DURABLE_CRASH_AFTER = 6


def durable_requests(vocab: int, pass_i: int) -> list:
    """The 8 serving requests of ``SERVE_WAVES["gpt"]`` as ``serve_run``
    draws pass ``pass_i``'s: ``(prompt, sampling, wave)``, 32 new tokens
    each.  Passes 2 and up are the first wave's lengths and samplings
    with no shared prefix: pass 2 the 4 requests queued behind the
    quarantine, pass 3's third (700 tokens, seeded) the no-nvcc child's
    request."""
    import numpy as np
    from paddle_tpu_torch.serving import SamplingParams
    rs = np.random.RandomState(7 + 100 * pass_i)
    prefix = rs.randint(0, vocab, (512,))
    out = []
    waves = SERVE_WAVES["gpt"] if pass_i < 2 else SERVE_WAVES["gpt"][:1]
    for wave_i, wave in enumerate(waves):
        for n, shared, seed in wave:
            shared = shared and pass_i < 2
            sp = SamplingParams() if seed is None else SamplingParams(
                do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                seed=seed)
            own = rs.randint(0, vocab, (n - 512 if shared else n,))
            out.append((np.concatenate([prefix, own]) if shared else own,
                        sp, wave_i))
    return out


def durable_serve(eng, requests, waves: bool = True, stop_after=None):
    """Serve ``requests`` on ``eng``: with ``waves`` the second wave is
    submitted once the first request has its first token (as
    ``serve_run``), else all at once.  ``stop_after`` steps stops early.
    Returns the request ids and the first decode and verify steps'
    logits (copies, as the step wrote them)."""
    core = eng.core
    first = {}
    dispatch = {"decode": core._decode_dispatch,
                "verify": core._verify_dispatch}

    def wrap(kind, buf):
        def call(*a):
            out = dispatch[kind](*a)
            if kind not in first:
                first[kind] = getattr(core, buf).clone()
            return out
        return call

    core._decode_dispatch = wrap("decode", "_logits")
    core._verify_dispatch = wrap("verify", "_verify_logits")
    rids = [eng.submit(p, max_new_tokens=32, sampling=sp)
            for p, sp, w in requests if not waves or w == 0]
    steps = 0
    try:
        if waves:
            while not eng.result(rids[0]).tokens:
                eng.step()
                steps += 1
            rids += [eng.submit(p, max_new_tokens=32, sampling=sp)
                     for p, sp, w in requests if w == 1]
        while eng.core.scheduler.has_work():
            if stop_after is not None and steps >= stop_after:
                break
            eng.step()
            steps += 1
            if steps > 600:
                raise AssertionError(f"serving did not drain: "
                                     f"{core.stall_snapshot()}")
    finally:
        del core._decode_dispatch, core._verify_dispatch
    return rids, first


def _ttft_ms(eng, rids) -> dict:
    import numpy as np
    t = [eng.result(r).ttft_s * 1e3 for r in rids]
    return {"p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99))}


def durable_child(pkg: str, store_dir: str, request: str) -> int:
    """``--durable-child``: a process whose ``PATH`` holds no ``nvcc``,
    with ``CUDA_HOME`` unset and the package copied to ``pkg`` with an
    empty kernel build directory.  It opens the store, builds the warm
    engine (which installs the store's libraries into that directory and
    captures every leg), serves the one request of ``request`` (a JSON
    file) and prints what it saw as the last line.  ``nvcc`` is replaced
    by a raise, so any compile fails the run."""
    sys.path.insert(0, pkg)
    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_6_7b
    from paddle_tpu_torch.serving import (AOTStore, SamplingParams,
                                          ServingEngine)

    def no_nvcc():
        raise RuntimeError("nvcc called in the no-compiler child")

    _build._nvcc = no_nvcc
    here = os.path.realpath(paddle_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(pkg)):
        raise AssertionError(f"imported {here}, not the copy in {pkg}")
    before = sorted(os.listdir(_build._BUILD))
    with open(request) as f:
        req = json.load(f)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    model = GPTForCausalLM(gpt3_6_7b(), device=DEVICE, generator=gen).eval()
    store = AOTStore.open(store_dir)
    try:
        t0 = time.perf_counter()
        eng = ServingEngine(model, **DURABLE_KW, aot_store=store)
        attach_s = time.perf_counter() - t0
        rid = eng.submit(np.asarray(req["prompt"]), max_new_tokens=32,
                         sampling=SamplingParams(**req["sampling"]))
        eng.run_until_complete(400)
        out = eng.result(rid)
        res = {"tokens": out.tokens, "status": out.status,
               "aot_status": eng.aot_status,
               "captures": dict(eng.core.capture_counts),
               "attach_s": attach_s,
               "build_dir_before": before,
               "build_dir_after": sorted(os.listdir(_build._BUILD)),
               "loaded": sorted(_build._loaded),
               "nvcc_on_path": [d for d in os.environ["PATH"].split(":")
                                if os.path.exists(os.path.join(d, "nvcc"))],
               "cuda_home": os.environ.get("CUDA_HOME")}
        eng.close()
    finally:
        store.close()
    print(json.dumps(res), flush=True)
    return 0


def durable_quarantine(eng, faults, vocab: int, queued_q):
    """A quarantine on ``eng``: 8 requests in flight and the 4 of
    ``queued_q`` queued behind them, then a ``step`` fault from the first
    step on, past the watchdog's retries.  The in-flight prompts are 16
    tokens, so that no n-gram draft is likely at their first tokens: a
    fault on a speculative step is the spec_verify rung's, not a retry
    toward the quarantine.  Returns the in-flight and queued ids and the
    rebuild's reading: seconds, the clock at its end, and the allocated
    memory before, at its peak and after."""
    import numpy as np
    import torch

    core = eng.core
    mem = {}
    rebuild = core._rebuild_device_plane

    def rebuild_device_plane():
        torch.cuda.synchronize()
        mem["before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rebuild()
        torch.cuda.synchronize()
        mem["end"] = time.perf_counter()
        mem["seconds"] = mem["end"] - t
        mem["peak"] = torch.cuda.max_memory_allocated()
        mem["after"] = torch.cuda.memory_allocated()

    core._rebuild_device_plane = rebuild_device_plane
    rs = np.random.RandomState(31)
    inflight = [eng.submit(rs.randint(0, vocab, (16,)), max_new_tokens=32)
                for _ in range(8)]
    queued = [eng.submit(p, max_new_tokens=32, sampling=sp)
              for p, sp, _ in queued_q]
    # from the first pass: a live slot then holds its first token only,
    # and a greedy random model drafts once it repeats a token
    faults.enable("step", at=0, times=core.ft.max_step_retries + 1)
    try:
        eng.run_until_complete(600)
    finally:
        faults.disable("step")
        del core._rebuild_device_plane
    return inflight, queued, mem


def phase_serving_durable(card: str) -> dict:
    """The journal and the AOT store on one gpt3_6_7b model at full width
    and depth (random bf16 weights from a seeded generator, ``DURABLE_KW``:
    unfused, ``spec_k=4``), one engine at a time:

      1. cold: an engine without a store serves the 8 serving requests
         (capturing each graph at first use);
      2. build: ``build_engine_store`` on a build engine captures every
         leg and stores the libraries they launched; the build engine, now
         holding every graph, serves the 8 requests and then 8 more (a
         second pass's prompts, all at once) with no journal;
      3. warm: an engine on ``AOTStore.open`` with a ``Journal``: status
         ``"warm"``, ``aot.loads`` one a committed width + decode +
         verify, the attach's launches 2 a leg (its eager run and its
         capture), ``capture_counts`` zero and no launch while it serves,
         tokens equal to the cold engine's and the build engine's, first decode
         and verify logits bit-identical to the cold engine's; the ledger
         conserved; then the second pass, its journal crashed after
         ``DURABLE_CRASH_AFTER`` steps;
      4. replay: the journal reopened, a fresh warm engine (watchdog,
         injector) takes ids past the old ones and serves the ``replay()``
         records: each stream, positions below the journaled mark dropped,
         completes the first incarnation's into the uninterrupted run's;
         then a ``step`` fault quarantines it: the rebuild re-attaches
         with no capture, the queued requests equal the fault-free run's,
         the journal holds one terminal for each failed request; then the
         same quarantine on an engine without a store, whose queued
         requests capture their graphs at first use;
      5. no nvcc: a child process with no compiler and an empty build
         directory attaches the store and serves one request with the
         parent's tokens.

    Prints attach seconds, the graph pool, first-pass TTFT warm against
    cold, the rebuild's seconds and peak memory, the queued requests' TTFT
    after the quarantine with and without a store, and the store's
    size."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_6_7b
    from paddle_tpu_torch.serving import (AOTStore, FaultInjector,
                                          FaultToleranceConfig, Journal,
                                          SamplingParams, ServingEngine,
                                          build_engine_store)

    tag = "[serving:durable]"
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    model = GPTForCausalLM(gpt3_6_7b(), device=DEVICE, generator=gen).eval()
    cfg = model.cfg
    layers = cfg.num_layers
    pass_a, pass_b, queued_q = (durable_requests(cfg.vocab_size, i)
                                for i in range(3))
    child_req = durable_requests(cfg.vocab_size, 3)[2:3]
    kernels = serving_kernels()
    root = tempfile.mkdtemp(prefix="durable-", dir=str(_build._BUILD))
    store_dir, journal_dir = (os.path.join(root, d)
                              for d in ("store", "journal"))
    out = {}
    try:
        # 1. cold
        eng = ServingEngine(model, **DURABLE_KW)
        rids, cold_first = durable_serve(eng, pass_a)
        cold = [eng.result(r).tokens for r in rids]
        cold_caps = dict(eng.core.capture_counts)
        out["cold_ttft_ms"] = _ttft_ms(eng, rids)
        eng.close()
        _chaos_check(tag, cold_caps["prefill"] > 0 and cold_caps["decode"] == 1
               and cold_caps["verify"] == 1, f"cold captures {cold_caps}")

        # 2. build, then the build engine serves, uninterrupted, the no-nvcc
        # child's request alone and the 4 requests the quarantine will
        # queue together, each as that engine will serve it (a
        # speculative engine's tokens follow its batches: a verify step
        # runs where any slot drafts), then both passes
        eng = ServingEngine(model, **DURABLE_KW)
        t0 = time.perf_counter()
        index = build_engine_store(store_dir, eng.core)
        out["build_s"] = time.perf_counter() - t0
        rids, _ = durable_serve(eng, child_req, waves=False)
        child_want = eng.result(rids[0]).tokens
        rids, _ = durable_serve(eng, queued_q, waves=False)
        queued_want = [eng.result(r).tokens for r in rids]
        rids, _ = durable_serve(eng, pass_a)
        built = [eng.result(r).tokens for r in rids]
        rids, _ = durable_serve(eng, pass_b, waves=False)
        uninterrupted = [eng.result(r).tokens for r in rids]
        built_caps = dict(eng.core.capture_counts)
        eng.close()
        n_legs = len(index["programs"])
        _chaos_check(tag, built == cold, "the build engine's tokens differ from the "
               "cold engine's")
        _chaos_check(tag, built_caps == dict(prefill=0, decode=0, verify=0),
               f"the build engine captured on the request path: {built_caps}")

        # 3. warm, with a journal
        free_card()
        store = AOTStore.open(store_dir)
        out["store_mb"] = store.nbytes() / 1e6
        out["store_libraries"] = sorted(store.libraries())
        journal = Journal.open(journal_dir)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        alloc0 = torch.cuda.memory_allocated()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng = ServingEngine(model, **DURABLE_KW, aot_store=store,
                            journal=journal)
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        core = eng.core
        attach = {k.__name__: k.launches for k in kernels}
        reg = eng.registry
        widths = len(core._warm_buckets)
        out.update(
            widths=widths, legs=n_legs, construct_s=construct_s,
            attach_s=reg.get("aot.load_s").value,
            aot_loads=reg.get("aot.loads").value,
            pool_gb=pool_gb(core._graph_pool),
            plane_gb=(torch.cuda.memory_allocated() - alloc0) / 1e9,
            reserved_gb=(torch.cuda.memory_reserved() - reserved0) / 1e9,
            card_used_gb=(free0 - torch.cuda.mem_get_info()[0]) / 1e9)
        _chaos_check(tag, eng.aot_status == "warm" and widths == 128
               and out["aot_loads"] == widths + 2 == n_legs,
               f"aot_status {eng.aot_status}, loads {out['aot_loads']}, "
               f"widths {widths}, legs {n_legs}")
        want = {k.__name__: 0 for k in kernels}
        want["decode_attention"] = layers * 2 * n_legs
        want["layer_norm_fwd"] = (2 * layers + 1) * 2 * n_legs
        _chaos_check(tag, attach == want, f"attach launches {attach} != {want}")
        for k in kernels:
            k.launches = 0
        rids, warm_first = durable_serve(eng, pass_a)
        warm = [eng.result(r).tokens for r in rids]
        served = {k.__name__: k.launches for k in kernels}
        out["warm_ttft_ms"] = _ttft_ms(eng, rids)
        _chaos_check(tag, dict(core.capture_counts) == built_caps
               and reg.get("serving.compiles").value == 0,
               f"warm captures {core.capture_counts}")
        _chaos_check(tag, not any(served.values()),
               f"launches while the warm engine served: {served}")
        _chaos_check(tag, warm == cold, "warm tokens differ from the cold "
               "engine's")
        same_logits = {k: torch.equal(warm_first[k], cold_first[k])
                       for k in cold_first}
        _chaos_check(tag, set(same_logits) == {"decode", "verify"}
               and all(same_logits.values()),
               f"first-step logits bit-identical: {same_logits}")
        ledger = journal.ledger()
        conserved = all(ledger[r]["submits"] == ledger[r]["terminals"] == 1
                        and ledger[r]["delivered"] == len(warm[i])
                        and ledger[r]["status"] == "finished"
                        for i, r in enumerate(rids))
        _chaos_check(tag, conserved and len(ledger) == len(rids),
               f"ledger {ledger}")
        log(f"{tag} cold {json.dumps(cold_caps)} captures on the request "
            f"path; build of {n_legs} legs ({widths} prefill widths, "
            f"decode, verify) {out['build_s']:.2f} s, store "
            f"{out['store_mb']:.2f} MB with libraries "
            f"{out['store_libraries']}; warm engine constructed in "
            f"{construct_s:.2f} s (attach {out['attach_s']:.2f} s, "
            f"aot.loads {out['aot_loads']}), graph pool {out['pool_gb']} "
            f"GB, allocated {out['plane_gb']:.3f} GB, reserved by the "
            f"allocator {out['reserved_gb']:.3f} GB, card memory used "
            f"{out['card_used_gb']:.3f} GB by the construction (the rest "
            f"outside the allocator: the instantiated graphs); "
            f"first-pass TTFT p50 / p99 warm {out['warm_ttft_ms']['p50']:.1f}"
            f" / {out['warm_ttft_ms']['p99']:.1f} ms vs cold "
            f"{out['cold_ttft_ms']['p50']:.1f} / "
            f"{out['cold_ttft_ms']['p99']:.1f} ms; warm captures "
            f"{json.dumps(dict(core.capture_counts))}, no launch while "
            f"serving, 8 of 8 requests and the first decode / verify "
            f"logits equal the cold engine's; journal ledger conserved "
            f"(card: {card})")

        # the second pass, crashed mid-burst
        rids_b, _ = durable_serve(eng, pass_b, waves=False,
                                  stop_after=DURABLE_CRASH_AFTER)
        seen = {r: list(eng.result(r).tokens) for r in rids_b}
        journal.crash()
        eng.close()
        eng = core = None
        journal = Journal.open(journal_dir)
        replay = journal.replay()
        old_max = max(journal.state)
        _chaos_check(tag, replay and set(replay) <= set(rids_b),
               f"replay ids {sorted(replay)} of {rids_b}")

        # 4. replay on a fresh warm engine, then a quarantine on it
        faults = FaultInjector()
        eng = ServingEngine(model, **DURABLE_KW, aot_store=store,
                            journal=journal, faults=faults,
                            fault_tolerance=FaultToleranceConfig(
                                backoff_base_s=0.0))
        core = eng.core
        new_ids, merged = {}, {}
        for old in sorted(replay):
            rec = replay[old]["record"]
            new_ids[old] = eng.submit(
                rec["prompt"], max_new_tokens=rec["max_new_tokens"],
                sampling=SamplingParams(**rec["sampling"]),
                eos_token_id=rec["eos_token_id"])
        _chaos_check(tag, min(new_ids.values()) > old_max,
               f"new ids {sorted(new_ids.values())} not past {old_max}")
        eng.run_until_complete(600)
        for old, new in new_ids.items():
            mark = replay[old]["delivered"]
            again = eng.result(new).tokens
            want_b = uninterrupted[rids_b.index(old)]
            _chaos_check(tag, seen[old][:mark] == want_b[:mark]
                   and again[:mark] == want_b[:mark],
                   f"request {old}: the replay's first {mark} positions")
            merged[old] = seen[old][:mark] + again[mark:]
            _chaos_check(tag, merged[old] == want_b,
                   f"request {old}: merged stream differs from the "
                   f"uninterrupted run")
        done_b = [r for r in rids_b if r not in replay]
        _chaos_check(tag, all(seen[r] == uninterrupted[rids_b.index(r)]
                        for r in done_b),
               "a request settled before the crash differs")
        out["replay"] = {"settled_before_crash": len(done_b),
                         "replayed": len(replay),
                         "marks": {int(o): replay[o]["delivered"]
                                   for o in replay},
                         "seen_at_crash": {int(o): len(seen[o])
                                           for o in replay}}
        log(f"{tag} journal crashed after {DURABLE_CRASH_AFTER} steps of "
            f"the second pass: {len(done_b)} requests settled, "
            f"{len(replay)} replayed on a fresh warm engine (ids from "
            f"{min(new_ids.values())}, past {old_max}); journaled marks "
            f"{json.dumps(out['replay']['marks'])} of tokens seen "
            f"{json.dumps(out['replay']['seen_at_crash'])}; every stream, "
            f"positions below its mark dropped, completes the first "
            f"incarnation's into the uninterrupted run's (card: {card})")

        loads0 = eng.registry.get("aot.loads").value
        inflight, queued, mem = durable_quarantine(eng, faults, cfg.vocab_size,
                                                   queued_q)
        retries = core.ft.max_step_retries
        m = eng.metrics_dict()
        ledger = journal.ledger()
        _chaos_check(tag, m["quarantines"] == 1 and "seconds" in mem
               and not eng.degraded_subsystems,
               f"metrics {m}, degraded {eng.degraded_subsystems}")
        q_ttft = [eng.result(r).ttft_s * 1e3 for r in queued]
        after_rebuild = [(eng._requests[r].first_token_time - mem["end"])
                         * 1e3 for r in queued]
        _chaos_check(tag, eng.aot_status == "warm" and eng.registry.get(
            "aot.loads").value == loads0 + n_legs
               and dict(core.capture_counts) == built_caps,
               f"re-attach: {eng.aot_status}, loads "
               f"{eng.registry.get('aot.loads').value}, captures "
               f"{core.capture_counts}")
        _chaos_check(tag, all(eng.result(r).status == "failed" for r in inflight),
               "in-flight requests not failed")
        _chaos_check(tag, [eng.result(r).tokens for r in queued] == queued_want,
               "queued requests differ from the fault-free run")
        _chaos_check(tag, all(ledger[r]["terminals"] == 1
                        and ledger[r]["status"] == "failed"
                        for r in inflight)
               and all(ledger[r]["submits"] == ledger[r]["terminals"] == 1
                       for r in inflight + queued + list(new_ids.values())),
               "journal terminals after the quarantine")
        out["quarantine"] = {
            "rebuild_s": mem["seconds"],
            **{f"{k}_gb": mem[k] / 1e9 for k in ("before", "peak",
                                                 "after")},
            "queued_ttft_ms": q_ttft,
            "queued_first_token_after_rebuild_ms": after_rebuild}
        log(f"{tag} quarantine after {retries} retries: 8 in flight failed"
            f" (one terminal record each), 4 queued equal the fault-free "
            f"run; rebuild with re-attach {mem['seconds']:.2f} s, memory "
            f"before {mem['before'] / 1e9:.3f} GB, peak "
            f"{mem['peak'] / 1e9:.3f} GB, after {mem['after'] / 1e9:.3f}"
            f" GB; captures {json.dumps(dict(core.capture_counts))}; "
            f"queued TTFT {[round(t, 1) for t in q_ttft]} ms, first token "
            f"{[round(t, 1) for t in after_rebuild]} ms after the rebuild"
            f" (card: {card})")
        eng.close()
        eng = core = None
        journal.close()
        store.close()

        # the same quarantine on an engine without a store: the same
        # settings, requests and fault; its rebuild attaches nothing, and
        # the queued requests capture each graph they need at first use
        free_card()
        faults = FaultInjector()
        journal = Journal.open(os.path.join(root, "journal-no-store"))
        eng = ServingEngine(model, **DURABLE_KW, journal=journal,
                            faults=faults,
                            fault_tolerance=FaultToleranceConfig(
                                backoff_base_s=0.0))
        inflight, queued, mem = durable_quarantine(eng, faults,
                                                   cfg.vocab_size, queued_q)
        m = eng.metrics_dict()
        _chaos_check(tag, m["quarantines"] == 1 and "seconds" in mem
                     and not eng.degraded_subsystems,
                     f"no store: metrics {m}, degraded "
                     f"{eng.degraded_subsystems}")
        _chaos_check(tag, all(eng.result(r).status == "failed"
                              for r in inflight)
                     and [eng.result(r).tokens for r in queued]
                     == queued_want,
                     "no store: in-flight requests not failed, or queued "
                     "requests differ from the fault-free run")
        caps = dict(eng.core.capture_counts)
        out["quarantine_no_store"] = {
            "rebuild_s": mem["seconds"],
            "queued_ttft_ms": [eng.result(r).ttft_s * 1e3 for r in queued],
            "queued_first_token_after_rebuild_ms": [
                (eng._requests[r].first_token_time - mem["end"]) * 1e3
                for r in queued],
            "captures": caps}
        q = out["quarantine_no_store"]
        log(f"{tag} the same quarantine without a store: rebuild "
            f"{mem['seconds']:.3f} s, then {json.dumps(caps)} captures at "
            f"first use; queued TTFT "
            f"{[round(t, 1) for t in q['queued_ttft_ms']]} ms, first token "
            f"{[round(t, 1) for t in q['queued_first_token_after_rebuild_ms']]}"
            f" ms after the rebuild; queued requests equal the fault-free "
            f"run (card: {card})")
        eng.close()
        eng = None
        journal.close()

        # 5. no nvcc: a child with no compiler and an empty build directory
        free_card()
        pkg = os.path.join(root, "pkg")
        shutil.copytree(os.path.join(HERE, "paddle_tpu_torch"),
                        os.path.join(pkg, "paddle_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        os.mkdir(os.path.join(pkg, "paddle_tpu_torch", "kernels", "_build"))
        prompt, sp, _ = child_req[0]
        request = os.path.join(root, "request.json")
        with open(request, "w") as f:
            json.dump({"prompt": [int(t) for t in prompt],
                       "sampling": {k: getattr(sp, k) for k in (
                           "do_sample", "temperature", "top_k", "top_p",
                           "seed")}}, f)
        env = {k: v for k, v in os.environ.items()
               if k not in ("CUDA_HOME", "CUDA_PATH")}
        env["PATH"] = ":".join(
            d for d in env.get("PATH", "").split(":")
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--durable-child", pkg, store_dir, request],
            env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{tag} the no-nvcc child failed "
                                 f"({proc.returncode}): {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        libs = sorted(f for f in child["build_dir_after"]
                      if f.endswith(".so"))
        _chaos_check(tag, child["tokens"] == child_want
               and child["aot_status"] == "warm"
               and child["captures"] == built_caps
               and child["build_dir_before"] == []
               and len(libs) == len(out["store_libraries"])
               and not child["nvcc_on_path"] and child["cuda_home"] is None,
               f"child {child}")
        out["child"] = {"seconds": child_s, "attach_s": child["attach_s"],
                        "installed": libs}
        log(f"{tag} no-nvcc child (PATH without nvcc, CUDA_HOME unset, "
            f"nvcc replaced by a raise, empty build directory): installed "
            f"{libs}, attached in {child['attach_s']:.2f} s, served 1 "
            f"request equal to the parent's; {child_s:.1f} s in all "
            f"(card: {card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches_attach"] = attach
    return out


# ------------------------------------------------------- serving:fleet
# the fleet's traffic: a 512-token system prompt with varied tails (prefix
# affinity); long prompts, handed off in the disaggregated fleet (the
# blocks before the prefill's last 512-token chunk move, and the decode
# replica runs that chunk again), and short ones, routed direct
FLEET_NEW = 16
FLEET_PREFIX = 512
FLEET_TAILS = (40, 88, 136, 184, 232, 280)
FLEET_LONG = (1030, 1036, 1040, 1536)
FLEET_SHORT = (96, 200, 300)
FLEET_THRESHOLD = 1024
# the straggler: replica 0 sleeps this long inside each of its timed steps
# for this many fleet steps, against requests of this deadline and length
FLEET_SLOW_S, FLEET_SLOW_STEPS = 0.3, 10
FLEET_DEADLINE_S, FLEET_SLOW_NEW = 5.0, 32
FLEET_SITES = ("handoff_gather", "handoff_scatter", "handoff_commit")


def fleet_traffic(vocab: int) -> dict:
    """Every request of the phase, by name: ``(prompt, max_new_tokens)``,
    drawn from seeded generators."""
    import numpy as np
    rs = np.random.RandomState(19)
    prefix = rs.randint(0, vocab, (FLEET_PREFIX,))
    out = {f"tail{i}": (np.concatenate([prefix, rs.randint(0, vocab, (n,))]),
                        FLEET_NEW) for i, n in enumerate(FLEET_TAILS)}
    for wave in ("b1", "b2"):
        for i, n in enumerate(FLEET_LONG):
            out[f"{wave}_long{i}"] = (rs.randint(0, vocab, (n,)), FLEET_NEW)
        for i, n in enumerate(FLEET_SHORT):
            out[f"{wave}_short{i}"] = (rs.randint(0, vocab, (n,)), FLEET_NEW)
    for site in FLEET_SITES:
        out[site] = (rs.randint(0, vocab, (1033,)), FLEET_NEW)
    for i in range(2):
        out[f"slow{i}"] = (rs.randint(0, vocab, (128,)), FLEET_SLOW_NEW)
    for i in range(4):
        out[f"kill{i}"] = (rs.randint(0, vocab, (160 + 32 * i,)), FLEET_NEW)
    for i in range(3):
        out[f"scale{i}"] = (rs.randint(0, vocab, (144,)), FLEET_NEW)
    return out


class FleetClient:
    """The client side of a router's requests: each request's submit time,
    first-token time and every token its stream delivered."""

    def __init__(self, router, traffic: dict):
        self.router, self.traffic = router, traffic
        self.fids, self.sub, self.first, self.seen = {}, {}, {}, {}

    def submit(self, key: str, **kw) -> int:
        prompt, new = self.traffic[key]
        self.seen[key] = []

        def stream(req, tok):
            self.first.setdefault(key, time.perf_counter())
            self.seen[key].append(int(tok))
        self.sub[key] = time.perf_counter()
        self.fids[key] = self.router.submit(prompt, max_new_tokens=new,
                                            stream=stream, **kw)
        return self.fids[key]

    def replica(self, key: str) -> int:
        return self.router._requests[self.fids[key]].replica

    def ttft_ms(self, keys) -> list:
        return [(self.first[k] - self.sub[k]) * 1e3 for k in keys]

    def check(self, tag: str, want: dict, keys) -> None:
        """Each request finished with the single engine's greedy tokens,
        and its stream delivered each of them once."""
        for k in keys:
            out = self.router.result(self.fids[k])
            _chaos_check(tag, out.status == "finished"
                         and list(out.tokens) == want[k]
                         and self.seen[k] == want[k],
                         f"{k}: {out.status} ({out.status_reason}), tokens "
                         f"{list(out.tokens)}, streamed {self.seen[k]}, "
                         f"single engine {want[k]}")


def fleet_captures(router) -> list:
    return [dict(h.engine.core.capture_counts) for h in router.replicas]


def timed_handoffs(router, bytes_per_token: int, records: list) -> None:
    """Time every transfer attempt of ``router``'s KV handoffs (the card
    synchronized on both sides) and hold each to its promise: no replica
    captures a graph for it."""
    import torch
    mgr = router._handoffs
    transfer = mgr.transfer

    def run(rec, src, dst, prompt):
        caps = fleet_captures(router)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = transfer(rec, src, dst, prompt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if fleet_captures(router) != caps:
            raise AssertionError(
                f"[serving:fleet] a handoff captured a graph: {caps} -> "
                f"{fleet_captures(router)}")
        nbytes = rec.tokens * bytes_per_token
        records.append({"fleet_id": rec.fleet_id, "ms": ms,
                        "tokens": rec.tokens, "blocks": rec.blocks_moved,
                        "bytes": nbytes, "ok": ok,
                        # the gather reads and writes the tokens' K/V once,
                        # the radix insert's scatter again
                        "bound_ms": 4 * nbytes / HBM_BYTES_PER_S * 1e3})
        return ok
    mgr.transfer = run


def phase_serving_fleet(card: str) -> dict:
    """The fleet tier at gpt3_6_7b width and depth (random bf16 weights
    from a seeded generator), every replica ``ENGINE_KW``, unfused, the
    watchdog with no backoff sleep, all sharing the one model:

      0. one engine serves every request of the phase (``fleet_traffic``)
         in the fleet's order: the greedy tokens every fleet request is
         held to;
      1. a unified fleet of two replicas (``Router.build``): the system
         prompt's first request, then its tails, which affinity lands on
         the warmed replica; two waves of long and short prompts (TTFT);
         ``replica_slow`` stretches replica 0's steps: it is marked slow
         and the deadline-at-risk request there is hedged once, the race
         resolved; a ``kill`` of replica 1 mid-decode re-attributes its
         requests, each stream delivering every token once; an
         ``Autoscaler`` spawns its replacement behind a warm-up gate (the
         dead replica's memory returned first), the spawned replica
         serves, then retires through drain once the fleet idles;
      2. a disaggregated fleet (one ``prefill``, one ``decode`` replica,
         ``prefill_threshold`` 1024): the same two waves, each long prompt
         prefilled on the prefill replica and its blocks handed off to the
         decode replica (each transfer timed; no replica captures a graph
         for it), the short ones direct; then one injection each of
         ``handoff_gather``, ``handoff_scatter`` and ``handoff_commit``.
         ``fleet_accounting`` reads baseline on both replicas and the
         handoff ledger conserves.

    The serving kernels' counts are zeroed before step 1 and read after
    step 2.  Prints each handoff's ms and bytes, the long prompts' TTFT
    p50 through either fleet, the memory each replica adds beside the
    shared weights, the peak, and each replica's capture counts."""
    import statistics

    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_6_7b
    from paddle_tpu_torch.serving import (Autoscaler, FaultInjector,
                                          FaultToleranceConfig, Router,
                                          ServingEngine, fleet_accounting)

    tag = "[serving:fleet]"
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    model = GPTForCausalLM(gpt3_6_7b(), device=DEVICE, generator=gen).eval()
    cfg = model.cfg
    kv_heads = getattr(cfg, "kv_heads", None) or cfg.num_heads
    bytes_per_token = (cfg.num_layers * 2 * kv_heads * cfg.head_dim
                       * model.dtype.itemsize)
    traffic = fleet_traffic(cfg.vocab_size)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    ft = FaultToleranceConfig(backoff_base_s=0.0)
    out = {"weights_gb": weights_gb}

    # 0. the single engine, in the fleet's order: the system prompt's first
    # request alone, so the tails find it cached as on the warmed replica
    eng = ServingEngine(model, **ENGINE_KW)
    want = {}
    for group in (["tail0"], [k for k in traffic if k != "tail0"]):
        rids = {k: eng.submit(traffic[k][0], max_new_tokens=traffic[k][1])
                for k in group}
        eng.run_until_complete(4000)
        want.update({k: list(eng.result(r).tokens) for k, r in rids.items()})
    eng.close()
    eng = None
    free_card()

    kernels = serving_kernels()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # 1. the unified fleet
    before = torch.cuda.memory_allocated()
    fi = FaultInjector()
    # the straggler detector stays off while the waves capture their
    # graphs (a capture's step would read as a straggler's), on for the
    # straggler
    router = Router.build(lambda: model, replicas=2, faults=fi,
                          slow_threshold=1e9, slow_hysteresis=2,
                          fault_tolerance=ft, **ENGINE_KW)
    out["replica_gb"] = (torch.cuda.memory_allocated() - before) / 2 / 1e9
    c = FleetClient(router, traffic)
    c.submit("tail0")
    router.run_until_complete(4000)
    tails = [f"tail{i}" for i in range(1, len(FLEET_TAILS))]
    for k in tails:
        c.submit(k)
    router.run_until_complete(4000)
    warm = c.replica("tail0")
    _chaos_check(tag, all(c.replica(k) == warm for k in tails),
                 f"tails off the warmed replica {warm}: "
                 f"{[c.replica(k) for k in tails]}")
    hit = router.metrics_dict()["prefix_hit_tokens"]
    _chaos_check(tag, hit >= FLEET_PREFIX * len(tails),
                 f"router prefix hit tokens {hit}")
    c.check(tag, want, ["tail0", *tails])
    log(f"{tag} unified: the system prompt's {len(tails)} tails all landed "
        f"on replica {warm}, which had cached it ({hit} prefix hit tokens); "
        f"each replica adds {out['replica_gb']:.3f} GB beside the "
        f"{weights_gb:.3f} GB of shared weights (card: {card})")
    long_keys = {w: [f"{w}_long{i}" for i in range(len(FLEET_LONG))]
                 for w in ("b1", "b2")}
    waves = {w: [*long_keys[w], *(f"{w}_short{i}"
                                  for i in range(len(FLEET_SHORT)))]
             for w in ("b1", "b2")}
    ttft = {}
    for w, keys in waves.items():
        for k in keys:
            c.submit(k)
        router.run_until_complete(4000)
        c.check(tag, want, keys)
        ttft[f"unified_{w}"] = c.ttft_ms(long_keys[w])

    # the straggler and its hedge
    router.slow_threshold = 3.0
    fi.enable("replica_slow", times=FLEET_SLOW_STEPS, seconds=FLEET_SLOW_S)
    try:
        for k in ("slow0", "slow1"):
            c.submit(k, deadline_s=FLEET_DEADLINE_S)
        router.run_until_complete(4000)
    finally:
        fi.disable("replica_slow")
    marked = [e[3]["replica"] for e in router.tracer.events("straggler_mark")]
    fr = router._requests[c.fids["slow0"]]
    m = router.metrics_dict()
    _chaos_check(tag, marked[:1] == [0] and fr.hedged and fr.hedge_rid < 0
                 and m["hedges"] == 1 and m["hedges_failed"] == 0
                 and [c.replica(k) for k in ("slow0", "slow1")]
                 in ([0, 1], [1, 1]),
                 f"straggler: marked {marked}, hedges {m['hedges']}, "
                 f"failed {m['hedges_failed']}, wins {m['hedge_wins']}")
    c.check(tag, want, ["slow0", "slow1"])
    out["straggler"] = {"marked": marked, "hedges": m["hedges"],
                        "hedge_wins": m["hedge_wins"],
                        "ewma_s": [round(h.step_ewma_s, 4)
                                   for h in router.replicas]}
    log(f"{tag} replica_slow ({FLEET_SLOW_S} s in each of {FLEET_SLOW_STEPS} "
        f"steps of replica 0): marked slow {marked}, 1 hedge issued and "
        f"resolved ({'the hedge' if m['hedge_wins'] else 'the primary'} "
        f"finished first), tokens equal (card: {card})")

    # a kill mid-decode
    keys = [f"kill{i}" for i in range(4)]
    for k in keys:
        c.submit(k)
    while min(len(c.seen[k]) for k in keys) < 3:
        router.step()
    victim = 1
    moved = [k for k in keys if c.replica(k) == victim]
    delivered = {k: len(c.seen[k]) for k in moved}
    n = router.kill(victim)
    router.run_until_complete(4000)
    c.check(tag, want, keys)
    _chaos_check(tag, n == len(moved) > 0
                 and all(c.replica(k) == 0 for k in keys),
                 f"kill: {n} re-attributed of {moved}")
    out["kill"] = {"reattributed": n, "delivered_before": delivered}
    log(f"{tag} kill of replica {victim} mid-decode: {n} requests "
        f"re-attributed to replica 0 after {delivered} tokens, every "
        f"stream delivered each token once, tokens equal (card: {card})")
    # a dead process's memory returns to the card
    router.replicas[victim].engine.close()
    free_card()

    # the autoscaler: the killed replica's replacement behind the gate,
    # then its retirement once the fleet idles
    warmed = {}

    def warmup(e):
        warmed["tokens"] = e.serve_batch([traffic["scale0"][0]],
                                         max_new_tokens=FLEET_NEW)[0].tokens

    scaler = Autoscaler(
        router, lambda: ServingEngine(model, registry=router.registry,
                                      tracer=router.tracer,
                                      fault_tolerance=ft, **ENGINE_KW),
        warmup_fn=warmup, max_decode=2, hysteresis_steps=2,
        cooldown_steps=2)
    router.step()
    spawned = len(router.replicas) - 1
    _chaos_check(tag, spawned == 2 and warmed.get("tokens") == want["scale0"],
                 f"autoscaler: replicas {router.replicas}, warm-up "
                 f"{warmed}")
    for k in ("scale1", "scale2"):
        c.submit(k)
    _chaos_check(tag, c.replica("scale2") == spawned,
                 f"the spawned replica took no request: "
                 f"{[c.replica(k) for k in ('scale1', 'scale2')]}")
    router.run_until_complete(4000)
    c.check(tag, want, ["scale1", "scale2"])
    for _ in range(16):
        if router.replicas[spawned].retired:
            break
        router.step()
    snap = scaler.snapshot()
    _chaos_check(tag, router.replicas[spawned].retired
                 and snap["spawns"] == 1 and snap["retires"] == 1,
                 f"autoscaler {snap}")
    acc = fleet_accounting(router)
    _chaos_check(tag, acc["ok"] and acc["killed_replicas"] == 1,
                 f"unified accounting {acc}")
    out["unified_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["unified_captures"] = fleet_captures(router)
    log(f"{tag} autoscaler: 1 spawn (the killed replica's replacement, "
        f"warm-up request equal), served a request, 1 retire through "
        f"drain; peak memory with two live replicas "
        f"{out['unified_peak_gb']:.3f} GB; capture counts by replica "
        f"{out['unified_captures']} (card: {card})")
    router.close()
    router = c = scaler = None
    free_card()

    # 2. the disaggregated fleet
    fi = FaultInjector()
    router = Router.build(lambda: model, replicas=2,
                          roles=("prefill", "decode"),
                          prefill_threshold=FLEET_THRESHOLD, faults=fi,
                          fault_tolerance=ft, **ENGINE_KW)
    handoffs = []
    timed_handoffs(router, bytes_per_token, handoffs)
    c = FleetClient(router, traffic)
    for w, keys in waves.items():
        for k in keys:
            c.submit(k)
        stages = {k: router._requests[c.fids[k]].role_stage for k in keys}
        _chaos_check(tag, all(stages[k] == "prefill" for k in long_keys[w])
                     and all(stages[k] == "decode" for k in keys
                             if k not in long_keys[w]),
                     f"disaggregated routing {stages}")
        router.run_until_complete(4000)
        c.check(tag, want, keys)
        ttft[f"disagg_{w}"] = c.ttft_ms(long_keys[w])
        chunk = ENGINE_KW["prefill_chunk"]
        for k in long_keys[w]:
            fr = router._requests[c.fids[k]]
            hit = router.result(c.fids[k]).prefix_hit_tokens
            _chaos_check(tag, fr.replica == 1 and fr.handoffs == 1
                         and hit == (len(traffic[k][0]) - 1) // chunk * chunk,
                         f"{k}: on replica {fr.replica} after "
                         f"{fr.handoffs} handoffs, decode-side hit {hit}")
    mgr = router._handoffs
    _chaos_check(tag, mgr.committed == len(handoffs) == 2 * len(FLEET_LONG)
                 and all(h["ok"] and h["blocks"] == h["tokens"]
                         // ENGINE_KW["block_len"] > 0 for h in handoffs),
                 f"handoffs {handoffs}, committed {mgr.committed}")
    for h in handoffs:
        log(f"{tag} handoff of fleet id {h['fleet_id']}: {h['tokens']} "
            f"tokens, {h['blocks']} blocks, {h['bytes'] / 1e6:.1f} MB of "
            f"K/V, {h['ms']:.3f} ms (bound {h['bound_ms']:.4f} ms) "
            f"(card: {card})")
    for w in ("b1", "b2"):
        u, d = (statistics.median(ttft[f"{s}_{w}"])
                for s in ("unified", "disagg"))
        log(f"{tag} TTFT p50 of the {len(FLEET_LONG)} long prompts, wave "
            f"{w}: disaggregated {d:.1f} ms, unified {u:.1f} ms (card: "
            f"{card})")
    # the three handoff sites, one injection each
    sites = {}
    for site in FLEET_SITES:
        ledger = (mgr.committed, mgr.aborted, mgr.retries)
        fi.enable(site)
        try:
            c.submit(site)
            router.run_until_complete(4000)
        finally:
            fi.disable(site)
        c.check(tag, want, [site])
        moved = [(mgr.committed, mgr.aborted, mgr.retries)[i] - ledger[i]
                 for i in range(3)]
        sites[site] = {"fired": fi.fired[site],
                       "committed": moved[0], "aborted": moved[1],
                       "retries": moved[2],
                       "attempts": [h["ok"] for h in handoffs
                                    if h["fleet_id"] == c.fids[site]]}
        # one gather or scatter fault retries to a commit; a commit fault
        # aborts with the blocks landed, and the request re-prefills
        _chaos_check(tag, fi.fired[site] == 1 and moved == (
            [0, 1, 0] if site == "handoff_commit" else [1, 0, 1]),
            f"{site}: {sites[site]}")
    acc = fleet_accounting(router)
    _chaos_check(tag, acc["ok"] and all(r["ok"] for r in acc["replicas"])
                 and acc["handoffs_staged"] == acc["handoffs_committed"]
                 + acc["handoffs_aborted"] and acc["handoffs_aborted"] == 1,
                 f"disaggregated accounting {acc}")
    out["disagg_captures"] = fleet_captures(router)
    log(f"{tag} injections {json.dumps(sites)}: every request finished "
        f"with the single engine's tokens; ledger staged "
        f"{acc['handoffs_staged']} = committed {acc['handoffs_committed']} "
        f"+ aborted {acc['handoffs_aborted']}; both replicas at baseline; "
        f"capture counts by replica {out['disagg_captures']} (card: {card})")
    router.close()
    router = c = None
    out["launches"] = {k.__name__: k.launches for k in kernels}
    for name in ("decode_attention", "layer_norm_fwd"):
        _chaos_check(tag, out["launches"][name] > 0,
                     f"{name} never launched: {out['launches']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["handoffs"] = handoffs
    out["ttft_ms"] = ttft
    out["sites"] = sites
    log(f"{tag} peak device memory {out['peak_gb']:.3f} GB with two "
        f"replicas (each {out['replica_gb']:.3f} GB) on "
        f"{weights_gb:.3f} GB of shared weights; launches "
        f"{json.dumps(out['launches'])} (card: {card})")
    model = None
    free_card()
    return out


def plan_widths(eng, served) -> set:
    """The distinct prefill chunk widths that requests ``served``
    (``(prompt length, prefix hit tokens)`` pairs) ran on ``eng``: their
    chunk plans, from the scheduler the engine used."""
    core = eng.core
    return {w for n, hit in served for _, w, _ in
            core.scheduler.chunk_plan(hit, n, core.prefill_chunk)}


def pool_gb(pool):
    """Device memory of the CUDA graph memory pool ``pool``, from the
    allocator's segments (None where the allocator does not name them)."""
    import torch
    segs = torch.cuda.memory_snapshot() if pool is not None else []
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(pool)) / 1e9


def serve_run(model, card: str, fused: bool, waves, tp: int = 1):
    """Serve the 8 requests of ``waves`` twice on ``model`` through the
    port's ServingEngine, with the fused decode-block path or the unfused
    decode step (at ``tp`` 2: the sharded decode-block kernels or the
    composed ring, both shards on the card); returns the kernel launch
    counts of the run and the metrics.  The first pass is cold (the
    engine captures its graphs), the second warm: fresh prompts and a
    fresh shared prefix, each pass's seeded by the pass, of the same
    lengths and sharing, so its chunk plans take the first pass's widths.
    Every launch count is set to 0 just before the run and read just
    after it.  The engine captures its decode step as one CUDA graph at
    the first decode step and its prefill chunk as one graph per chunk
    width at the first chunk of that width, and replays them after: the
    wrappers count the eager launches before each capture and the
    capture's, none of a replay's."""
    import gc

    import numpy as np
    import torch
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = model.cfg
    llama = hasattr(model, "llama")
    if tp == 1:
        path = "fused" if fused else "unfused"
        tp_kw = {}
    else:
        path = "tp_fused_block" if fused else "tp_fused"
        tp_kw = dict(tensor_parallel=tp, devices=TP_DEVICES[:tp])
    tag = f"[serving:{'llama' if llama else 'gpt'}:{path}]"
    eng = ServingEngine(model, fused_decode=fused, **tp_kw, **ENGINE_KW)
    if (eng.decode_path, eng.decode_fallback_reason) != (path, None):
        raise AssertionError(f"engine resolved decode_path "
                             f"{eng.decode_path!r} (reason "
                             f"{eng.decode_fallback_reason!r}), want {path!r}")

    wave1, wave2 = waves
    ids = {}
    step_ms = []

    def submit(wave, rs, prefix, pass_i):
        for n, shared, seed in wave:
            sp = SamplingParams() if seed is None else SamplingParams(
                do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                seed=seed)
            own = rs.randint(0, cfg.vocab_size, (n - 512 if shared else n,))
            rid = eng.submit(np.concatenate([prefix, own]) if shared
                             else own, max_new_tokens=32, sampling=sp)
            ids[rid] = (n, shared, seed, pass_i)

    def step():
        core = eng.core
        decode_only = not core._prefills and not core.scheduler.waiting
        t = time.perf_counter()
        left = eng.step()
        if decode_only:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return left

    kernels = serving_kernels()
    # where a slow capture's host time goes: each graph instantiation
    # (``capture_end``) and each garbage collection of the run, timed
    stalls = {"capture_end_ms": [], "gc_ms": []}
    capture_end = torch.cuda.CUDAGraph.capture_end

    def timed_capture_end(graph):
        t = time.perf_counter()
        capture_end(graph)
        stalls["capture_end_ms"].append((time.perf_counter() - t) * 1e3)

    def on_gc(phase, info, t0=[0.0]):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            stalls["gc_ms"].append((time.perf_counter() - t0[0]) * 1e3)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    torch.cuda.CUDAGraph.capture_end = timed_capture_end
    gc.callbacks.append(on_gc)
    t_run = time.perf_counter()
    try:
        for pass_i in range(2):
            # pass 0 draws the prompts every earlier run drew
            # (RandomState(7))
            rs = np.random.RandomState(7 + 100 * pass_i)
            prefix = rs.randint(0, cfg.vocab_size, (512,))
            first = len(ids)
            submit(wave1, rs, prefix, pass_i)
            # the second wave arrives once the first prefix holder has its
            # first token, so its prefix blocks are in the radix cache
            holder = list(ids)[first]
            while not eng.result(holder).tokens:
                step()
            submit(wave2, rs, prefix, pass_i)
            while step():
                pass
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.capture_end = capture_end
        gc.callbacks.remove(on_gc)
    run_s = time.perf_counter() - t_run
    launches = {k.__name__: k.launches for k in kernels}

    m = eng.metrics_dict()
    reg = eng.registry
    decode_steps = reg.get("serving.phase.decode_dispatch_s").count
    chunks = m["prefill_chunks"]
    layers = cfg.num_layers
    served = [(n, eng.result(rid).prefix_hit_tokens)
              for rid, (n, *_) in ids.items()]
    widths = plan_widths(eng, served)
    # the decode step is ONE CUDA graph, captured at the first decode step
    # (after that step's body ran eagerly) and replayed at every later
    # one; each prefill width likewise at its first chunk
    core = eng.core
    if hasattr(core, "capture_counts"):
        graph = check_graphed(eng, tag, widths)
        capture_s = core.capture_seconds["decode"]
        eager, captures = core.eager_decode_steps, \
            core.capture_counts["decode"]
    else:
        # a checkout from before the graph plane (``--serve-ab`` runs its
        # package): every decode step launches its kernels eagerly
        graph, eager, captures, capture_s = None, decode_steps, 0, None
    if hasattr(core, "eager_prefill_chunks"):
        prefill_passes = core.eager_prefill_chunks + \
            core.capture_counts["prefill"]
        prefill_capture_ms = {w: t * 1e3 for w, t in
                              sorted(core.prefill_capture_seconds.items())}
    else:
        # a checkout whose prefill chunks run eagerly
        prefill_passes, prefill_capture_ms = chunks, None
    # the wrappers count launches on the host: a graph's kernels launch in
    # the eager call before its capture and once into the graph at the
    # capture, never in a replay
    decode_passes = eager + captures
    # prefill chunks always run decode_attention and the model's norm
    # twice per layer plus the final one; decode passes run the same on
    # the unfused path, and the decode-block pair plus the final norm on
    # the fused one (the pair applies the layers' norms itself)
    unfused_passes = prefill_passes + (0 if fused else decode_passes)
    norm = "rms_norm_fwd" if llama else "layer_norm_fwd"
    want = {k.__name__: 0 for k in kernels}
    if tp == 1:
        want["decode_attention"] = layers * unfused_passes
        want["decode_block_attn"] = want["decode_block_mlp"] = \
            layers * decode_passes if fused else 0
        want[norm] = (2 * layers + 1) * unfused_passes + \
            (decode_passes if fused else 0)
    else:
        # every shard runs each layer: prefill chunks through the
        # Megatron body, decode passes through the sharded kernels (per
        # layer 2 entry and 2 exit seams of tp hops each) or the composed
        # ring with decode_attention; each shard's norms are the norm
        # kernel's, 2 per layer and the final one, every chunk and pass
        want["decode_attention"] = layers * tp * unfused_passes
        if fused:
            want["ring_entry_hop"] = want["ring_exit_hop"] = \
                layers * 2 * tp * tp * decode_passes
            want["decode_block_attn_tp"] = layers * tp * decode_passes
        want[norm] = (2 * layers + 1) * tp * (prefill_passes + decode_passes)
    per_width = {w: round(t, 1) for w, t in (prefill_capture_ms or {}).items()}
    log(f"{tag} {len(ids)} requests in 2 passes, {chunks} prefill chunks "
        f"of widths {sorted(widths)} ({prefill_passes} prefill passes: "
        f"eager before a capture, and the captures; capture ms per width "
        f"{json.dumps(per_width)}), "
        f"{decode_steps} decode steps ({eager} eager, {captures} capture "
        f"of {capture_s if capture_s is None else round(capture_s * 1e3, 1)}"
        f" ms on the host, {decode_steps - eager} replays of the graph), "
        f"{m['steps']} engine steps in {run_s:.2f} s; launches "
        f"{json.dumps(launches)} (want {layers} layers x prefill/decode "
        f"passes{f' x {tp} shards' if tp > 1 else ''}, {2 * layers + 1} "
        f"norms per unfused pass = {json.dumps(want)})")
    if launches != want:
        raise AssertionError(f"{tag} kernel launches {launches} != {want}: "
                             f"the main path bypassed a kernel")
    for rid, (n, shared, seed, pass_i) in ids.items():
        out = eng.result(rid)
        if not (out.finished and out.status == "finished"
                and len(out.tokens) == 32):
            raise AssertionError(f"{tag} request {rid} (len {n}) did not "
                                 f"finish with 32 tokens: {out}")
        if not all(0 <= t < cfg.vocab_size for t in out.tokens):
            raise AssertionError(f"{tag} request {rid} emitted an "
                                 f"out-of-vocab token: {out.tokens}")
        log(f"{tag} pass {pass_i} request {rid}: prompt {n}"
            f"{' (shared prefix)' if shared else ''}, "
            f"{'seed ' + str(seed) if seed is not None else 'greedy'}, "
            f"prefix hit {out.prefix_hit_tokens}, ttft "
            f"{out.ttft_s * 1e3:.1f} ms, first tokens {out.tokens[:6]}")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{tag} no prefix-cache hit in the serving run")
    decode_ms = float(np.median(step_ms)) if step_ms else None
    # the metrics' TTFT p50 is a quantile of log-spaced histogram buckets;
    # the exact medians of the run's 16 TTFTs, of the cold pass's 8 and of
    # the warm pass's 8 beside it
    ttft = {p: [eng.result(rid).ttft_s * 1e3 for rid, r in ids.items()
                if p is None or r[3] == p] for p in (None, 0, 1)}
    ttft_ms, cold_ms, warm_ms = (float(np.median(ttft[p]))
                                 for p in (None, 0, 1))
    res = {"decode_path": eng.decode_path, "tp": tp,
           "requests": len(ids), "prefill_chunks": chunks,
           "prefill_widths": sorted(widths),
           "prefill_passes": prefill_passes,
           "decode_steps": decode_steps, "steps": m["steps"],
           "run_s": run_s, "tokens_generated": m["tokens_generated"],
           "tokens_per_s": m["tokens_generated"] / run_s,
           "ttft_p50_ms": m["ttft_p50_ms"], "ttft_median_ms": ttft_ms,
           "ttft_cold_median_ms": cold_ms, "ttft_warm_median_ms": warm_ms,
           "decode_step_ms_p50": decode_ms,
           "decode_only_steps": len(step_ms),
           "prefix_hit_tokens": m["prefix_hit_tokens"],
           "decode_graph": graph, "capture_ms":
               None if capture_s is None else capture_s * 1e3,
           "prefill_capture_ms": prefill_capture_ms,
           "graph_pool_gb": pool_gb(getattr(core, "_graph_pool", None)),
           "capture_end_ms": stalls["capture_end_ms"],
           "gc_collections": len(stalls["gc_ms"]),
           "gc_max_ms": max(stalls["gc_ms"], default=0.0),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if fused:
        hist = reg.get("kernel.decode_block_s")
        if hist.count != decode_steps:
            raise AssertionError(f"{tag} kernel.decode_block_s has "
                                 f"{hist.count} samples, want {decode_steps}")
        res["decode_block_dispatch_ms_p50"] = hist.quantile(0.5) * 1e3
    log(f"{tag} {res['tokens_per_s']:.1f} tokens/s over the run, TTFT "
        f"p50 {m['ttft_p50_ms']} ms (median {ttft_ms:.2f}; cold pass "
        f"{cold_ms:.2f}, warm pass {warm_ms:.2f}), decode step p50 "
        f"{decode_ms if decode_ms is None else round(decode_ms, 3)} ms "
        f"({len(step_ms)} decode-only steps), prefix hit tokens "
        f"{m['prefix_hit_tokens']}, peak memory {res['peak_mem_gb']:.2f} GB "
        f"over the run, graph pool {res['graph_pool_gb']} GB; graph "
        f"instantiations (capture_end) "
        f"{[round(t, 1) for t in stalls['capture_end_ms']]} ms, "
        f"{res['gc_collections']} garbage collections (longest "
        f"{res['gc_max_ms']:.1f} ms) "
        f"(card: {card}{TP_NOTE if tp > 1 else ''})")
    res["decode_profile"] = profile_decode(eng, cfg.vocab_size, card,
                                           tag[len("[serving:"):-1])
    if tp == 1 and not fused:
        # one prompt as long as the run's longest: its last chunk is the
        # kernel phase's prefill shape
        res["prefill_profile"] = profile_prefill(
            eng, cfg.vocab_size, card, tag[len("[serving:"):-1],
            max(n for wave in waves for n, _, _ in wave))
    eng.close()
    return launches, res


def kernel_counts(prof) -> dict:
    """Calls by device-activity name (kernels, copies, fills) from a
    finished torch.profiler run."""
    import torch
    counts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[e.key] = counts.get(e.key, 0) + e.count
    return counts


def replay_checks(eng, card: str, label: str) -> dict:
    """On an engine whose slots all decode: its decode graph's replay
    against the same decode body run eagerly (on the capture stream, as
    the capture's warm-up ran it) from the same state.  A decode step
    reads the slabs' rows below each slot's position and overwrites the
    row at it, so restoring ``seq_pos`` and the last-token vector restores
    everything the step reads.  Checks: the logits bit-identical (or
    within ``row_reading``'s per-element limit, reported), ``seq_pos``
    advanced by one by both, the same kernels by name and count under
    torch.profiler; and times both with CUDA events (each call restores
    the state first).  The state is restored at the end."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.engine import _capture_stream
    core = eng.core
    pool = core.pool
    pos0, tok0 = pool.seq_pos.clone(), core._last_tok.clone()

    def restore():
        pool.seq_pos.copy_(pos0)
        core._last_tok.copy_(tok0)

    def eager():
        stream = _capture_stream(core.device)
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            core._decode_body()
        current.wait_stream(stream)

    def counted(fn):
        """Kernels by name and count of one call of ``fn`` under
        torch.profiler; the window opens with a small kernel and a sync,
        so that the call's first kernels are not lost to the tracer's
        start."""
        restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=pool.seq_pos.device).add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        return {k: n for k, n in kernel_counts(prof).items()
                if not k.startswith(("Memcpy", "Memset"))}

    tag = f"[graph:{label}]"
    runs = {}
    for name, fn in (("replay", core._decode_graph_step), ("eager", eager)):
        restore()
        fn()
        torch.cuda.synchronize()
        runs[name] = {"logits": core._logits.clone(),
                      "seq_pos": pool.seq_pos.clone(),
                      "counts": counted(fn)}

        def timed(fn=fn):
            restore()
            fn()
        runs[name]["ms"] = time_ms(timed, iters=5, warmup=2, windows=3)
    restore()
    torch.cuda.synchronize()
    lr, le = runs["replay"]["logits"], runs["eager"]["logits"]
    exact = torch.equal(lr, le)
    reading = row_reading(lr.to(core.model.dtype), le)
    for name, r in runs.items():
        if not torch.equal(r["seq_pos"], pos0 + 1):
            raise AssertionError(f"{tag} the {name} step did not advance "
                                 f"seq_pos by one")
    if not exact and reading > 1.0:
        raise AssertionError(f"{tag} a replayed decode step's logits differ "
                             f"from the eager body's beyond the per-element "
                             f"limit: row_reading {reading}")
    kernels = {name: r["counts"] for name, r in runs.items()}

    def differ():
        return {k[:90]: (kernels["replay"].get(k), kernels["eager"].get(k))
                for k in set(kernels["replay"]) | set(kernels["eager"])
                if kernels["replay"].get(k) != kernels["eager"].get(k)}
    seen = bool(kernels["replay"])
    lost = None
    if seen and differ():
        # the tracer can drop a window's records: one more window of each
        # before the counts count as different
        lost = differ()
        kernels = {"replay": counted(core._decode_graph_step),
                   "eager": counted(eager)}
        restore()
        log(f"{tag} a first profiled window of each differed (name: "
            f"(replay, eager)) {json.dumps(lost)}; profiled again")
    if seen and differ():
        raise AssertionError(f"{tag} the replayed step's kernels differ from "
                             f"one eager step of the same body (name: "
                             f"(replay, eager)): {differ()}")
    out = {"bit_identical": exact, "row_reading": reading,
           "kernels_seen_in_replay": seen,
           "kernel_launches": sum(kernels["eager"].values()),
           "kernel_names": len(kernels["eager"]),
           "first_window_differed": lost,
           "replay_ms": runs["replay"]["ms"], "eager_ms": runs["eager"]["ms"],
           "prefill": (prefill_replay_check(eng, card, label, counted)
                       if getattr(core, "_prefill_graphs", None) else None)}
    log(f"{tag} replayed decode step vs the eager body from the same state: "
        f"logits {'bit-identical' if exact else 'not bit-identical'} "
        f"(row_reading {reading:.4g}), "
        + (f"the same {out['kernel_launches']} kernel launches of "
           f"{out['kernel_names']} names under torch.profiler"
           if seen else "torch.profiler saw no kernel inside the graph "
           "(the replay is timed with CUDA events only)")
        + f"; CUDA events {out['replay_ms']:.3f} ms a replay vs "
        f"{out['eager_ms']:.3f} ms an eager body (card: {card})")
    return out


def prefill_replay_check(eng, card: str, label: str, counted) -> dict:
    """The widest prefill graph of an engine with no prefill in flight,
    replayed against its body run eagerly (on the capture stream, as the
    capture's warm-up ran it) from the same lane and inputs: a chunk of
    random ids at offset 512 with its last row padding (valid = width -
    1), so the chunk attends the lane's earlier rows and the logits come
    from a row before the last.  Checks the f32 last logits and every
    K/V row the chunk wrote bit-identical, and the same kernels by name
    and count under torch.profiler (``counted``); times both with CUDA
    events.  A chunk's body rewrites the same rows from the same inputs,
    so repeated calls need no restore; the lane's rows are restored at
    the end."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.engine import _capture_stream
    core = eng.core
    width, off = max(core._prefill_graphs), 512
    lane = [t for row in (*core._lane_ks, *core._lane_vs)
            for t in (row if isinstance(row, list) else [row])]
    saved = [t[:, off:off + width].clone() for t in lane]
    host = np.zeros(2 + width, np.int64)
    host[0], host[1] = off, width - 1
    host[2:] = np.random.RandomState(17).randint(
        0, core.model.cfg.vocab_size, (width,))
    core._prefill_io[:2 + width].copy_(torch.from_numpy(host))

    def replay():
        core._prefill_graph_chunk(width)

    def eager():
        stream = _capture_stream(core.device)
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            core._prefill_body(width)
        current.wait_stream(stream)

    tag = f"[graph:{label}]"
    runs = {}
    for name, fn in (("replay", replay), ("eager", eager)):
        for t, s in zip(lane, saved):
            t[:, off:off + width].copy_(s)
        fn()
        torch.cuda.synchronize()
        runs[name] = {"logits": core._prefill_logits.clone(),
                      "rows": [t[:, off:off + width].clone() for t in lane],
                      "counts": counted(fn),
                      "ms": time_ms(fn, iters=5, warmup=2, windows=3)}
    for t, s in zip(lane, saved):
        t[:, off:off + width].copy_(s)
    torch.cuda.synchronize()
    r, e = runs["replay"], runs["eager"]
    logits_exact = torch.equal(r["logits"], e["logits"])
    rows_exact = all(torch.equal(a, b) for a, b in zip(r["rows"], e["rows"]))
    if not (logits_exact and rows_exact):
        raise AssertionError(
            f"{tag} a replayed width-{width} prefill chunk differs from its "
            f"eager body: last logits {'equal' if logits_exact else 'differ'}"
            f", K/V rows {'equal' if rows_exact else 'differ'} (max abs "
            f"{(r['logits'] - e['logits']).abs().max().item()})")
    seen = bool(r["counts"])
    if seen and r["counts"] != e["counts"]:
        diff = {k[:90]: (r["counts"].get(k), e["counts"].get(k))
                for k in set(r["counts"]) | set(e["counts"])
                if r["counts"].get(k) != e["counts"].get(k)}
        # the tracer can drop a window's records: one more window of each
        r["counts"], e["counts"] = counted(replay), counted(eager)
        log(f"{tag} a first profiled window of each prefill chunk differed "
            f"(name: (replay, eager)) {json.dumps(diff)}; profiled again")
        if r["counts"] != e["counts"]:
            raise AssertionError(f"{tag} the replayed chunk's kernels differ "
                                 f"from its eager body's: {r['counts']} vs "
                                 f"{e['counts']}")
    out = {"width": width, "offset": off, "bit_identical": True,
           "kernels_seen_in_replay": seen,
           "kernel_launches": sum(e["counts"].values()),
           "replay_ms": r["ms"], "eager_ms": e["ms"]}
    log(f"{tag} replayed width-{width} prefill chunk (offset {off}, "
        f"valid {width - 1}) vs its eager body: last logits and the "
        f"{len(lane)} lane K/V row blocks it wrote bit-identical, "
        + (f"the same {out['kernel_launches']} kernel launches under "
           f"torch.profiler" if seen else "torch.profiler saw no kernel "
           "inside the graph")
        + f"; CUDA events {r['ms']:.3f} ms a replay vs {e['ms']:.3f} ms "
        f"an eager body (card: {card})")
    return out


def kernel_ms(prof) -> dict:
    """Device milliseconds by kernel name from a finished torch.profiler
    run."""
    import torch
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    return kernels


def profile_decode(eng, vocab: int, card: str, label: str,
                   steps: int = 5) -> dict:
    """Where a full-batch decode step's time goes, after the main run:
    fill all 8 slots with short greedy requests, hold the decode graph's
    replay to the eager body (``replay_checks``), then trace ``steps``
    decode-only steps (each a replay of the graph and eager sampling)
    with torch.profiler.  Reports the wall time per
    step, the device busy share (summed kernel time over wall time; one
    stream, so kernels do not overlap) and the kernels that take the
    most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(11)
    rids = [eng.submit(rs.randint(0, vocab, (64,)),
                       max_new_tokens=2 * steps + 4)
            for _ in range(eng.core.num_slots)]
    while eng.core._prefills or eng.core.scheduler.waiting:
        eng.step()
    torch.cuda.synchronize()
    graph = replay_checks(eng, card, label) \
        if getattr(eng.core, "_decode_graph", None) is not None else None
    # the step's host clock by phase, without the profiler: the engine's
    # own phase histograms over ``steps`` steps (decode_dispatch: the graph
    # replay's enqueue and sampling; readback: the wait for the device and
    # the copy; rest: harvest, eviction, metrics)
    hists = {name: eng.registry.get(f"serving.phase.{name}_s")
             for name in ("admission", "prefill", "decode_dispatch",
                          "readback")}
    before = {name: h.sum for name, h in hists.items()}
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    phases_ms = {name: (h.sum - before[name]) * 1e3 / steps
                 for name, h in hists.items()}
    phases_ms["rest"] = step_ms - sum(phases_ms.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_complete()
    for rid in rids:
        eng.purge(rid)
    kernels = kernel_ms(prof)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": busy_ms / steps,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top_kernels_ms_per_step": {k[:90]: v / steps for k, v in top},
           "graph": graph, "step_ms_unprofiled": step_ms,
           "host_phases_ms": phases_ms}
    tag = f"[profile:{label}]"
    if busy_ms == 0.0:
        log(f"{tag} the profiler saw no device time: device busy share "
            f"not measured")
    else:
        log(f"{tag} decode step, 8 slots busy, under torch.profiler: "
            f"{out['wall_ms_per_step']:.3f} ms wall, "
            f"{out['device_ms_per_step']:.3f} ms of kernels, device busy "
            f"share {out['busy_share']:.3f} (card: {card})")
        for name, ms in out["top_kernels_ms_per_step"].items():
            log(f"{tag}   {ms:8.4f} ms/step  {name}")
    log(f"{tag} the same step without the profiler: {step_ms:.3f} ms, by "
        f"phase on the host clock (ms) "
        f"{json.dumps({k: round(v, 3) for k, v in phases_ms.items()})}")
    return out


# the profiles' kinds of kernel, by name: the decode-attention kernels of
# prefill chunks and of decode steps, and cuBLAS GEMMs (each chunk's
# profile also lists its kernels by name)
PROFILE_KINDS = {
    "attention": ("chunk_wgmma_kernel", "decode_tile_kernel"),
    "decode_attention": ("decode_split_kernel", "decode_sq1_kernel"),
    "gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
}


def profile_prefill(eng, vocab: int, card: str, label: str,
                    prompt_len: int) -> dict:
    """Device time of each 512-token prefill chunk of one fresh prompt of
    ``prompt_len`` tokens on an idle engine: each engine step (one chunk,
    a replay of its width's graph where the engine captures them) under
    its own torch.profiler window, its wall time, its kernel time by kind
    (the chunk's attention, cuBLAS GEMMs, the rest), its busy share
    (kernel time over wall time; one stream, so kernels do not overlap)
    and its five longest kernels by name.  Reports every chunk and the
    median busy share; the last one attends over the longest cache, and
    its step also runs the request's first decode step (its
    ``decode_attention`` and part of its GEMMs and rest)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(13)
    rid = eng.submit(rs.randint(0, vocab, (prompt_len,)), max_new_tokens=1)
    chunks = []
    while eng.core._prefills or eng.core.scheduler.waiting:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind = {kind: 0.0 for kind in (*PROFILE_KINDS, "other")}
        by_name = kernel_ms(prof)
        for name, ms in by_name.items():
            kind = next((k for k, pats in PROFILE_KINDS.items()
                         if any(x in name for x in pats)), "other")
            by_kind[kind] += ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        device = sum(by_kind.values())
        chunks.append({"wall_ms": wall_ms, "device_ms": device,
                       "busy_share": device / wall_ms,
                       "device_ms_by_kind": by_kind,
                       "top_kernels_ms": {k[:90]: v for k, v in top}})
    eng.run_until_complete()
    eng.purge(rid)
    # the same steps without the profiler (its host cost a traced kernel
    # is not the engine's): a fresh prompt of the same length, each step
    # timed on the host clock to its synchronize
    rid = eng.submit(rs.randint(0, vocab, (prompt_len,)), max_new_tokens=1)
    unprofiled = []
    while eng.core._prefills or eng.core.scheduler.waiting:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        unprofiled.append((time.perf_counter() - t0) * 1e3)
    eng.run_until_complete()
    eng.purge(rid)
    for c, wall in zip(chunks, unprofiled):
        c["wall_ms_unprofiled"] = wall
        c["busy_share_unprofiled"] = c["device_ms"] / wall
    tag = f"[profile:{label}]"
    if not chunks or chunks[-1]["device_ms"] == 0.0:
        log(f"{tag} the profiler saw no device time: prefill chunk "
            f"profile not measured")
        return {"chunks": chunks}
    for i, c in enumerate(chunks):
        log(f"{tag} prefill chunk {i + 1} of {len(chunks)} ({prompt_len}-"
            f"token prompt) under torch.profiler: {c['wall_ms']:.3f} ms "
            f"wall, {c['device_ms']:.3f} ms of kernels, busy share "
            f"{c['busy_share']:.3f} (without the profiler "
            f"{c.get('wall_ms_unprofiled', float('nan')):.3f} ms wall, "
            f"{c.get('busy_share_unprofiled', float('nan')):.3f}); by kind "
            f"{json.dumps({k: round(v, 4) for k, v in c['device_ms_by_kind'].items()})} "
            f"(card: {card})")
    med = {key: float(np.median([c[key] for c in chunks if key in c]))
           for key in ("wall_ms", "busy_share", "wall_ms_unprofiled",
                       "busy_share_unprofiled")}
    log(f"{tag} prefill chunks, medians: under torch.profiler wall "
        f"{med['wall_ms']:.3f} ms, busy share {med['busy_share']:.3f}; "
        f"without it wall {med['wall_ms_unprofiled']:.3f} ms, kernels "
        f"over that wall {med['busy_share_unprofiled']:.3f} (card: {card})")
    return {"prompt_len": prompt_len, "chunks": chunks,
            "wall_ms_median": med["wall_ms"],
            "busy_share_median": med["busy_share"],
            "wall_ms_unprofiled_median": med["wall_ms_unprofiled"],
            "busy_share_unprofiled_median": med["busy_share_unprofiled"]}


# --------------------------------------------------------------- parity
# the f32 Llama of the parity phases: GQA (12 heads over 4 kv heads) at
# gpt_small-like width, 2 layers
LLAMA_PARITY = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                    num_layers=2, num_heads=12, num_kv_heads=4,
                    max_seq_len=1024)


def parity_model(family: str, device):
    """The f32 model of the parity phases on ``device``, from the same
    seeded generator on every device type: gpt_small width or
    ``LLAMA_PARITY``, 2 layers."""
    import dataclasses

    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                         LlamaForCausalLM, gpt_small)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    if family == "gpt":
        return GPTForCausalLM(dataclasses.replace(gpt_small(), num_layers=2),
                              device=device, dtype="float32", generator=gen)
    return LlamaForCausalLM(LlamaConfig(**LLAMA_PARITY), device=device,
                            dtype="float32", generator=gen)


def check_graphed(eng, what: str, widths) -> dict:
    """Raise unless ``eng`` served its decode steps through one captured
    CUDA graph, after one eager decode step, and its prefill chunks
    through one captured graph per width of ``widths`` (the distinct
    widths its requests' chunk plans ran), each after one eager chunk:
    every capture counted once in ``serving.compiles`` and in the
    ``compile`` events.  A checkout whose prefill runs eagerly
    (``--serve-ab``'s parent) is held to its decode graph alone.  Returns
    what it read."""
    core = eng.core
    graphed_prefill = hasattr(core, "eager_prefill_chunks")
    prefill = len(widths) if graphed_prefill else 0
    got = {"decode_graph_reason": eng.decode_graph_reason,
           "capture_counts": dict(core.capture_counts),
           "serving.compiles": eng.registry.get("serving.compiles").value,
           "compiled": sum(attrs["count"] for *_, attrs in
                           eng.tracer.events("compile")),
           "eager_decode_steps": core.eager_decode_steps}
    want = {"decode_graph_reason": None,
            "capture_counts": {"prefill": prefill, "decode": 1,
                               "verify": 0},
            "serving.compiles": prefill + 1, "compiled": prefill + 1,
            "eager_decode_steps": 1}
    if graphed_prefill:
        got.update(prefill_graph_reason=eng.prefill_graph_reason,
                   prefill_graphs=sorted(core._prefill_graphs),
                   eager_prefill_chunks=core.eager_prefill_chunks)
        want.update(prefill_graph_reason=None,
                    prefill_graphs=sorted(widths),
                    eager_prefill_chunks=prefill)
    if got != want:
        raise AssertionError(f"{what}: the decode step and the prefill "
                             f"chunks were not served by one captured CUDA "
                             f"graph each (a width): {got} != {want}")
    return got


def phase_parity(family: str) -> None:
    """On the f32 parity model of ``family`` (TF32 off): the fused-path
    engine's greedy tokens == the unfused engine's == the port's
    ``generate`` tokens; and so are those of tp=2 engines (both shards on
    the card) on all three rungs, ``tp_fused_block``, ``tp_fused`` and
    ``unfused``, each on its own copy of the model (a tensor-parallel
    engine re-lays its model's weights).  Every engine's decode steps go
    through its one captured CUDA graph, its prefill chunks through one
    graph a width (``check_graphed``)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = parity_model(family, DEVICE).eval()
    cfg = model.cfg
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (40, 150, 300)]
    tokens = {}
    for fused in (False, True):
        eng = ServingEngine(model, num_slots=3, min_bucket=16, block_len=16,
                            prefill_chunk=64, fused_decode=fused)
        want_path = "fused" if fused else "unfused"
        if eng.decode_path != want_path:
            raise AssertionError(f"parity engine resolved "
                                 f"{eng.decode_path!r} "
                                 f"({eng.decode_fallback_reason}), want "
                                 f"{want_path!r}")
        outs = eng.serve_batch(prompts, max_new_tokens=16)
        tokens[want_path] = [o.tokens for o in outs]
        check_graphed(eng, f"[parity:{family}] {want_path} engine",
                      plan_widths(eng, [(len(p), o.prefix_hit_tokens)
                                        for p, o in zip(prompts, outs)]))
        eng.close()
    for kw, want_path in ((dict(fused_decode=True), "tp_fused_block"),
                          ({}, "tp_fused"),
                          (dict(collective_fusion=False), "unfused")):
        eng = ServingEngine(parity_model(family, DEVICE).eval(), num_slots=4,
                            min_bucket=16, block_len=16, prefill_chunk=64,
                            tensor_parallel=TP, devices=TP_DEVICES, **kw)
        if eng.decode_path != want_path:
            raise AssertionError(f"tp={TP} parity engine resolved "
                                 f"{eng.decode_path!r} "
                                 f"({eng.decode_fallback_reason}, "
                                 f"{eng.core.tp_fusion_reason}), want "
                                 f"{want_path!r}")
        outs = eng.serve_batch(prompts, max_new_tokens=16)
        tokens[f"tp{TP}_{want_path}"] = [o.tokens for o in outs]
        check_graphed(eng, f"[parity:{family}] tp={TP} {want_path} engine",
                      plan_widths(eng, [(len(p), o.prefix_hit_tokens)
                                        for p, o in zip(prompts, outs)]))
        eng.close()
    for i, p in enumerate(prompts):
        want = model.generate(p[None], max_new_tokens=16)[0, len(p):]
        want = want.cpu().tolist()
        for path, got in tokens.items():
            if got[i] != want:
                raise AssertionError(f"{family} {path} engine tokens "
                                     f"{got[i]} != generate tokens {want} "
                                     f"(prompt len {len(p)})")
    what = ("gpt_small width, 2 layers" if family == "gpt" else
            f"Llama {json.dumps(LLAMA_PARITY)}")
    log(f"[parity:{family}] {what}, f32: fused-engine greedy tokens == "
        f"unfused-engine tokens == tp={TP} tp_fused_block / tp_fused / "
        f"unfused engine tokens == generate tokens for {len(prompts)} "
        f"requests (prompt lengths {[len(p) for p in prompts]}, 16 new "
        f"tokens each); every engine's decode steps replayed its one "
        f"captured CUDA graph, its prefill chunks one graph a width")


# ------------------------------------------------------------ training
# the train phases' configuration: every width of gpt3_6_7b (llama_7b),
# 12 of its 32 layers (a full-depth train step needs ~107 GB of parameter
# state alone)
TRAIN_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
TRAIN_LR = 1e-4
# Llama-2-7B's train batch: one sequence at its full 4096 context
LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ = 1, 4096


def _flash_case(g, dtype, b, sq, sk, h, kvh, d, packed=False):
    """Random q/k/v/dO on the card; ``packed`` takes q/k/v as strided
    views of one [b, s, 3, h, d] tensor, as the model's fused QKV
    projection gives them."""
    import torch
    dev = torch.device(DEVICE)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    if packed:
        qkv = r(b, sq, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = r(b, sq, h, d), r(b, sk, kvh, d), r(b, sk, kvh, d)
    return q, k, v, r(b, sq, h, d)


def _err(got, want):
    """Max abs error over the entries that are finite in ``want``; raises
    if the two disagree on which entries are finite."""
    import torch
    finite = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), finite):
        raise AssertionError("kernel and plain version disagree on which "
                             "entries are finite (rows that see no key)")
    if not bool(finite.any()):
        return 0.0
    return (got.float()[finite] - want.float()[finite]).abs().max().item()


def flash_bounds(b, sq, sk, h, kvh, d, causal, es, pairs=None,
                 ids_bytes=0):
    """Least time (ms) of each flash kernel at these shapes, and what
    bounds it.  Operations: 2·d multiply-adds per visible (query, key)
    pair for each product — forward 2 (QK^T, PV), dq 3 (QK^T, dO V^T,
    dS K), dkv 4 (QK^T, dO V^T, P^T dO, dS^T Q) — over the bf16 tensor
    rate; ``pairs`` (per batch row and head) where segment ids decide
    them.  Bytes: each input (``ids_bytes`` of segment ids too) read once,
    each output written once."""
    off = sk - sq
    if pairs is None:
        pairs = sum(max(0, min(sk, t + off + 1)) for t in range(sq)) \
            if causal else sq * sk
    q_b, kv_b, stat_b = b * sq * h * d * es, \
        2 * b * sk * kvh * d * es + ids_bytes, b * h * sq * 4
    work = {"flash_attention_fwd": (2, q_b + kv_b + q_b + stat_b),
            "flash_attention_bwd_dq": (3, 2 * q_b + kv_b + 2 * stat_b + q_b),
            "flash_attention_bwd_dkv": (4, 2 * q_b + kv_b + 2 * stat_b
                                        + kv_b)}
    peak = PEAK_FLOPS["bfloat16" if es == 2 else "float32"]
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * 2 * b * h * d * pairs / peak * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def phase_train_kernels(card: str):
    """Hold the three flash kernels and fused AdamW against their plain
    versions over a sweep and at the GPT and Llama train paths' shapes,
    and time each there beside its plain version, its bound and one
    library call (a yardstick only).  Returns each kernel's record
    (without launches)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels.fused_adamw import (fused_adamw,
                                                      fused_adamw_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    # f32: only the summation order differs; 16-bit: the output cast and
    # the 16-bit P / dS of the second products (FlashAttention-2's
    # rounding), relative to the largest value of the result (FLASH_REL);
    # 16-bit elements each within their own limit too (row_reading, lse
    # within 1e-4 relative: check_pairs)
    worst, reading = {}, {}
    n = 0
    # (B, Sq, Sk, H, KVH, packed): Sq = Sk at and around the forward's
    # 128-row tiles (127, 128, 129, 257), Sq < Sk and Sq > Sk (rows that
    # see no key when causal), GQA 2 and 4 query heads a kv head, B*H from
    # 1 to 64, and q/k/v as strided views of one fused QKV tensor
    shapes = [(1, 128, 128, 1, 1, False), (1, 127, 127, 2, 1, False),
              (2, 129, 129, 4, 1, False), (2, 257, 257, 8, 2, False),
              (2, 200, 200, 4, 2, False), (1, 64, 320, 2, 2, False),
              (1, 129, 257, 4, 1, False), (2, 256, 96, 2, 1, False),
              (1, 257, 127, 4, 1, False), (2, 512, 512, 32, 32, False),
              (2, 257, 257, 4, 4, True)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype).replace("torch.", "")
        for d in (64, 128):
            for b, sq, sk, h, kvh, packed in shapes:
                for causal in (True, False):
                    q, k, v, do = _flash_case(g, dtype, b, sq, sk, h, kvh, d,
                                              packed=packed)
                    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                    ro, rl = fa.flash_attention_fwd_reference(q, k, v,
                                                              causal=causal)
                    delta = (do.float() * out.float()).sum(-1) \
                        .transpose(1, 2).contiguous()
                    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   causal=causal)
                    rdq = fa.flash_attention_bwd_dq_reference(
                        q, k, v, do, lse, delta, causal=causal)
                    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                        delta, causal=causal)
                    rdk, rdv = fa.flash_attention_bwd_dkv_reference(
                        q, k, v, do, lse, delta, causal=causal)
                    torch.cuda.synchronize()
                    what = (f"dtype={dname} D={d} B={b} Sq={sq} Sk={sk} "
                            f"H={h} KVH={kvh} causal={causal}"
                            f"{' (views of a fused QKV)' if packed else ''}")
                    for name, pairs, lses in (
                            ("flash_attention_fwd", ((out, ro),),
                             ((lse, rl),)),
                            ("flash_attention_bwd_dq", ((dq, rdq),), ()),
                            ("flash_attention_bwd_dkv", ((dk, rdk), (dv, rdv)),
                             ())):
                        _, rel_, read = check_pairs(
                            f"{name} disagrees with its plain version: "
                            f"{what}", dtype, pairs, lses)
                        key = f"{name} {dname}"
                        worst[key] = max(worst.get(key, 0.0), rel_)
                        reading[key] = max(reading.get(key, 0.0), read)
                    if causal and sq > sk:
                        blind = sq - sk
                        if bool(out[:, :blind].any()) or not bool(
                                torch.isneginf(lse[:, :, :blind]).all()):
                            raise AssertionError(f"rows that see no key must "
                                                 f"give out 0, lse -inf: "
                                                 f"{what}")
                    n += 1
    log(f"[train-kernels] flash sweep: {n} cases (f32/bf16/f16 x head_dim "
        f"64/128 x causal/full x Sq=Sk 127-512, Sq<Sk, Sq>Sk, GQA 2 and 4, "
        f"B*H 1-64, views of a fused QKV) within tolerance (max abs err over "
        f"max(1, max |plain|): f32 1e-5, 16-bit 2e-2; 16-bit elements each "
        f"within 2 ulps of itself + 2 ulps of its row's largest + 1e-4, lse "
        f"within 1e-4 relative), rows that see no key out 0 and lse -inf; "
        f"worst relative errors {json.dumps(worst)}; worst readings (error "
        f"over limit) {json.dumps(reading)}")

    # the forward's 16-bit instantiations run on wgmma and TMA: the
    # built library's SASS holds HGMMA and UTMALDG in each and no HMMA
    # (the mma.sync of the earlier kernel)
    from paddle_tpu_torch.kernels import _build, sass
    fwd_sass = sass.instruction_counts(
        str(_build._library_path("flash_attention")), "fwd_wgmma_kernel",
        ("HGMMA", "UTMALDG", "HMMA"))
    if len(fwd_sass) != 8 or any(
            c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] != 0
            for c in fwd_sass.values()):
        raise AssertionError(f"the forward's 16-bit instantiations (bf16/f16 "
                             f"x head_dim 64/128 x segments or not) must each "
                             f"hold HGMMA and UTMALDG and no HMMA: "
                             f"{json.dumps(fwd_sass)}")
    log(f"[train-kernels] SASS of the forward's 16-bit instantiations "
        f"(cuobjdump -sass; HGMMA wgmma, UTMALDG TMA loads, HMMA mma.sync): "
        f"{json.dumps(fwd_sass)}")
    # so do the backward's, dq and dkv, with no local-memory spills (STL /
    # LDL: a store to or a load from local memory)
    bwd_sass = {}
    for kernel in ("dq_wgmma_kernel", "dkv_wgmma_kernel"):
        counts = sass.instruction_counts(
            str(_build._library_path("flash_attention")), kernel,
            ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL"))
        if len(counts) != 8 or any(
                c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] != 0
                or c["STL"] != 0 or c["LDL"] != 0 for c in counts.values()):
            raise AssertionError(f"the backward's 16-bit {kernel} "
                                 f"instantiations (bf16/f16 x head_dim 64/128 "
                                 f"x segments or not) must each hold HGMMA and "
                                 f"UTMALDG and no HMMA, STL or LDL: "
                                 f"{json.dumps(counts)}")
        bwd_sass[kernel] = counts
    log(f"[train-kernels] SASS of the backward's 16-bit instantiations "
        f"(HGMMA wgmma, UTMALDG TMA loads, HMMA mma.sync, STL / LDL "
        f"local-memory spills): {json.dumps(bwd_sass)}")

    # AdamW: f32 and bf16 p, with and without decay, a length that is not
    # a multiple of the vector width, a misaligned view (scalar path), the
    # low-precision copy of a master
    n_adam = 0
    adam_worst = 0.0
    for p_dtype, g_dtype, low, wd, length, offset in (
            (torch.float32, torch.float32, False, 0.0, 1_000_003, 0),
            (torch.float32, torch.bfloat16, True, 0.1, 1_000_003, 0),
            (torch.bfloat16, torch.bfloat16, False, 0.1, 4099, 0),
            (torch.float32, torch.float32, False, 0.1, 4099, 1),
            (torch.float16, torch.float16, False, 0.0, 64, 0)):
        base = torch.randn(length + offset, generator=g, device=dev)
        p = base.to(p_dtype)[offset:]
        grad = torch.randn(length, generator=g, device=dev).to(g_dtype)
        m = torch.randn(length, generator=g, device=dev) * 1e-2
        v = torch.rand(length, generator=g, device=dev) * 1e-3
        lo = p.to(torch.bfloat16) if low else None
        p2, m2, v2 = p.clone(), m.clone(), v.clone()
        lo2 = lo.clone() if low else None
        kw = dict(lr=1e-3, weight_decay=wd, step=7)
        fused_adamw(p, grad, m, v, low=lo, **kw)
        fused_adamw_reference(p2, grad, m2, v2, low=lo2, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("p", p, p2), ("m", m, m2), ("v", v, v2),
                                ("low", lo, lo2)):
            if got is None:
                continue
            if got.dtype == torch.float32:
                ok = torch.allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                ok = _ulp_ok(got, want, got.dtype)
            if not ok:
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"fused_adamw disagrees with its plain version on {name}: "
                    f"p {p_dtype} g {g_dtype} wd {wd} n {length} offset "
                    f"{offset} max_abs_err {err}")
            adam_worst = max(adam_worst, (got.float() - want.float()).abs()
                             .max().item())
        n_adam += 1
    log(f"[train-kernels] fused_adamw sweep: {n_adam} cases (p f32/bf16/f16, "
        f"g f32/bf16, decay on/off, ragged lengths, a misaligned view, the "
        f"low copy) within tolerance (f32 rtol 1e-6 / atol 1e-7, 16-bit one "
        f"ulp); max abs err {adam_worst:.3g}")

    # each train path's shape, bf16, causal, checked and timed beside the
    # plain version, the bound and the library yardstick (SDPA forward,
    # and SDPA's backward, dq, dk and dv together, on a retained graph, on
    # the same tensors transposed): gpt3_6_7b's q/k/v [2, 2048, 32, 128]
    # as views of the fused QKV projection, llama_7b's [1, 4096, 32, 128]
    # from its separate projections and the rotary embedding
    from paddle_tpu_torch.models import gpt3_6_7b, llama_7b
    recs = {}
    for model, cfg, b, s, packed in (
            ("gpt3_6_7b", gpt3_6_7b(), TRAIN_BATCH, TRAIN_SEQ, True),
            ("llama_7b", llama_7b(), LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ,
             False)):
        h, d = cfg.num_heads, cfg.head_dim
        kvh = getattr(cfg, "kv_heads", h)           # GPT is multi-head
        q, k, v, do = _flash_case(g, torch.bfloat16, b, s, s, h, kvh, d,
                                  packed=packed)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            causal=True)
        ro, rl = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        rdq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  causal=True)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                        delta, causal=True)
        torch.cuda.synchronize()
        shape = (f"q/k/v [{b},{s},{h},{d}] bf16 "
                 f"({'views of a fused QKV' if packed else 'separate'}), "
                 f"causal ({model})")
        # each element within its own limit too (check_pairs)
        errs, reads = {}, {}
        for name, pairs, lses in (
                ("flash_attention_fwd", ((out, ro),), ((lse, rl),)),
                ("flash_attention_bwd_dq", ((dq, rdq),), ()),
                ("flash_attention_bwd_dkv", ((dk, rdk), (dv, rdv)), ())):
            errs[name], _, reads[name] = check_pairs(
                f"{name} disagrees at {shape}", torch.bfloat16, pairs, lses)
        del ro, rl, rdq, rdk, rdv
        # one writer per result, no atomics: a second backward gives the
        # same bits
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                              causal=True)
        torch.cuda.synchronize()
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"two backward calls at {shape} differ: the "
                                 f"dq / dkv kernels must be deterministic")
        log(f"[train-kernels] {shape}: two backward calls give bit-identical "
            f"dq, dk and dv")
        del dq2, dk2, dv2
        times = {
            "flash_attention_fwd": time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            "flash_attention_bwd_dq": time_ms(
                lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                  causal=True)),
            "flash_attention_bwd_dkv": time_ms(
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   causal=True)),
        }
        plain = {
            "flash_attention_fwd": time_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                         causal=True),
                iters=3, warmup=2, windows=3),
            "flash_attention_bwd_dq": time_ms(
                lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, do, lse, delta, causal=True),
                iters=3, warmup=2, windows=3),
            "flash_attention_bwd_dkv": time_ms(
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, causal=True),
                iters=3, warmup=2, windows=3),
        }
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do_t, retain_graph=True))
        del o_lib, qt, kt, vt
        bounds = flash_bounds(b, s, s, h, kvh, d, True, 2)
        for name in times:
            bound, bound_by = bounds[name]
            lib = lib_fwd if name == "flash_attention_fwd" else None
            r = {"ms": times[name], "plain_ms": plain[name],
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": lib, "max_abs_err": errs[name],
                 "max_reading": reads[name], "shape": shape}
            if name != "flash_attention_fwd":
                r["library_ms_dq_dkv_together"] = lib_bwd
            recs.setdefault(name, {})[model] = r
            log(f"[train-kernels] {name} {shape}: kernel {times[name]:.4f} "
                f"ms, plain {plain[name]:.4f} ms, bound {bound:.4f} ms "
                f"({bound_by}); max abs err {errs[name]:.3g}, reading "
                f"{reads[name]:.3g} (card: {card})")
        log(f"[train-kernels] library yardsticks at {shape}: SDPA forward "
            f"{lib_fwd:.4f} ms; SDPA backward (dq, dk, dv together) "
            f"{lib_bwd:.4f} ms vs the port's dq + dkv "
            f"{times['flash_attention_bwd_dq'] + times['flash_attention_bwd_dkv']:.4f}"
            f" ms (card: {card})")
        del q, k, v, do, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    for name in list(recs):
        # the record's headline is the gpt3_6_7b shape, as in earlier runs
        recs[name] = {**recs[name]["gpt3_6_7b"],
                      "llama_7b": recs[name]["llama_7b"],
                      "sweep_max_rel_err": {k_: e for k_, e in worst.items()
                                            if k_.startswith(name)},
                      "sweep_max_reading": {k_: e for k_, e in
                                            reading.items()
                                            if k_.startswith(name)}}
    recs["flash_attention_fwd"]["sass_16bit"] = fwd_sass
    recs["flash_attention_bwd_dq"]["sass_16bit"] = bwd_sass["dq_wgmma_kernel"]
    recs["flash_attention_bwd_dkv"]["sass_16bit"] = \
        bwd_sass["dkv_wgmma_kernel"]

    # AdamW on one fc_in weight [4096, 16384]: f32 master, bf16 gradient,
    # f32 moments, the bf16 parameter written in the same pass
    cfg = gpt3_6_7b()
    numel = cfg.hidden_size * cfg.ffn_size
    master = torch.randn(numel, generator=g, device=dev)
    grad = torch.randn(numel, generator=g, device=dev).to(torch.bfloat16)
    m = torch.zeros(numel, device=dev)
    v = torch.zeros(numel, device=dev)
    low = master.to(torch.bfloat16)
    kw = dict(lr=1e-4, weight_decay=0.01, step=1)
    adam_ms = time_ms(lambda: fused_adamw(master, grad, m, v, low=low, **kw))
    adam_plain = time_ms(lambda: fused_adamw_reference(
        master, grad, m, v, low=low, **kw), iters=5, warmup=2, windows=3)
    # yardstick: torch.optim.AdamW(fused=True) on an f32 parameter with an
    # f32 gradient (no master and no low copy: PyTorch's fused AdamW has
    # neither)
    tp = torch.nn.Parameter(master.clone())
    tp.grad = grad.float()
    topt = torch.optim.AdamW([tp], lr=1e-4, weight_decay=0.01, fused=True)
    adam_lib = time_ms(topt.step)
    del tp, topt
    adam_bytes = numel * (4 + 2 + 4 + 4 + 4 + 4 + 4 + 2)
    adam_bound = adam_bytes / HBM_BYTES_PER_S * 1e3
    recs["fused_adamw"] = {
        "ms": adam_ms, "plain_ms": adam_plain, "bound_ms": adam_bound,
        "bound_by": "bytes", "library_ms": adam_lib,
        "max_abs_err": adam_worst,
        "shape": "one fc_in weight [4096,16384]: f32 master, bf16 grad, f32 "
                 "m/v, bf16 parameter copy (28 B per element)"}
    log(f"[train-kernels] fused_adamw on [{cfg.hidden_size},"
        f"{cfg.ffn_size}] ({numel / 1e6:.1f}M elements, "
        f"{adam_bytes / 1e9:.2f} GB): kernel {adam_ms:.4f} ms, plain "
        f"{adam_plain:.4f} ms, torch.optim.AdamW(fused=True) {adam_lib:.4f} "
        f"ms, bound {adam_bound:.4f} ms (bytes) (card: {card})")
    del master, grad, m, v, low
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------- varlen attention
# the full-width packed call: 8 documents in T = 8192 tokens (4 rows of
# gpt3_6_7b's max_seq 2048) at the attention width of gpt3_6_7b and
# llama_7b (32 heads x 128), bf16, causal
VARLEN_DOCS = (3072, 2048, 1024, 1000, 600, 300, 100, 48)
# query heads per pass of the plain version at that width (8 heads of
# f32 scores take 2.1 GB; the pass holds a few such tensors)
VARLEN_HEAD_GROUP = 8


def _cu(lengths, dev):
    import numpy as np
    import torch
    return torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int64,
                        device=dev)


def _varlen_ids(pattern, b, sq, sk, seed):
    """q / k segment ids (int32 [b, sq] / [b, sk] on the card):
    ``packed`` cuts each row into 3 documents at random points (the q and
    k packs cut at the same fractions); ``padding`` packs 80% of the row,
    the rest query id -1 / key id -2 (matching nothing: rows that see no
    key); ``no_keys`` gives queries segments 0 1 2 and keys 0 2 3 (the
    rows of 1 see nothing, the keys of 3 are seen by none); ``scrambled``
    draws each id from {0, 1, 2} (ids in no order)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)

    def docs(n, fracs, names=(0, 1, 2)):
        cuts = (np.asarray(fracs) * n).astype(int)
        return np.asarray(names)[np.searchsorted(cuts, np.arange(n),
                                                 side="right")]
    rows_q, rows_k = [], []
    for _ in range(b):
        fracs = np.sort(rs.uniform(0.1, 0.9, 2))
        if pattern == "packed":
            q, k = docs(sq, fracs), docs(sk, fracs)
        elif pattern == "padding":
            q, k = docs(sq, fracs * 0.8), docs(sk, fracs * 0.8)
            q[int(0.8 * sq):], k[int(0.8 * sk):] = -1, -2
        elif pattern == "no_keys":
            q, k = docs(sq, fracs), docs(sk, fracs, (0, 2, 3))
        else:
            q, k = rs.randint(0, 3, sq), rs.randint(0, 3, sk)
        rows_q.append(q)
        rows_k.append(k)
    return tuple(torch.as_tensor(np.stack(r).astype(np.int32)).to(DEVICE)
                 for r in (rows_q, rows_k))


def tile_pairs(ids, q_tile: int, k_tile: int, by_keys: bool,
               groups: int = 1) -> int:
    """(query, key) pairs a segment kernel computes for one head over the
    causal self-attention of one row with segment ``ids`` (numpy [T]): a
    model of the walks of ``csrc/flash_attention.cu``, not a count on the
    card.  Each computed tile counts its full size.

    ``by_keys`` False (fwd, dq): a block of ``q_tile`` queries walks the
    ``k_tile``-key tiles below its causal limit (one past its last
    query); a tile's id range is taken over its keys below that limit.
    The block's queries form ``groups`` groups of ``q_tile // groups``
    rows (the consumer warpgroups), and a group computes a tile when the
    tile starts at or below the group's last query and the two id ranges
    overlap.  ``by_keys`` True (dkv): a block of ``k_tile`` keys, in
    ``groups`` groups of ``k_tile // groups`` keys, walks the
    ``q_tile``-query tiles from the one holding its first key; a group
    computes a tile when the tile's last query is at or after the group's
    first key and the tile's id range overlaps the group's."""
    import numpy as np
    t = len(ids)
    tiles = 0
    if by_keys:
        rows = k_tile // groups
        starts = np.arange(0, t, q_tile)
        qlo = np.minimum.reduceat(ids, starts)
        qhi = np.maximum.reduceat(ids, starts)
        for k0 in range(0, t, k_tile):
            walked = starts >= k0 // q_tile * q_tile
            for g0 in range(k0, min(k0 + k_tile, t), rows):
                mine = ids[g0:min(g0 + rows, t)]
                hit = (walked & (starts + q_tile - 1 >= g0)
                       & ~((qhi < mine.min()) | (mine.max() < qlo)))
                tiles += int(hit.sum())
        return tiles * q_tile * rows
    rows = q_tile // groups
    for q0 in range(0, t, q_tile):
        kend = min(q0 + q_tile, t)
        starts = np.arange(0, kend, k_tile)
        klo = np.minimum.reduceat(ids[:kend], starts)
        khi = np.maximum.reduceat(ids[:kend], starts)
        for g0 in range(q0, kend, rows):
            mine = ids[g0:min(g0 + rows, t)]
            hit = ((starts < g0 + len(mine))
                   & ~((khi < mine.min()) | (mine.max() < klo)))
            tiles += int(hit.sum())
    return tiles * rows * k_tile


def decode_split(q, k_cache, v_cache, seq_lens, split_rows: int,
                 scale=None, causal: bool = True, drop=None, shift: int = 0):
    """A model of the 16-bit decode kernel's split walk
    (``csrc/decode_attention.cu`` ``decode_split_kernel``), for any number
    of queries, in f32 on the inputs' device: each run of ``split_rows``
    cache rows gives a partial softmax (m, l, acc) over the rows each query
    sees (m = -inf and l = 0 where it sees none), and the partials merge in
    split order.  Returns ``[B, sq, H, D]`` in q's dtype.  Planted faults,
    which the kernel's check must catch: ``drop`` leaves split ``drop``'s
    partial out, ``shift`` moves every query's causal offset."""
    import torch
    b, sq, h, d = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / d ** 0.5 if scale is None else scale
    qf = q.float() * scale
    kf = k_cache.float().repeat_interleave(h // kvh, dim=2)
    vf = v_cache.float().repeat_interleave(h // kvh, dim=2)
    lens = seq_lens.to(device=q.device, dtype=torch.long)[:, None, None]
    kpos = torch.arange(s_max, device=q.device)[None, None, :]
    seen = kpos < lens                                  # [B, sq, S_max]
    if causal:
        qpos = torch.arange(sq, device=q.device)[None, :, None]
        seen = seen & (kpos <= lens - sq + qpos + shift)
    parts = []
    for r0 in range(0, s_max, split_rows):
        rows = slice(r0, min(r0 + split_rows, s_max))
        mask = seen[:, None, :, rows]                   # [B, 1, sq, n]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, rows])
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1)
        p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
        p = p.masked_fill(~mask, 0.0)
        if r0 // split_rows != drop:
            parts.append((m, p.sum(-1),
                          torch.einsum("bhqk,bkhd->bhqd", p, vf[:, rows])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_all = torch.where(m_all == float("-inf"), 0.0, m_all)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for m, l, a in parts:
        f = torch.exp(m - m_all)                        # 0 where m = -inf
        l_all = l_all + l * f
        acc = acc + a * f[..., None]
    out = acc / torch.where(l_all == 0.0, 1.0, l_all)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attn_tp_split(q, k, v, k_slab, v_slab, seq_pos, *, kv_heads: int,
                  head_dim: int, split_rows: int, scale=None, rope_cos=None,
                  rope_sin=None, drop=None, fold: bool = True):
    """A model of the tensor-parallel shard attention's split walk
    (``csrc/decode_block_tp.cu`` ``attn_tp_split_kernel`` on
    ``csrc/decode_split.cuh``), in f32 on the inputs' device, leaving the
    slabs as they are: rotary and the scale on q and the fresh k, the
    fresh row cast to the slab dtype (as stored); each run of
    ``split_rows`` slab rows gives a partial softmax (m, l, acc) over its
    live rows ``kpos < min(pos, S - 1)``, the partials merge in split
    order, and the fresh row folds in last.  Returns ``[B, H*Dh]`` in q's
    dtype.  Planted faults, which the kernel's check must catch: ``drop``
    leaves split ``drop``'s partial out, ``fold=False`` leaves the fresh
    row out."""
    import torch
    b, s_max = k_slab.shape[:2]
    heads = q.shape[1] // head_dim
    rep = heads // kv_heads
    scale = 1.0 / head_dim ** 0.5 if scale is None else float(scale)
    qf = q.float().reshape(b, heads, head_dim)
    kf = k.float().reshape(b, kv_heads, head_dim)
    vf = v.float().reshape(b, kv_heads, head_dim)
    if rope_cos is not None:
        c, s = rope_cos.float()[:, None, :], rope_sin.float()[:, None, :]
        half = head_dim // 2

        def rot(t):
            return torch.cat([-t[..., half:], t[..., :half]], dim=-1)
        qf = qf * c + rot(qf) * s
        kf = kf * c + rot(kf) * s
    qf = qf * scale
    k_new = kf.to(k_slab.dtype).float().repeat_interleave(rep, dim=1)
    v_new = vf.to(v_slab.dtype).float().repeat_interleave(rep, dim=1)
    pos = torch.as_tensor(seq_pos, device=q.device).long().expand(b)
    posw = pos.clamp(0, s_max - 1)
    ks = k_slab.float().repeat_interleave(rep, dim=2)   # [B, S, H, Dh]
    vs = v_slab.float().repeat_interleave(rep, dim=2)
    live = torch.arange(s_max, device=q.device)[None, :] < posw[:, None]
    neg = float("-inf")
    parts = []
    for r0 in range(0, s_max, split_rows):
        rows = slice(r0, min(r0 + split_rows, s_max))
        mask = live[:, None, rows]                      # [B, 1, n]
        sc = torch.einsum("bhd,bkhd->bhk", qf, ks[:, rows])
        sc = sc.masked_fill(~mask, neg)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(m == neg, 0.0, m)[..., None])
        # a masked row may hold anything (NaN too): its V is never read
        p = p.masked_fill(~mask, 0.0)
        vr = vs[:, rows].masked_fill(~live[:, rows, None, None], 0.0)
        if r0 // split_rows != drop:
            parts.append((m, p.sum(-1), torch.einsum("bhk,bkhd->bhd", p, vr)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_ref = torch.where(m_all == neg, 0.0, m_all)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros((b, heads, head_dim), device=q.device)
    for m, l, a in parts:
        f = torch.exp(m - m_ref)                        # 0 where m = -inf
        l_all = l_all + l * f
        acc = acc + a * f[..., None]
    if fold:
        s_new = (qf * k_new).sum(-1)
        m_fold = torch.maximum(m_all, s_new)
        f, p_new = torch.exp(m_all - m_fold), torch.exp(s_new - m_fold)
        l_all = l_all * f + p_new
        acc = acc * f[..., None] + p_new[..., None] * v_new
    out = acc / torch.where(l_all == 0.0, 1.0, l_all)[..., None]
    return out.reshape(b, heads * head_dim).to(q.dtype)


def chunk_walk(seq_len: int, sq: int, s_max: int, causal: bool,
               q_tile: int = 128, k_tile: int = 128, groups: int = 2):
    """The key tiles the 16-bit chunk kernel (``csrc/decode_attention.cu``
    ``chunk_wgmma_kernel``) loads and computes for one (batch row, head):
    a model of its walk, not a count on the card.  Query t sits at cache
    row seq_len - sq + t.  The block of ``q_tile`` queries from q0 loads
    the tiles below the last row its queries see, min(S_max, seq_len,
    seq_len - sq + last + 1) with the causal tail; each of its ``groups``
    groups of rows computes the loaded tiles that start below its own such
    end.  Returns ``{q0: (tile starts loaded, {group's first query: tile
    starts computed})}``."""
    lim = max(0, min(s_max, seq_len))
    off = seq_len - sq

    def end(t_last):
        return max(0, min(lim, off + t_last + 1)) if causal else lim

    rows = q_tile // groups
    walk = {}
    for q0 in range(0, sq, q_tile):
        loaded = list(range(0, end(min(q0 + q_tile, sq) - 1), k_tile))
        computed = {}
        for w0 in range(q0, q0 + q_tile, rows):
            wend = end(min(w0 + rows, sq) - 1) if w0 < sq else 0
            computed[w0] = [k0 for k0 in loaded if k0 < wend]
        walk[q0] = (loaded, computed)
    return walk


def _seen(qs, ks, causal):
    """[B, Sq, Sk]: query t sees key j (same segment, under the causal
    limit)."""
    import torch
    sq, sk = qs.shape[1], ks.shape[1]
    seen = qs[:, :, None] == ks[:, None, :]
    if causal:
        t = torch.arange(sq, device=qs.device)[:, None]
        j = torch.arange(sk, device=qs.device)[None, :]
        seen &= (j <= t + (sk - sq))[None]
    return seen


def _ulps(x, bits: int):
    """One ulp of each value of ``x`` in a type with ``bits`` mantissa
    bits (0 where ``x`` is 0)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
                      - bits)


def row_reading(got, want) -> float:
    """Largest ratio of an element's error to its own limit (<= 1
    passes): 2 ulps of the plain value plus 2 ulps of the largest |plain|
    in its row (the last dim: one token of one head; the 16-bit P and dS
    of the second products err relative to the terms of a sum, which
    may cancel below any one of them) plus 1e-4 (the f32 order of
    ``dO·V - delta`` where a row's only key makes it 0).  ``got`` a
    16-bit type."""
    bits = _MANTISSA[str(got.dtype).replace("torch.", "")]
    g32, w32 = got.float(), want.float()
    limit = 2 * _ulps(w32, bits) + 2 * _ulps(
        w32.abs().amax(-1, keepdim=True), bits) + 1e-4
    return ((g32 - w32).abs() / limit).max().item()


def lse_reading(got, want) -> float:
    """Largest ratio of an lse error to 1e-4 · (1 + |plain|) (<= 1
    passes); entries that are -inf in ``want`` are skipped (``_err``
    holds them equal)."""
    import torch
    finite = torch.isfinite(want)
    if not bool(finite.any()):
        return 0.0
    g32, w32 = got.float()[finite], want.float()[finite]
    return ((g32 - w32).abs() / (1e-4 * (1 + w32.abs()))).max().item()


# the flash kernels' first tolerance, relative to max(1, max |plain|): f32
# the summation order; 16-bit types the output cast and the 16-bit P / dS
# of the second products
FLASH_REL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}


def check_pairs(what, dtype, pairs, lses=(), rows=True):
    """Raise unless each (kernel, plain) pair agrees: ``FLASH_REL``, then
    (16-bit ``pairs`` with ``rows``) every element within its own limit
    (``row_reading``) and every lse within 1e-4 relative
    (``lse_reading``).  The largest absolute error, relative error and
    reading."""
    import torch
    dname = str(dtype).replace("torch.", "")
    errs, rels, reads = [], [], [0.0]
    for got, want in (*pairs, *lses):
        err = _err(got, want)
        finite = want[torch.isfinite(want)]
        scale = max(1.0, finite.abs().max().item() if finite.numel()
                    else 0.0)
        if err > FLASH_REL[dname] * scale:
            raise AssertionError(f"{what}: max_abs_err {err} (scale "
                                 f"{scale})")
        errs.append(err)
        rels.append(err / scale)
    if rows and dtype != torch.float32:
        reads += [row_reading(got, want) for got, want in pairs]
    reads += [lse_reading(got, want) for got, want in lses]
    if max(reads) > 1.0:
        raise AssertionError(f"{what}: an element outside its own limit "
                             f"(reading {max(reads)})")
    return max(errs), max(rels), max(reads)


def phase_varlen(card: str):
    """Phase 7b: the segment-id variant of the three flash kernels.  (a)
    Each against its plain version over a sweep (f32 / bf16 / f16, head_dim
    64 / 128, causal and not, MHA and GQA 32 over 8, ragged totals, Sq <
    Sk and Sq > Sk, padding ids, a segment with no keys, ids in no order),
    with rows that see no key exactly 0; and ``flash_attn_unpadded``'s
    kernel route against the reference's dense form.  (b) The main path:
    ``flash_attn_unpadded`` forward and backward through autograd at full
    width, 8 documents in T = 8192 tokens, with every count set to 0 just
    before and read just after (one launch of each kernel, no dense call);
    the result against the plain version over head groups; each kernel
    timed beside its plain version, its bound (visible pairs only) and
    SDPA with the block-diagonal causal mask.  (c) A causal call with
    packs that differ takes the dense form.  Returns the main path's
    launches and each kernel's record."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt3_6_7b, llama_7b
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.nn.functional.attention import (_segment_ids,
                                                          _varlen_dense)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    # (a) the sweep: (B, Sq, Sk, H, KVH)
    shapes = [(1, 200, 200, 4, 4), (2, 264, 264, 32, 8),
              (2, 130, 330, 2, 1), (1, 300, 100, 2, 2)]
    worst, reading = {}, {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype).replace("torch.", "")
        for d in (64, 128):
            for b, sq, sk, h, kvh in shapes:
                for pattern in ("packed", "padding", "no_keys", "scrambled"):
                    qs, ks = _varlen_ids(pattern, b, sq, sk, n)
                    for causal in (True, False):
                        q, k, v, do = _flash_case(g, dtype, b, sq, sk, h, kvh,
                                                  d)
                        kw = dict(causal=causal, q_segments=qs,
                                  k_segments=ks)
                        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
                        delta = (do.float() * out.float()).sum(-1) \
                            .transpose(1, 2).contiguous()
                        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                       delta, **kw)
                        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                            delta, **kw)
                        ro, rl = fa.flash_attention_fwd_reference(q, k, v,
                                                                  **kw)
                        rdq = fa.flash_attention_bwd_dq_reference(
                            q, k, v, do, lse, delta, **kw)
                        rdk, rdv = fa.flash_attention_bwd_dkv_reference(
                            q, k, v, do, lse, delta, **kw)
                        torch.cuda.synchronize()
                        what = (f"dtype={dname} D={d} B={b} Sq={sq} Sk={sk} "
                                f"H={h} KVH={kvh} causal={causal} "
                                f"ids={pattern}")
                        for name, pairs, lses in (
                                (names[0], ((out, ro),), ((lse, rl),)),
                                (names[1], ((dq, rdq),), ()),
                                (names[2], ((dk, rdk), (dv, rdv)), ())):
                            key = f"{name} {dname}"
                            _, rel_, read = check_pairs(
                                f"{name} (segments) disagrees with its "
                                f"plain version at {what}", dtype, pairs,
                                lses)
                            worst[key] = max(worst.get(key, 0.0), rel_)
                            reading[key] = max(reading.get(key, 0.0), read)
                        seen = _seen(qs, ks, causal)
                        blind_q, blind_k = ~seen.any(2), ~seen.any(1)
                        if (bool(out[blind_q].any()) or bool(dq[blind_q].any())
                                or not bool(torch.isneginf(
                                    lse.transpose(1, 2)[blind_q]).all())
                                or bool(dk[blind_k].any())
                                or bool(dv[blind_k].any())):
                            raise AssertionError(
                                f"rows that see no key must give out 0, lse "
                                f"-inf, dq 0, and keys no query sees dk = dv "
                                f"= 0: {what}")
                        n += 1
    log(f"[varlen] segment sweep: {n} cases (f32/bf16/f16 x head_dim 64/128 "
        f"x causal/full x ids packed, padding -1/-2, a segment with no keys, "
        f"in no order x Sq=Sk ragged, GQA 32/8, Sq<Sk, Sq>Sk) within "
        f"tolerance (max abs err over max(1, max |plain|): f32 1e-5, 16-bit "
        f"2e-2; 16-bit elements each within 2 ulps of itself + 2 ulps of "
        f"its row's largest + 1e-4; lse within 1e-4 relative), rows that "
        f"see no key exactly 0; worst relative errors {json.dumps(worst)}; "
        f"worst readings (error over limit) {json.dumps(reading)}")

    # flash_attn_unpadded's kernel route computes the reference's dense
    # form (aligned causal packs: every row sees at least itself)
    cu = _cu((37, 150, 64, 49), dev)
    t = int(cu[-1])
    q, k, v, _ = (x[0] for x in _flash_case(g, torch.float32, 1, t, t, 4, 4,
                                             64))
    flash_attn_unpadded.dense_calls = 0
    got, _ = flash_attn_unpadded(q, k, v, cu, cu, 150, 150, 0.125,
                                 causal=True)
    seg = _segment_ids(cu, t)
    want = _varlen_dense(q, k, v, seg, seg, cu, cu, 0.125, True)
    torch.cuda.synchronize()
    if flash_attn_unpadded.dense_calls != 0:
        raise AssertionError("an aligned causal flash_attn_unpadded call on "
                             "the card took the dense form")
    route_err = check_pairs("flash_attn_unpadded's kernel route disagrees "
                            "with the dense form", torch.float32,
                            ((got, want),))[1]
    log(f"[varlen] flash_attn_unpadded kernel route == dense form (T={t}, "
        f"4 packed sequences, f32, causal): max relative err {route_err:.3g}")

    # (b) the main path at full width
    cfg, lcfg = gpt3_6_7b(), llama_7b()
    h, d = cfg.num_heads, cfg.head_dim
    if (lcfg.num_heads, lcfg.head_dim) != (h, d):
        raise AssertionError("gpt3_6_7b and llama_7b attention widths differ")
    t = sum(VARLEN_DOCS)
    cu = _cu(VARLEN_DOCS, dev)
    scale = 1.0 / d ** 0.5
    q, k, v, do = (x[0] for x in _flash_case(g, torch.bfloat16, 1, t, t, h,
                                             h, d))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    for name in names:
        getattr(fa, name).launches = 0
    flash_attn_unpadded.dense_calls = 0
    out, _ = flash_attn_unpadded(q, k, v, cu, cu, max(VARLEN_DOCS),
                                 max(VARLEN_DOCS), scale, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {name: getattr(fa, name).launches for name in names}
    dense = flash_attn_unpadded.dense_calls
    if dense != 0 or any(n_ != 1 for n_ in launches.values()):
        raise AssertionError(f"one full-width flash_attn_unpadded call must "
                             f"launch each segment kernel once and take no "
                             f"dense form: launches {launches}, dense {dense}")
    shape = (f"flash_attn_unpadded q/k/v [{t},{h},{d}] bf16 causal, "
             f"{len(VARLEN_DOCS)} packed documents {list(VARLEN_DOCS)} "
             f"(gpt3_6_7b / llama_7b attention width)")
    log(f"[varlen] main path: {shape}: launches {json.dumps(launches)}, "
        f"dense calls {dense}")

    # the same call's pieces, uncounted, against the plain version over
    # head groups
    seg = _segment_ids(cu, t)[None]
    q4, k4, v4, do4 = (x.detach()[None] for x in (q, k, v, do))
    kw = dict(causal=True, q_segments=seg, k_segments=seg)
    o2, lse = fa.flash_attention_fwd(q4, k4, v4, scale, **kw)
    if not torch.equal(o2[0], out.detach()):
        raise AssertionError("the forward kernel is not deterministic")
    delta = (do4.float() * o2.float()).sum(-1).transpose(1, 2).contiguous()
    grads = {"q": q.grad[None], "k": k.grad[None], "v": v.grad[None]}

    group = VARLEN_HEAD_GROUP

    def plain(which, h0=0, k_ids=seg):
        """The plain version of one kernel over heads h0 .. h0 + group,
        with key ids ``k_ids``, as (tensors, lse's)."""
        sl = slice(h0, h0 + group)
        args = (q4[:, :, sl], k4[:, :, sl], v4[:, :, sl])
        kw_ = dict(kw, k_segments=k_ids)
        if which == "fwd":
            o_, l_ = fa.flash_attention_fwd_reference(*args, scale, **kw_)
            return (o_,), (l_,)
        bw = (*args, do4[:, :, sl], lse[:, sl], delta[:, sl], scale)
        if which == "dq":
            return (fa.flash_attention_bwd_dq_reference(*bw, **kw_),), ()
        return fa.flash_attention_bwd_dkv_reference(*bw, **kw_), ()

    results = {"fwd": ((out.detach()[None],), (lse,)),
               "dq": ((grads["q"],), ()),
               "dkv": ((grads["k"], grads["v"]), ())}

    def pairs(got, want, h0=None):
        """(kernel, plain) pairs of tensors and of lse's; ``h0`` takes
        heads h0 .. h0 + group of ``got``."""
        (got_t, got_l), (want_t, want_l) = got, want
        if h0 is not None:
            sl = slice(h0, h0 + group)
            got_t = tuple(x[:, :, sl] for x in got_t)
            got_l = tuple(x[:, sl] for x in got_l)
        return tuple(zip(got_t, want_t)), tuple(zip(got_l, want_l))

    # each element held to its own limit (``row_reading``, lse 1e-4
    # relative), head group by head group
    errs = {}
    for name, which in zip(names, ("fwd", "dq", "dkv")):
        per_group = [check_pairs(f"{name} (segments) at {shape}, heads "
                                 f"{h0}-{h0 + group - 1}", torch.bfloat16,
                                 *pairs(results[which], plain(which, h0),
                                        h0))
                     for h0 in range(0, h, group)]
        errs[name] = tuple(max(e[i] for e in per_group) for i in range(3))
    # planted faults, on the first head group: the plain version with the
    # key ids changed stands for a kernel that (drop) skips the boundary
    # tile of the first document that ends inside a 64-key tile, so that
    # document's keys in it are seen by no query, or (leak) shows that
    # document's last 8 keys to the next document's queries.  Each must
    # read far above the limit, the sound run below it.
    ends = np.cumsum(VARLEN_DOCS)
    doc = int(np.argmax(ends % 64 != 0))
    end = int(ends[doc])
    drop, leak = seg.clone(), seg.clone()
    drop[0, end // 64 * 64:end] = -2
    leak[0, end - 8:end] = doc + 1
    faults = {}
    for fault, k_ids in (("drop", drop), ("leak", leak)):
        for name, which in zip(names, ("fwd", "dq", "dkv")):
            ts, ls = pairs(plain(which, k_ids=k_ids), plain(which))
            faults[f"{name} {fault}"] = max(
                [row_reading(g_, w_) for g_, w_ in ts]
                + [lse_reading(g_, w_) for g_, w_ in ls])
    missed = {k_: r for k_, r in faults.items() if r <= 1.0}
    if missed:
        raise AssertionError(f"the varlen check does not reject a planted "
                             f"fault: readings {missed}")
    log(f"[varlen] main-path check, each element within 2 ulps of itself + "
        f"2 ulps of its row's largest + 1e-4, lse within 1e-4 relative: "
        f"sound readings (error over limit) "
        f"{json.dumps({n_: errs[n_][2] for n_ in names})}; planted faults "
        f"on heads 0-{group - 1} (drop: document {doc}'s keys "
        f"{end // 64 * 64}-{end - 1} seen by no query; leak: its keys "
        f"{end - 8}-{end - 1} seen by document {doc + 1}) read "
        f"{json.dumps(faults)}")
    torch.cuda.empty_cache()

    times = {
        names[0]: time_ms(lambda: fa.flash_attention_fwd(q4, k4, v4, scale,
                                                         **kw)),
        names[1]: time_ms(lambda: fa.flash_attention_bwd_dq(
            q4, k4, v4, do4, lse, delta, scale, **kw)),
        names[2]: time_ms(lambda: fa.flash_attention_bwd_dkv(
            q4, k4, v4, do4, lse, delta, scale, **kw)),
    }
    plain_ms = {name: time_ms(lambda: [plain(which, h0)
                                       for h0 in range(0, h, group)],
                              iters=2, warmup=1, windows=3)
                for name, which in zip(names, ("fwd", "dq", "dkv"))}
    # the yardstick: SDPA with the boolean block-diagonal causal mask, on
    # the same tensors transposed; its output checked against the kernel's
    mask = _seen(seg, seg, True)[0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q4, k4, v4))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    check_pairs(f"SDPA with the block-diagonal causal mask at {shape}",
                torch.bfloat16, ((out.detach()[None].transpose(1, 2), o_lib),),
                rows=False)
    do_t = do4.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    del o_lib, qt, kt, vt, mask
    visible = sum(n_ * (n_ + 1) // 2 for n_ in VARLEN_DOCS)
    walk = t * (t + 1) // 2
    ids = seg[0].cpu().numpy()
    # a model of each kernel's walk, not counted on the card: the tiles
    # it visits (one segment: the causal walk) and computes (the rest it
    # skips) with the tile sizes of csrc/flash_attention.cu, each block's
    # two consumer groups computing only the tiles their ids overlap (the
    # walk, with no block barrier per tile, loads only those): fwd
    # 128-key tiles by 128-query blocks (groups of 64 rows);
    # dq 64-key tiles by 128-query blocks (groups of 64 rows); dkv
    # 64-query tiles by 128-key blocks (groups of 64 keys)
    tiles = ((128, 128, False, 2), (128, 64, False, 2), (64, 128, True, 2))
    work = {name: tile_pairs(ids, *tile) for name, tile in zip(names, tiles)}
    visits = {name: tile_pairs(np.zeros_like(ids), *tile[:3]) // (tile[0] *
                                                                  tile[1])
              for name, tile in zip(names, tiles)}
    bounds = flash_bounds(1, t, t, h, h, d, True, 2, pairs=visible,
                          ids_bytes=2 * t * 4)
    recs = {}
    for name in names:
        bound, bound_by = bounds[name]
        recs[name] = {
            "ms": times[name], "plain_ms": plain_ms[name],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_fwd if name == names[0] else None,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "max_reading": errs[name][2],
            "planted_fault_readings": {k_.split()[-1]: r for k_, r in
                                       faults.items() if k_.startswith(name)},
            "shape": shape,
            "sweep_max_rel_err": {k_: e for k_, e in worst.items()
                                  if k_.startswith(name)},
            "sweep_max_reading": {k_: e for k_, e in reading.items()
                                  if k_.startswith(name)}}
        if name != names[0]:
            recs[name]["library_ms_dq_dkv_together"] = lib_bwd
        log(f"[varlen] {name} (segments) at {shape}: kernel "
            f"{times[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}, {visible} visible pairs per head "
            f"of {walk} in the global causal walk; by the model of its walk "
            f"(tile_pairs, not counted on the card) its tiles cover "
            f"{work[name]} pairs and it visits {visits[name]} tiles per "
            f"head); max abs err {errs[name][0]:.3g}, relative "
            f"{errs[name][1]:.3g}, reading {errs[name][2]:.3g} (card: "
            f"{card})")
    log(f"[varlen] library yardsticks at {shape}: SDPA with the [{t},{t}] "
        f"block-diagonal causal mask forward {lib_fwd:.4f} ms, backward (dq, "
        f"dk, dv together) {lib_bwd:.4f} ms vs the port's dq + dkv "
        f"{times[names[1]] + times[names[2]]:.4f} ms (card: {card})")
    del q, k, v, do, out, q4, k4, v4, do4, o2, lse, delta, grads
    torch.cuda.empty_cache()

    # (c) causal packs that differ: per-sequence causal, the dense form
    cu_q, cu_k = _cu((700, 800, 548), dev), _cu((1000, 1048), dev)
    t = int(cu_q[-1])
    q, k, v, _ = (x[0] for x in _flash_case(g, torch.bfloat16, 1, t, t, h,
                                             h, d))
    for name in names:
        getattr(fa, name).launches = 0
    flash_attn_unpadded.dense_calls = 0
    out, _ = flash_attn_unpadded(q, k, v, cu_q, cu_k, 1000, 1048, scale,
                                 causal=True)
    torch.cuda.synchronize()
    counts = {name: getattr(fa, name).launches for name in names}
    if (flash_attn_unpadded.dense_calls != 1 or any(counts.values())
            or out.shape != q.shape or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"a causal call with packs that differ must take "
                             f"the dense form once and give finite values: "
                             f"dense {flash_attn_unpadded.dense_calls}, "
                             f"launches {counts}")
    log(f"[varlen] causal, q packs {cu_q.tolist()} vs k packs "
        f"{cu_k.tolist()}: dense form (1 call, no kernel launch), finite "
        f"[{t},{h},{d}]")
    return launches, recs


def phase_train(card: str, family: str):
    """Train the family's published widths with 12 of their 32 layers
    (``TRAIN_LAYERS``) on one repeated batch with
    ``FusedAdamW(multi_precision=True)``: ``GPTHybridTrainer`` on gpt3_6_7b
    at batch 2 x 2048, or ``LlamaForCausalLM(llama_7b())`` through
    ``llama_train_step`` at batch 1 x 4096.  Warm-up steps, then the
    measured steps with every kernel count set to 0 just before them and
    read just after.  Returns the counts and the metrics."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from paddle_tpu_torch.kernels.fused_adamw import fused_adamw
    from paddle_tpu_torch.models import (GPTHybridTrainer, LlamaForCausalLM,
                                         gpt3_6_7b, llama_7b)
    from paddle_tpu_torch.optimizer import FusedAdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4321)
    t0 = time.perf_counter()
    optimizer = FusedAdamW(learning_rate=TRAIN_LR, multi_precision=True)
    tag = f"[train:{family}]"
    if family == "gpt":
        cfg = dataclasses.replace(gpt3_6_7b(remat=False),
                                  num_layers=TRAIN_LAYERS)
        batch, seq = TRAIN_BATCH, TRAIN_SEQ
        tr = GPTHybridTrainer(cfg, optimizer=optimizer, device=DEVICE,
                              generator=gen)
        model, opt, step = tr.model, tr.opt, tr.train_step
        ids, labels = tr.make_batch(batch, seq, seed=0)
        norm = "layer_norm"
        widths = (f"gpt3_6_7b widths: hidden {cfg.hidden_size}, "
                  f"{cfg.num_heads} heads x {cfg.head_dim}, ffn "
                  f"{cfg.ffn_size}")
        # every layer's qkv weight: attention's gradient reaches it
        nonzero = [n for n, _ in model.named_parameters()
                   if n.endswith("qkv.weight")]
    else:
        cfg = dataclasses.replace(llama_7b(), num_layers=TRAIN_LAYERS,
                                  remat=False)
        batch, seq = LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ
        model = LlamaForCausalLM(cfg, device=DEVICE, generator=gen).train()
        opt = optimizer.bind(model)

        def step(ids, labels):
            return llama_train_step(model, opt, ids, labels)
        ids, labels = llama_batch(cfg.vocab_size, batch, seq, 0, DEVICE)
        norm = "rms_norm"
        widths = (f"llama_7b widths: hidden {cfg.hidden_size}, "
                  f"{cfg.num_heads} heads x {cfg.head_dim}, ffn "
                  f"{cfg.intermediate_size}")
        # every RMSNorm weight: the norm backward kernel's dw reaches it
        nonzero = [n for n, _ in model.named_parameters()
                   if n.endswith("layernorm.weight")
                   or n == "llama.norm.weight"]
    torch.cuda.synchronize()
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    log(f"{tag} {widths}, {cfg.num_layers} of 32 layers, vocab "
        f"{cfg.vocab_size}, bf16 with f32 masters and moments, "
        f"{n_params / 1e9:.3f}B params in {len(params)} tensors, built in "
        f"{time.perf_counter() - t0:.1f} s; batch {batch} x {seq}")
    losses = [float(step(ids, labels)) for _ in range(TRAIN_WARMUP)]
    kernels = (flash_attention_fwd, flash_attention_bwd_dq,
               flash_attention_bwd_dkv, fused_adamw,
               *(getattr(fn, k) for k in NORM_KERNELS))
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(float(step(ids, labels)))   # synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    layers = cfg.num_layers
    norms = 2 * layers + 1
    want = {"flash_attention_fwd": layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": layers * TRAIN_STEPS,
            "fused_adamw": len(params) * TRAIN_STEPS,
            **{k: 0 for k in NORM_KERNELS},
            f"{norm}_fwd": norms * TRAIN_STEPS,
            f"{norm}_bwd": norms * TRAIN_STEPS}
    log(f"{tag} losses {[round(x, 4) for x in losses]}; launches "
        f"{json.dumps(launches)} (want {layers} layers x {TRAIN_STEPS} "
        f"steps for each flash kernel, {norms} norms x {TRAIN_STEPS} steps "
        f"for {norm}_fwd/_bwd, {len(params)} tensors x {TRAIN_STEPS} steps "
        f"for fused_adamw)")
    if launches != want:
        raise AssertionError(f"{tag} kernel launches {launches} != {want}: "
                             f"the train step bypassed a kernel")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} losses must be finite and fall: "
                             f"{losses}")
    # one more forward/backward (not counted): every parameter gets a
    # finite gradient and each of ``nonzero`` a nonzero one; then one
    # optimizer step over all of them, timed
    loss = model.loss(ids, labels)
    loss.backward()
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{tag} {name} has no finite gradient")
        if name in nonzero and not bool((p.grad != 0).any()):
            raise AssertionError(f"{tag} {name} has an all-zero gradient")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.step()
    end.record()
    torch.cuda.synchronize()
    opt_ms = start.elapsed_time(end)
    opt.clear_grad()
    opt_bound = n_params * 28 / HBM_BYTES_PER_S * 1e3
    tokens = batch * seq
    p50 = float(np.median(step_ms))
    tok_s = tokens / (p50 / 1e3)
    # N of PERF.md's formula counts the weights that enter a matmul: GPT's
    # input embedding is tied to its head, Llama's is a lookup only
    n_matmul = n_params - (model.llama.embed_tokens.weight.numel()
                           if family == "llama" else 0)
    flops_per_token = 6 * n_matmul + 12 * layers * cfg.hidden_size * seq
    mfu = flops_per_token * tok_s / PEAK_FLOPS["bfloat16"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"layers": layers, "params": n_params,
           "param_tensors": len(params), "batch": batch, "seq": seq,
           "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": tok_s, "mfu": mfu, "mfu_params": n_matmul,
           "optimizer_step_ms": opt_ms,
           "optimizer_step_bound_ms": opt_bound, "peak_mem_gb": peak_gb,
           "nonzero_grads_checked": len(nonzero)}
    log(f"{tag} step p50 {p50:.1f} ms over {TRAIN_STEPS} steps "
        f"({[round(x, 1) for x in step_ms]}), {tok_s:.0f} tokens/s, "
        f"model-FLOP share {mfu:.3f} of 989 TFLOP/s (N = "
        f"{n_matmul / 1e9:.3f}B matmul params); one FusedAdamW step over "
        f"{n_params / 1e9:.3f}B params {opt_ms:.2f} ms (bound "
        f"{opt_bound:.2f} ms, bytes); peak memory {peak_gb:.1f} GB "
        f"(card: {card})")
    res["profile"] = profile_train(step, ids, labels, card, family)
    del model, opt, step, loss, params
    if family == "gpt":
        del tr
    torch.cuda.empty_cache()
    return launches, res


def profile_train(step, ids, labels, card: str, family: str) -> dict:
    """One train step under torch.profiler: wall time, the device busy
    share (summed kernel time over wall time) and the kernels that take
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(ids, labels))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_ms(prof)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    # the trainer's own ranges (the clip): the device time of the kernels
    # launched inside each, summed over the step
    ranges = {}
    for e in prof.events():
        if e.name.startswith("GPTHybridTrainer.") and \
                e.device_type == DeviceType.CPU:
            ranges[e.name] = ranges.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    # kernel time by kind: cuBLAS GEMMs, the port's flash and AdamW
    # kernels, and everything else (eager elementwise, reductions, copies)
    kinds = {"gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
             "flash": ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                       "dkv_wgmma_kernel"),
             "adamw": ("adamw_kernel",),
             "norm": ("rms_fwd_kernel", "ln_fwd_", "norm_bwd_")}
    by_kind = {kind: 0.0 for kind in (*kinds, "other")}
    for name, ms in kernels.items():
        kind = next((k for k, pats in kinds.items()
                     if any(x in name for x in pats)), "other")
        by_kind[kind] += ms
    out = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "device_ms_by_kind": by_kind,
           "top_kernels_ms": {k[:90]: v for k, v in top}}
    if busy_ms:
        out["ranges_ms"] = ranges
    if busy_ms == 0.0:
        log(f"[profile:train:{family}] the profiler saw no device time: "
            f"device busy share not measured")
    else:
        log(f"[profile:train:{family}] one train step under torch.profiler: "
            f"{wall_ms:.1f} ms wall, {busy_ms:.1f} ms of kernels, device busy "
            f"share {out['busy_share']:.3f}; device ms by kind "
            f"{json.dumps({k: round(v, 3) for k, v in by_kind.items()})} "
            f"(card: {card})")
        for name, ms in out["top_kernels_ms"].items():
            log(f"[profile:train:{family}]   {ms:9.3f} ms  {name}")
    return out


def llama_train_step(model, opt, ids, labels):
    """The Llama train step a user writes: forward, ``loss``, backward,
    one optimizer step, gradients cleared (``GPTHybridTrainer.train_step``
    for GPT).  Returns the detached loss."""
    loss = model.loss(ids, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def llama_batch(vocab: int, batch: int, seq: int, seed: int, device):
    """``(ids, labels)``: the reference trainer's draw, ``RandomState(seed)
    .randint(0, vocab, (batch, seq + 1))`` shifted by one."""
    import numpy as np
    import torch
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, vocab, (batch, seq + 1)), dtype=torch.long).to(device)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def phase_train_parity(family: str) -> dict:
    """An f32 model of gpt_small width (``GPTHybridTrainer``) or the
    parity Llama (``llama_train_step``), 2 layers, seq 256 (TF32 off): two
    ``FusedAdamW`` train steps on the card (kernels) and the same steps
    from the same weights on the CPU (plain versions).  Losses agree at
    rtol 1e-5.  Parameters: Adam's step is lr times a ratio of gradient
    moments, so an element whose gradient is near zero (rounding noise
    and cancellation: the key slice of qkv.bias has an exact gradient of
    0) turns a small relative difference of its gradient into one of
    O(lr); every element is held to Adam's bound, 2·lr per step, and all
    but 1e-4 of them to atol 1e-6 (1% of lr)."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTHybridTrainer, gpt_small
    from paddle_tpu_torch.optimizer import FusedAdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    lr, steps = 1e-4, 2
    runs = {}
    for where in ("cpu", DEVICE):
        if family == "gpt":
            gen = torch.Generator(device=where)
            gen.manual_seed(6)
            cfg = dataclasses.replace(gpt_small(remat=False), num_layers=2)
            tr = GPTHybridTrainer(cfg,
                                  optimizer=FusedAdamW(learning_rate=lr),
                                  device=where, generator=gen)
            model = tr.model
            ids, labels = tr.make_batch(2, 256, seed=1)
            step = tr.train_step
        else:
            model = parity_model("llama", where).train()
            opt = FusedAdamW(learning_rate=lr).bind(model)
            ids, labels = llama_batch(model.cfg.vocab_size, 2, 256, 1, where)

            def step(ids, labels, model=model, opt=opt):
                return llama_train_step(model, opt, ids, labels)
        if where == "cpu":
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        losses = [float(step(ids, labels)) for _ in range(steps)]
        runs[where] = (losses, {k: v.detach().cpu() for k, v in
                                model.state_dict().items()})
        del model, step
    (lc, pc), (lg, pg) = runs["cpu"], runs[DEVICE]
    tag = f"[train-parity:{family}]"
    if not np.allclose(lg, lc, rtol=1e-5, atol=0.0):
        raise AssertionError(f"{tag} losses card {lg} vs CPU {lc}")
    worst, off, total = 0.0, 0, 0
    for k in pc:
        diff = (pg[k] - pc[k]).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > 1e-6).sum())
        total += diff.numel()
    if worst > 2 * lr * steps or off > 1e-4 * total:
        raise AssertionError(f"{tag} parameters: max diff {worst}, {off} of "
                             f"{total} elements beyond 1e-6")
    what = ("gpt_small width" if family == "gpt" else
            f"Llama {json.dumps(LLAMA_PARITY)}")
    log(f"{tag} {what}, 2 layers, f32, seq 256, {steps} FusedAdamW steps: "
        f"losses card {lg} vs CPU {lc} (rtol 1e-5); parameters max diff "
        f"{worst:.3g} (bound 2·lr·steps = {2 * lr * steps:.1g}), {off} of "
        f"{total} elements beyond 1e-6")
    return {"losses_card": lg, "losses_cpu": lc, "param_max_diff": worst,
            "param_elements_beyond_1e-6": off, "param_elements": total}


HYBRID_LAYERS = 8
HYBRID_BATCH, HYBRID_SEQ = 4, 2048
HYBRID_WARMUP, HYBRID_STEPS = 2, 6
# (label, hybrid_configs or None for the serial trainer, microbatches,
# zero_stage, vpp)
HYBRID_RUNS = (("serial", None, 1, 1, 1),
               ("mp2_pp2", {"mp_degree": 2, "pp_degree": 2}, 4, 1, 1),
               ("pp2_sharding2_zero3_vpp2",
                {"pp_degree": 2, "sharding_degree": 2}, 4, 3, 2))
HYBRID_PARITY = (("dp2_mp2_pp2",
                  {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, 2, 1, 1),
                 HYBRID_RUNS[2])
HYBRID_PARITY_LAYERS, HYBRID_PARITY_BATCH, HYBRID_PARITY_SEQ = 4, 8, 256
HYBRID_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "layer_norm_fwd",
                  "layer_norm_bwd", "fused_adamw")


def hybrid_trainer(cfg, hybrid, microbatches, zero, vpp, opt, seed: int):
    """``GPTHybridTrainer`` as a fleet script builds it: the strategy's
    ``hybrid_configs``, ``fleet.init`` with every rank on this card,
    ``get_hybrid_communicate_group()``; ``hybrid=None`` is the serial
    trainer.  The weights come from a generator seeded with ``seed``, so
    every configuration starts from the same ones."""
    import math

    import torch
    from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                              get_hybrid_communicate_group)
    from paddle_tpu_torch.models import GPTHybridTrainer
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    if hybrid is None:
        return GPTHybridTrainer(cfg, optimizer=opt, device=DEVICE,
                                generator=gen)
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    fleet.init(is_collective=True, strategy=s,
               devices=[DEVICE] * math.prod(hybrid.values()))
    return GPTHybridTrainer(cfg, get_hybrid_communicate_group(), opt,
                            microbatches=microbatches, zero_stage=zero,
                            vpp=vpp, generator=gen)


def hybrid_want(cfg, hybrid, microbatches, zero, vpp, batch) -> dict:
    """Each kernel's launches in one train step, from the layout: the
    microbatch rows each batch group (dp x sharding) takes (XLA's split:
    ceil(rows / groups), none for a group past the rows), each block's
    attention and norms once per mp rank, ln_f once per vocab shard (mp x
    pp), and one AdamW launch per slice updated, once per card: a block
    of an mp-split tensor, the wte / wpe rows over mp x pp, ZeRO's slices
    (the ``sharding`` dim ``shard_opt_state_specs`` picks on the stacked
    layout; the stacked layer dim hands whole blocks to one rank).  Under
    ``cfg.remat`` the backward runs each block's forward again: its flash
    forward and its two LayerNorm forwards twice a step (ln_f once).
    ``cfg.sp`` changes no count (each rank's norms run on its s/mp
    rows)."""
    deg = {a: (hybrid or {}).get(f"{a}_degree", 1)
           for a in ("dp", "mp", "pp", "sharding")}
    mp, S, D = deg["mp"], deg["pp"], deg["sharding"]
    G, L = deg["dp"] * D, cfg.num_layers
    M = microbatches if S > 1 else 1
    mb = batch // M
    per = -(-mb // G)
    units = M * sum(1 for g in range(G) if g * per < mb)
    vocab = mp * S if hybrid else 1
    h, f = cfg.hidden_size, cfg.ffn_size
    interleave = S > 1 and vpp > 1
    K = L // (S * vpp) if interleave else L // S
    # per block: (shape, mp-split dim or None)
    block = [((h,), None)] * 4 + [((h, 3 * h), 1), ((3 * h,), 0),
                                  ((h, h), 0), ((h,), None),
                                  ((h, f), 1), ((f,), 0), ((f, h), 0),
                                  ((h,), None)]
    lead = (S * vpp, K) if interleave else (L,)
    adamw = 0
    for shape, split in block:
        blocks = mp if (hybrid and split is not None) else 1
        taken = ([S > 1, False] if interleave else [S > 1]) + \
            [i == split for i in range(len(shape))]
        slices = 1
        if hybrid and D > 1:
            for i, n in enumerate(lead + shape):
                if not taken[i] and n % D == 0 and n >= D:
                    slices = 1 if i < len(lead) else D
                    break
        adamw += L * blocks * slices
    for shape, rows in (((cfg.vocab_size, h), True),
                        ((cfg.max_seq_len, h), True), ((h,), False),
                        ((h,), False)):
        blocks = vocab if rows else 1
        free = shape[1:] if rows and hybrid else shape
        slices = D if hybrid and D > 1 and any(
            n % D == 0 and n >= D for n in free) else 1
        adamw += blocks * slices
    flash = L * units * mp
    norms = units * (2 * L * mp + vocab)
    rec = 2 if cfg.remat else 1
    return {"flash_attention_fwd": rec * flash,
            "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash,
            "layer_norm_fwd": units * (rec * 2 * L * mp + vocab),
            "layer_norm_bwd": norms, "fused_adamw": adamw}


def _hybrid_params_close(got: dict, want: dict, bound: float) -> tuple:
    worst, off, total = 0.0, 0, 0
    for k, w in want.items():
        diff = (got[k].detach().float().cpu() - w.float().cpu()).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > 1e-6).sum())
        total += diff.numel()
    return worst <= bound, worst, off, total


def phase_train_hybrid(card: str) -> dict:
    """The hybrid-parallel trainer through the entry points a fleet script
    calls, every rank on this card: the f32 parity checks, then the
    gpt3_6_7b-width runs (``HYBRID_RUNS``), one trainer at a time, each
    freed before the next is built.  Returns the records and each run's
    launches over the timed steps."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adamw as fw
    from paddle_tpu_torch.models import gpt3_6_7b, gpt_small
    from paddle_tpu_torch.optimizer import FusedAdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = [getattr(fa, k) for k in HYBRID_KERNELS[:3]] + \
        [getattr(fn, k) for k in HYBRID_KERNELS[3:5]] + [fw.fused_adamw]
    out = {"parity": {}, "runs": {}}
    # f32 parity at gpt_small width
    lr, steps = 1e-4, 2
    cfg = dataclasses.replace(gpt_small(remat=False),
                              num_layers=HYBRID_PARITY_LAYERS)
    ref = hybrid_trainer(cfg, None, 1, 1, 1, FusedAdamW(learning_rate=lr), 7)
    ids, labels = ref.make_batch(HYBRID_PARITY_BATCH, HYBRID_PARITY_SEQ,
                                 seed=2)
    want_losses = [float(ref.train_step(ids, labels)) for _ in range(steps)]
    want_params = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    del ref
    free_card()
    for label, hybrid, m, zero, vpp in HYBRID_PARITY:
        tr = hybrid_trainer(cfg, hybrid, m, zero, vpp,
                            FusedAdamW(learning_rate=lr), 7)
        losses = [float(tr.train_step(ids, labels)) for _ in range(steps)]
        ok, worst, off, total = _hybrid_params_close(
            tr.state_dict(), want_params, 2 * lr * steps)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
        log(f"[train:hybrid] parity {label} (gpt_small width, "
            f"{cfg.num_layers} layers, f32, seq {HYBRID_PARITY_SEQ}, batch "
            f"{HYBRID_PARITY_BATCH}, {m} microbatches, zero {zero}, vpp "
            f"{vpp}): losses {losses} vs serial {want_losses} (relative "
            f"{rel}); parameters max diff {worst:.3g} (bound 2·lr·steps = "
            f"{2 * lr * steps:.1g}), {off} of {total} elements beyond 1e-6")
        if not (rel[0] <= 2e-4 and rel[1] <= 2e-3 and ok):
            raise AssertionError(f"[train:hybrid] parity {label}: losses "
                                 f"{losses} vs {want_losses}, parameter "
                                 f"max diff {worst}")
        out["parity"][label] = {"losses": losses, "serial": want_losses,
                                "relative": rel, "param_max_diff": worst,
                                "beyond_1e-6": off, "elements": total}
        del tr
        topology.set_hybrid_communicate_group(None)
        free_card()
    # gpt3_6_7b widths at HYBRID_LAYERS layers
    cfg = dataclasses.replace(gpt3_6_7b(remat=False),
                              num_layers=HYBRID_LAYERS)
    launches = {}
    serial_first = None
    for label, hybrid, m, zero, vpp in HYBRID_RUNS:
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = hybrid_trainer(cfg, hybrid, m, zero, vpp,
                            FusedAdamW(learning_rate=TRAIN_LR,
                                       multi_precision=True), 4321)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        built_gb = (torch.cuda.memory_allocated() - base) / 1e9
        ids, labels = tr.make_batch(HYBRID_BATCH, HYBRID_SEQ, seed=0)
        losses = [float(tr.train_step(ids, labels))
                  for _ in range(HYBRID_WARMUP)]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        step_ms = []
        for _ in range(HYBRID_STEPS):
            t = time.perf_counter()
            losses.append(float(tr.train_step(ids, labels)))
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in zip(HYBRID_KERNELS, kernels)}
        want = {k: v * HYBRID_STEPS for k, v in hybrid_want(
            cfg, hybrid, m, zero, vpp, HYBRID_BATCH).items()}
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        n_params = cfg.num_params()
        p50 = float(np.median(step_ms))
        tok_s = HYBRID_BATCH * HYBRID_SEQ / (p50 / 1e3)
        flops = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * \
            HYBRID_SEQ
        mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
        if serial_first is None:
            serial_first = losses[0]
        gap = abs(losses[0] - serial_first) / abs(serial_first)
        rec = {"hybrid": hybrid, "microbatches": m, "zero_stage": zero,
               "vpp": vpp, "losses": losses, "step1_gap": gap,
               "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": tok_s,
               "mfu": mfu, "built_gb": built_gb, "peak_gb": peak_gb,
               "build_s": build_s, "stage_calls": tr.stage_calls,
               "launches_per_step": {k: v / HYBRID_STEPS
                                     for k, v in got.items()},
               "launches_per_step_want": {k: v / HYBRID_STEPS
                                          for k, v in want.items()}}
        out["runs"][label] = rec
        log(f"[train:hybrid] {label} (gpt3_6_7b widths, {cfg.num_layers} "
            f"of 32 layers, bf16, batch {HYBRID_BATCH} x {HYBRID_SEQ}, "
            f"{m} microbatches, zero {zero}, vpp {vpp}): step p50 "
            f"{p50:.1f} ms ({[round(x, 1) for x in step_ms]}), "
            f"{tok_s:.0f} tokens/s, model-FLOP share {mfu:.3f}; memory "
            f"after the build {built_gb:.2f} GB (built in {build_s:.1f} s), "
            f"peak {peak_gb:.2f} GB; losses {[round(x, 5) for x in losses]}"
            f", step 1 relative gap to serial {gap:.2e}; launches a step "
            f"{json.dumps(rec['launches_per_step'])} (want "
            f"{json.dumps(rec['launches_per_step_want'])}) (card: {card})")
        if got != want:
            raise AssertionError(f"[train:hybrid] {label}: launches {got} "
                                 f"!= the layout's {want}")
        if not all(np.isfinite(losses)) or gap >= 1e-2:
            raise AssertionError(f"[train:hybrid] {label}: losses {losses} "
                                 f"(step 1 gap to serial {gap})")
        launches[label] = got
        rec["profile"] = profile_train(tr.train_step, ids, labels, card,
                                       f"hybrid:{label}")
        del tr
        topology.set_hybrid_communicate_group(None)
    free_card()
    return launches, out


EXAMPLE_HYBRID = {"mp_degree": 2, "pp_degree": 2}
EXAMPLE_LR, EXAMPLE_CLIP = 1e-3, 1.0
# (a): the first steps held against sp=False, remat=False from the same
# weights, each loss to this relative gap: 5x the larger reading PERF.md
# records (step 1 is exact; after an update sp's backward sums the mp
# ranks' bf16 gradients in another order, and Adam moves the elements
# whose gradient is rounding noise by up to 2 lr)
EXAMPLE_PARITY_STEPS, EXAMPLE_GAP_LIMIT = 3, 1e-3
# (b): the deepest serial depth whose remat peak PERF.md reckons under
# ~72 GB, at a batch whose no-remat peak it reckons well over 80 GB
REMAT_DEEP_LAYERS, REMAT_DEEP_STEPS = 18, 2
REMAT_DEEP_BATCH, REMAT_DEEP_SEQ = 8, 2048
# (c): auto-resume at 2 layers (the least that splits over pp 2), steps
# 3-4 to this relative gap from the straight run's (5x the larger
# reading PERF.md records)
RESUME_LAYERS, RESUME_GAP_LIMIT = 2, 1e-4


def example_optimizer():
    """The optimizer of ``paddle_tpu_torch/examples/train_gpt_hybrid.py``
    for a bf16 config: ``FusedAdamW(learning_rate=1e-3, grad_clip=
    ClipGradByGlobalNorm(1.0), multi_precision=True)``."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, FusedAdamW
    return FusedAdamW(learning_rate=EXAMPLE_LR, multi_precision=True,
                      grad_clip=ClipGradByGlobalNorm(EXAMPLE_CLIP))


def example_main_path(card: str, kernels) -> tuple:
    """(a): the example's flow at gpt3_6_7b widths, ``HYBRID_LAYERS``
    layers (as ``phase_train_hybrid``'s ``{mp 2, pp 2}`` run), bf16, batch
    4 x 2048, ``{mp 2, pp 2}``, 4 microbatches,
    ``sp=True, remat=True``, the clipped ``FusedAdamW``, every rank on the
    card.  First ``EXAMPLE_PARITY_STEPS`` steps with ``sp=False,
    remat=False`` from the same weights (the same arithmetic), held to the
    example's first steps (the later ones after the clipped updates, so
    they read sp's and remat's backward and the clip); then 2 warm-up and
    6 timed steps, the
    counts zeroed just before and read just after and held to
    ``hybrid_want``; one step profiled, the clip's own device time from
    its ``record_function`` range."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import (get_hybrid_communicate_group,
                                              topology)
    from paddle_tpu_torch.models import gpt3_6_7b
    from paddle_tpu_torch.models.trainer import CLIP_RANGE
    tag = "[train:example]"
    m = max(2 * EXAMPLE_HYBRID["pp_degree"], 2)
    base = dataclasses.replace(gpt3_6_7b(), num_layers=HYBRID_LAYERS)
    plain_cfg = dataclasses.replace(base, sp=False, remat=False)
    tr = hybrid_trainer(plain_cfg, EXAMPLE_HYBRID, m, 1, 1,
                        example_optimizer(), 4321)
    ids, labels = tr.make_batch(HYBRID_BATCH, HYBRID_SEQ, seed=0)
    plain = [float(tr.train_step(ids, labels))
             for _ in range(EXAMPLE_PARITY_STEPS)]
    del tr
    topology.set_hybrid_communicate_group(None)
    free_card()
    cfg = dataclasses.replace(base, sp=True, remat=True)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = hybrid_trainer(cfg, EXAMPLE_HYBRID, m, 1, 1, example_optimizer(),
                        4321)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    mesh = dict(get_hybrid_communicate_group().get_mesh().shape)
    losses = [float(tr.train_step(ids, labels))
              for _ in range(HYBRID_WARMUP)]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    step_ms = []
    for _ in range(HYBRID_STEPS):
        t = time.perf_counter()
        losses.append(float(tr.train_step(ids, labels)))
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    got = {name: k.launches for name, k in zip(HYBRID_KERNELS, kernels)}
    want = {k: v * HYBRID_STEPS for k, v in hybrid_want(
        cfg, EXAMPLE_HYBRID, m, 1, 1, HYBRID_BATCH).items()}
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    p50 = float(np.median(step_ms))
    tok_s = HYBRID_BATCH * HYBRID_SEQ / (p50 / 1e3)
    flops = 6 * cfg.num_params() + 12 * cfg.num_layers * cfg.hidden_size * \
        HYBRID_SEQ
    mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    rec = {"mesh": mesh, "microbatches": m, "sp": True, "remat": True,
           "clip": EXAMPLE_CLIP, "losses": losses, "plain_losses": plain,
           "plain_gaps": gaps, "plain_gap_limit": EXAMPLE_GAP_LIMIT,
           "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": tok_s,
           "mfu": mfu, "built_gb": built_gb, "peak_gb": peak_gb,
           "build_s": build_s, "stage_calls": tr.stage_calls,
           "launches_per_step": {k: v / HYBRID_STEPS for k, v in got.items()},
           "launches_per_step_want": {k: v / HYBRID_STEPS
                                      for k, v in want.items()}}
    log(f"{tag} mesh {json.dumps(mesh)}; gpt3_6_7b widths, "
        f"{cfg.num_layers} of 32 layers, bf16, batch {HYBRID_BATCH} x "
        f"{HYBRID_SEQ}, {m} microbatches, sp, remat, FusedAdamW with "
        f"ClipGradByGlobalNorm({EXAMPLE_CLIP}): step p50 {p50:.1f} ms "
        f"({[round(x, 1) for x in step_ms]}), {tok_s:.0f} tokens/s, "
        f"model-FLOP share {mfu:.3f}; memory after the build {built_gb:.2f} "
        f"GB (built in {build_s:.1f} s), peak {peak_gb:.2f} GB; losses "
        f"{[round(x, 5) for x in losses]}, relative gaps of steps 1-"
        f"{EXAMPLE_PARITY_STEPS} to sp=False remat=False "
        f"{[f'{x:.2e}' for x in gaps]} ({plain}, limit "
        f"{EXAMPLE_GAP_LIMIT}); launches a step "
        f"{json.dumps(rec['launches_per_step'])} (want "
        f"{json.dumps(rec['launches_per_step_want'])}) (card: {card})")
    if got != want:
        raise AssertionError(f"{tag} launches {got} != the layout's {want}")
    if not all(np.isfinite(losses)) or not max(gaps) <= EXAMPLE_GAP_LIMIT:
        raise AssertionError(f"{tag} losses {losses} (gaps {gaps} to "
                             f"sp=False, remat=False: {plain})")
    prof = profile_train(tr.train_step, ids, labels, card, "example")
    rec["profile"] = prof
    clip_ms = prof.get("ranges_ms", {}).get(CLIP_RANGE)
    rec["clip_device_ms"] = clip_ms
    log(f"{tag} the clip's device time in the profiled step (its "
        f"record_function range): "
        f"{'not measured' if clip_ms is None else f'{clip_ms:.3f} ms'} "
        f"(card: {card})")
    del tr
    topology.set_hybrid_communicate_group(None)
    return got, rec


def example_remat_deep(card: str) -> dict:
    """(b): the serial trainer at ``REMAT_DEEP_LAYERS`` layers of gpt3_6_7b
    width, batch ``REMAT_DEEP_BATCH`` x ``REMAT_DEEP_SEQ``, ``remat=True``,
    the clipped ``FusedAdamW``,
    ``REMAT_DEEP_STEPS`` steps: the peak device memory (the no-remat run
    at this depth is not made; PERF.md reckons both)."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.models import gpt3_6_7b
    tag = "[train:example]"
    cfg = dataclasses.replace(gpt3_6_7b(remat=True),
                              num_layers=REMAT_DEEP_LAYERS)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tr = hybrid_trainer(cfg, None, 1, 1, 1, example_optimizer(), 4321)
    ids, labels = tr.make_batch(REMAT_DEEP_BATCH, REMAT_DEEP_SEQ, seed=0)
    step_ms, losses = [], []
    for _ in range(REMAT_DEEP_STEPS):
        t = time.perf_counter()
        losses.append(float(tr.train_step(ids, labels)))
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    rec = {"layers": cfg.num_layers, "params": cfg.num_params(),
           "batch": REMAT_DEEP_BATCH, "seq": REMAT_DEEP_SEQ,
           "losses": losses,
           "step_ms": step_ms, "peak_gb": peak_gb}
    log(f"{tag} remat, serial, gpt3_6_7b widths at {cfg.num_layers} of 32 "
        f"layers ({cfg.num_params() / 1e9:.3f}B params), batch "
        f"{REMAT_DEEP_BATCH} x {REMAT_DEEP_SEQ}: peak {peak_gb:.2f} GB, steps "
        f"{[round(x, 1) for x in step_ms]} ms, losses "
        f"{[round(x, 5) for x in losses]} (card: {card})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} remat deep run: losses {losses}")
    del tr
    free_card()
    return rec


def example_resume(card: str) -> dict:
    """(c): at gpt3_6_7b width with ``RESUME_LAYERS`` layers, the example
    script (``paddle_tpu_torch.examples.train_gpt_hybrid.main``) trains 4
    steps straight under ``{mp 2, pp 2}``; then the same flow trains 2
    steps under ``{mp 2, pp 2}``, ``save_auto_resume``, a serial trainer,
    ``load_auto_resume``, 2 more steps, whose losses must come within
    ``RESUME_GAP_LIMIT`` (relative) of the straight run's steps 3-4.  The checkpoint goes to a
    temporary directory, checked for room first and removed after."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.fleet_utils import (load_auto_resume,
                                                          save_auto_resume)
    from paddle_tpu_torch.examples.train_gpt_hybrid import main
    from paddle_tpu_torch.models import gpt3_6_7b
    tag = "[train:example]"
    batch, seq = HYBRID_BATCH, HYBRID_SEQ
    args = ["--config", "gpt3_6_7b", "--layers", str(RESUME_LAYERS),
            "--batch", str(batch), "--seq", str(seq), "--mp", "2", "--pp",
            "2", "--steps", "4", "--device", DEVICE]
    straight = [loss for _, loss in main(args)]
    topology.set_hybrid_communicate_group(None)
    free_card()
    # what the example builds for these flags
    cfg = dataclasses.replace(gpt3_6_7b(sp=True, remat=True),
                              num_layers=RESUME_LAYERS)
    # the train state: bf16 weights written as float32, f32 masters and
    # moments, 16 B a parameter
    need = 16 * cfg.num_params()
    root = tempfile.mkdtemp(prefix="train_example_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        if free < 2 * need:
            raise RuntimeError(f"{tag} {free / 1e9:.1f} GB free under {root}, "
                               f"the checkpoint needs {need / 1e9:.1f} GB "
                               f"(twice that asked for)")
        tr = hybrid_trainer(cfg, EXAMPLE_HYBRID, 4, 1, 1, example_optimizer(),
                            0)
        ids, labels = tr.make_batch(batch, seq)
        losses = [float(tr.train_step(ids, labels)) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_auto_resume(tr.train_state(), root, step=2)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        del tr
        topology.set_hybrid_communicate_group(None)
        free_card()
        serial = dataclasses.replace(cfg, sp=False)
        tr = hybrid_trainer(serial, None, 1, 1, 1, example_optimizer(), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step = load_auto_resume(tr.train_state(), root)
        tr.load_train_state(state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del state
        if step != 2:
            raise AssertionError(f"{tag} resumed at step {step}, saved at 2")
        losses += [float(tr.train_step(ids, labels)) for _ in range(2)]
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses[2:], straight[2:])]
    rec = {"layers": RESUME_LAYERS, "batch": batch, "seq": seq,
           "straight": straight, "resumed": losses, "gaps": gaps,
           "bytes_written": written, "save_s": save_s, "load_s": load_s,
           "free_bytes": free}
    log(f"{tag} auto-resume, gpt3_6_7b widths at {RESUME_LAYERS} layers, "
        f"batch {batch} x {seq}: the example straight {straight}; 2 steps "
        f"under {{mp 2, pp 2}}, saved {written / 1e9:.3f} GB in {save_s:.2f} "
        f"s, loaded into the serial trainer in {load_s:.2f} s, then 2 steps: "
        f"{losses} (relative gaps at steps 3-4 {gaps}) (card: {card})")
    if not max(gaps) <= RESUME_GAP_LIMIT:
        raise AssertionError(f"{tag} resumed losses {losses[2:]} vs the "
                             f"straight run's {straight[2:]}")
    free_card()
    return rec


def phase_train_example(card: str) -> tuple:
    """The reference's fleet example on the port: (a) its main path at
    gpt3_6_7b width, (b) what remat is for, (c) auto-resume across
    layouts.  Returns (a)'s launches over its timed steps and the
    records."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adamw as fw
    from paddle_tpu_torch.kernels import fused_norm as fn

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = [getattr(fa, k) for k in HYBRID_KERNELS[:3]] + \
        [getattr(fn, k) for k in HYBRID_KERNELS[3:5]] + [fw.fused_adamw]
    free_card()
    launches, main_path = example_main_path(card, kernels)
    out = {"main": main_path}
    out["remat_deep"] = example_remat_deep(card)
    out["resume"] = example_resume(card)
    return launches, out


SEMI_LAYERS = 12
SEMI_BATCH, SEMI_SEQ = 4, 2048
SEMI_DP, SEMI_MP = 2, 4
# steps of each build: every step's loss compared, p50 over the later ones
SEMI_STEPS, SEMI_SEED = 4, 4321
# step 1's relative loss gap, sharded against serial from the same
# weights: the same arithmetic but the o / down products summed over 4
# bf16 partials; 5x the larger reading PERF.md records (4.551e-6)
SEMI_GAP_LIMIT = 2.3e-5
# the relative gap of each later step's loss (after AdamW updates, where
# Adam moves the elements whose gradient is bf16 rounding noise by up to
# lr either way); 5x the larger reading PERF.md records (5.371e-3)
SEMI_LATER_GAP_LIMIT = 2.7e-2
# step 1's gradients, sharded against serial: the largest relative L2 gap
# over the parameters (bf16 activations rounded in another order, through
# 12 layers and back; 7e-7 in f32); 5x the larger reading PERF.md
# records (2.752e-2)
SEMI_GRAD_GAP_LIMIT = 1.4e-1
SEMI_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "rms_norm_fwd", "rms_norm_bwd")
# the device kernels the profiled steps must show (rows 4-8)
SEMI_TRACE_KERNELS = ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                      "dkv_wgmma_kernel", "rms_fwd_kernel",
                      "norm_bwd_rows_kernel", "norm_bwd_sum_kernel")
SEMI_HOST_EVENTS = ("semi_auto.step", "Engine.forward", "Engine.backward",
                    "Engine.optimizer")


def semi_auto_want(cfg, dp: int, mp: int) -> dict:
    """Each kernel's launches in one Engine step: every decoder layer's
    attention once per (dp, mp) rank (each rank's rows and heads); the
    2L + 1 RMSNorms once over all rows (replicated weights, held once),
    forward and backward."""
    flash = cfg.num_layers * dp * mp
    norms = 2 * cfg.num_layers + 1
    return {"flash_attention_fwd": flash, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash, "rms_norm_fwd": norms,
            "rms_norm_bwd": norms}


def semi_auto_kernels(card: str, cfg) -> dict:
    """Rows 4-8 at this path's shapes against their plain versions: the
    flash kernels on one rank's q / k / v [b / dp, s, heads / mp,
    head_dim] bf16 causal, the RMSNorm pair on all rows [b·s, h] bf16;
    each timed there (CUDA events) beside its bound."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_norm as fn
    g = torch.Generator(device=DEVICE)
    g.manual_seed(5)
    b, h = SEMI_BATCH // SEMI_DP, cfg.num_heads // SEMI_MP
    q, k, v, do = _flash_case(g, torch.bfloat16, b, SEMI_SEQ, SEMI_SEQ, h,
                              h, cfg.head_dim)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rl = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    rdq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                              causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                    causal=True)
    torch.cuda.synchronize()
    shape = f"[{b}, {SEMI_SEQ}, {h}, {cfg.head_dim}] bf16 causal"
    rec = {}
    for name, pairs, lses, call in (
            ("flash_attention_fwd", ((out, ro),), ((lse, rl),),
             lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            ("flash_attention_bwd_dq", ((dq, rdq),), (),
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal=True)),
            ("flash_attention_bwd_dkv", ((dk, rdk), (dv, rdv)), (),
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal=True))):
        err, rel, read = check_pairs(f"[train:semi_auto] {name} at {shape}",
                                     torch.bfloat16, pairs, lses)
        bound, by = flash_bounds(b, SEMI_SEQ, SEMI_SEQ, h, h, cfg.head_dim,
                                 True, 2)[name]
        rec[name] = {"shape": shape, "max_abs_err": err, "rel_err": rel,
                     "reading": read, "ms": time_ms(call),
                     "bound_ms": bound, "bound_by": by}
    # the library yardstick at this shape: SDPA's forward, and its
    # backward (dq, dk and dv together, on a retained graph)
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    rec["flash_attention_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        rec[name]["library_ms_dq_dkv_together"] = lib_bwd
    del o_lib, qt, kt, vt
    rows = SEMI_BATCH * SEMI_SEQ
    x = torch.randn(rows, cfg.hidden_size, generator=g,
                    device=DEVICE).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(cfg.hidden_size, generator=g,
                               device=DEVICE)).to(torch.bfloat16)
    gy = torch.randn(rows, cfg.hidden_size, generator=g,
                     device=DEVICE).to(torch.bfloat16)
    y, rstd = fn.rms_norm_fwd(x, w, cfg.rms_norm_eps)
    ry, rrstd = fn.rms_norm_fwd_reference(x, w, cfg.rms_norm_eps)
    dx, dw = fn.rms_norm_bwd(x, w, rrstd, gy)
    rdx, rdw = fn.rms_norm_bwd_reference(x, w, rrstd, gy)
    torch.cuda.synchronize()
    shape = f"[{rows}, {cfg.hidden_size}] bf16"
    for name, outs, call in (
            ("rms_norm_fwd", (("y", y, ry, 1e-5), ("rstd", rstd, rrstd,
                                                   1e-5)),
             lambda: fn.rms_norm_fwd(x, w, cfg.rms_norm_eps)),
            ("rms_norm_bwd", (("dx", dx, rdx, 1e-5), ("dw", dw, rdw, 1e-4)),
             lambda: fn.rms_norm_bwd(x, w, rrstd, gy))):
        err = 0.0
        for out_name, got, want, rel in outs:
            if norm_excess(got, want, rel) > 0:
                raise AssertionError(f"[train:semi_auto] {name} {out_name} "
                                     f"disagrees with its plain version at "
                                     f"{shape}")
            err = max(err, (got.float() - want.float()).abs().max().item())
        bound, by = norm_bound(name, rows, cfg.hidden_size, 2, 2)
        rec[name] = {"shape": shape, "max_abs_err": err, "ms": time_ms(call),
                     "bound_ms": bound, "bound_by": by}
    log(f"[train:semi_auto] rows 4-8 at this path's shapes against their "
        f"plain versions (flash: FLASH_REL and each element within its own "
        f"limit; RMSNorm: 1e-5 / dw 1e-4 of max(1, max |plain|) plus an "
        f"ulp): {json.dumps(rec)} (card: {card})")
    return rec


def on_first_update(eng, fn) -> None:
    """Call ``fn`` with the model's gradients by name once, at the first
    optimizer step of ``eng``: after the backward, before the update."""
    opt = eng.optimizer
    step = opt.step

    def first_step():
        opt.step = step
        fn({n: p.grad for n, p in eng.model.named_parameters()
            if p.grad is not None})
        return step()
    opt.step = first_step


def semi_auto_run(cfg, mesh, data, kernels, label: str,
                  step1_grads=None) -> dict:
    """Build the example's model (a generator seeded with ``SEMI_SEED``)
    and Engine, serial or sharded over ``mesh``, and run ``SEMI_STEPS``
    ``fit`` steps with the counts zeroed just before and read just after;
    ``step1_grads`` (if given) is called with step 1's gradients by name.
    Returns the engine with the run's record."""
    import numpy as np
    import torch
    from paddle_tpu_torch.examples import train_llama_semi_auto as ex
    free_card()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, eng = ex.build(cfg, mesh, torch.device(DEVICE), SEMI_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    if step1_grads is not None:
        on_first_update(eng, step1_grads)
    for k in kernels:
        k.launches = 0
    losses, step_ms = [], []
    for _ in range(SEMI_STEPS):
        t = time.perf_counter()
        losses += eng.fit(data)          # reads the loss: one sync a step
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    got = {name: k.launches for name, k in zip(SEMI_KERNELS, kernels)}
    p50 = float(np.median(step_ms[1:]))
    tok_s = SEMI_BATCH * SEMI_SEQ / (p50 / 1e3)
    flops = 6 * cfg.num_params() + 12 * cfg.num_layers * cfg.hidden_size * \
        SEMI_SEQ
    return model, eng, {
        "label": label, "losses": losses, "step_ms": step_ms,
        "step_ms_p50": p50, "tokens_per_s": tok_s,
        "mfu": flops * tok_s / PEAK_FLOPS["bfloat16"],
        "built_gb": built_gb, "build_s": build_s,
        "peak_gb": (torch.cuda.max_memory_allocated() - mem0) / 1e9,
        "launches": got}


def semi_auto_profile(eng, data, card: str) -> dict:
    """Four ``fit`` steps under the port's ``Profiler(targets=[GPU],
    scheduler=(1, 3), on_trace_ready=export_chrome_tracing(dir))``: steps
    1-2 recorded (host ``RecordEvent``s and the CUDA trace), the merged
    export checked for the host events and rows 4-8's kernels; the device
    busy share is the union of the kernel intervals over the recorded
    steps' wall time."""
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           RecordEvent,
                                           export_chrome_tracing,
                                           load_profiler_result)
    tag = "[train:semi_auto]"
    root = tempfile.mkdtemp(prefix="semi_auto_profile_")
    try:
        # the GPU target alone: CUDA activity (kernels, copies), no CPU
        # op records to slow the host; the host events are the profiler's
        p = Profiler(targets=[ProfilerTarget.GPU],
                     scheduler=(1, 3), trace_dir=os.path.join(root, "device"),
                     on_trace_ready=export_chrome_tracing(
                         os.path.join(root, "export")))
        walls = []
        torch.cuda.synchronize()
        with p:
            for _ in range(4):
                t = time.perf_counter()
                with RecordEvent("semi_auto.step"):
                    eng.fit(data)
                walls.append((time.perf_counter() - t) * 1e3)
                p.step()
        if p.last_export is None:
            raise AssertionError(f"{tag} the profiler exported no trace")
        events = load_profiler_result(p.last_export)["traceEvents"]
        host = {e["name"] for e in events if e.get("cat") == "host"}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = {e["name"] for e in kernels}
        missing_host = [n for n in SEMI_HOST_EVENTS if n not in host]
        missing = [k for k in SEMI_TRACE_KERNELS
                   if not any(k in n for n in names)]
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in kernels)
        busy_us, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy_us += b - a
                end = b
            elif b > end:
                busy_us += b - end
                end = b
        wall = walls[1] + walls[2]
        p.summary(device_rows=12)      # printed by the profiler
        out = {"walls_ms": walls, "recorded_wall_ms": wall,
               "kernel_events": len(kernels),
               "busy_ms": busy_us / 1e3,
               "busy_share": busy_us / 1e3 / wall if wall else None,
               "host_events": sorted(host),
               "export_mb": os.path.getsize(p.last_export) / 1e6}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"{tag} the port's Profiler over steps 1-2 of 4: {len(kernels)} "
        f"kernel events, {out['busy_ms']:.1f} ms of kernels (union) in "
        f"{wall:.1f} ms of wall, device busy share {out['busy_share']:.3f}; "
        f"host events {sorted(host)}; export {out['export_mb']:.1f} MB "
        f"(card: {card})")
    if missing_host or missing:
        raise AssertionError(f"{tag} the profiler's export lacks host events "
                             f"{missing_host} or kernels {missing}")
    return out


def phase_train_semi_auto(card: str) -> tuple:
    """The reference's semi-auto Llama example on the port
    (``paddle_tpu_torch/examples/train_llama_semi_auto.py``): llama_7b
    widths at ``SEMI_LAYERS`` of 32 layers, bf16, batch ``SEMI_BATCH`` x
    ``SEMI_SEQ``, the example's loss and ``AdamW(1e-3)``, built twice from
    the same weights: ``process_mesh=None`` (serial), then
    ``shard_layer(llama_shard_fn)`` over ``dp 2 x mp 4`` with every rank on
    this card.  Rows 4-8 at the path's shapes against their plain
    versions; ``SEMI_STEPS`` steps each, step 1's gradients and every
    step's loss held sharded against serial, launches held to
    ``semi_auto_want``, step p50, tokens/s, model-FLOP share, memory;
    then two sharded steps under the port's ``Profiler``.  Returns the
    sharded run's launches over its steps and the records."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.examples import train_llama_semi_auto as ex
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.models import llama_7b
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    tag = "[train:semi_auto]"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama_7b(), num_layers=SEMI_LAYERS)
    kernels = [getattr(fa, k) for k in SEMI_KERNELS[:3]] + \
        [getattr(fn, k) for k in SEMI_KERNELS[3:]]
    out = {"kernels": semi_auto_kernels(card, cfg)}
    data = ex.batches(cfg.vocab_size, SEMI_BATCH, SEMI_SEQ, 1)
    ref = {}     # on the host, so the builds' peaks stay their own

    def keep(grads):
        ref.update({n: g.detach().to("cpu", copy=True)
                    for n, g in grads.items()})
    model, eng, serial = semi_auto_run(cfg, None, data, kernels, "serial",
                                       keep)
    del model, eng
    mesh = ex.process_mesh(SEMI_DP, SEMI_MP, DEVICE)
    grad_gaps = {}

    def against_serial(grads):
        if set(grads) != set(ref):
            raise AssertionError(f"{tag} step 1's gradients: sharded "
                                 f"{sorted(set(grads) ^ set(ref))} differ")
        for n, g in grads.items():
            want = ref.pop(n).to(g.device).float()
            grad_gaps[n] = float((g.float() - want).norm() / want.norm())
    calls0 = LlamaDecoderLayer.partial_calls
    model, eng, sharded = semi_auto_run(cfg, mesh, data, kernels,
                                        f"dp{SEMI_DP}_mp{SEMI_MP}",
                                        against_serial)
    calls = LlamaDecoderLayer.partial_calls - calls0
    gaps = [abs(a - b) / abs(b)
            for a, b in zip(sharded["losses"], serial["losses"])]
    gap = gaps[0]
    worst = max(grad_gaps, key=grad_gaps.get)
    out.update(serial=serial, sharded=sharded, step1_gap=gap,
               gap_limit=SEMI_GAP_LIMIT, step_gaps=gaps,
               later_gap_limit=SEMI_LATER_GAP_LIMIT,
               grad_gap_max=grad_gaps[worst], grad_gap_worst=worst,
               grad_gap_limit=SEMI_GRAD_GAP_LIMIT,
               grad_gaps=grad_gaps, partial_calls=calls,
               params=cfg.num_params())
    for run, (dp, mp) in ((serial, (1, 1)), (sharded, (SEMI_DP, SEMI_MP))):
        want = {k: v * SEMI_STEPS
                for k, v in semi_auto_want(cfg, dp, mp).items()}
        run["launches_want"] = want
        log(f"{tag} {run['label']}: llama_7b widths, {cfg.num_layers} of 32 "
            f"layers ({cfg.num_params() / 1e9:.3f}B params), bf16, batch "
            f"{SEMI_BATCH} x {SEMI_SEQ}, AdamW(1e-3): step p50 "
            f"{run['step_ms_p50']:.1f} ms ({[round(x, 1) for x in run['step_ms']]}"
            f"), {run['tokens_per_s']:.0f} tokens/s, model-FLOP share "
            f"{run['mfu']:.3f}; memory after the build {run['built_gb']:.2f} "
            f"GB (built in {run['build_s']:.1f} s), peak {run['peak_gb']:.2f} "
            f"GB; losses {[round(x, 5) for x in run['losses']]}; launches "
            f"over {SEMI_STEPS} steps {json.dumps(run['launches'])} (want "
            f"{json.dumps(want)}) (card: {card})")
        if run["launches"] != want:
            raise AssertionError(f"{tag} {run['label']} launches "
                                 f"{run['launches']} != {want}")
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"{tag} {run['label']} losses "
                                 f"{run['losses']}")
    log(f"{tag} dp {SEMI_DP} x mp {SEMI_MP} against serial from the same "
        f"weights: step 1's loss, relative gap {gap:.3e} (limit "
        f"{SEMI_GAP_LIMIT}); steps 2-{SEMI_STEPS}' losses "
        f"{[f'{x:.3e}' for x in gaps[1:]]} (limit {SEMI_LATER_GAP_LIMIT}); "
        f"step 1's gradients, the largest relative L2 gap of "
        f"{len(grad_gaps)} {grad_gaps[worst]:.3e} ({worst}; median "
        f"{float(np.median(list(grad_gaps.values()))):.3e}; limit "
        f"{SEMI_GRAD_GAP_LIMIT}); the per-rank decoder body ran {calls} times "
        f"({SEMI_STEPS} steps x {cfg.num_layers} layers x 2 halves x "
        f"{SEMI_DP * SEMI_MP} ranks = "
        f"{SEMI_STEPS * cfg.num_layers * 2 * SEMI_DP * SEMI_MP})")
    if not gap <= SEMI_GAP_LIMIT:
        raise AssertionError(f"{tag} step 1's loss {sharded['losses'][0]} vs "
                             f"serial {serial['losses'][0]}")
    if not max(gaps[1:]) <= SEMI_LATER_GAP_LIMIT:
        raise AssertionError(f"{tag} losses {sharded['losses']} vs serial "
                             f"{serial['losses']}")
    if not all(g <= SEMI_GRAD_GAP_LIMIT for g in grad_gaps.values()):
        raise AssertionError(f"{tag} step 1's gradient of {worst}: relative "
                             f"gap {grad_gaps[worst]} from serial")
    if calls != SEMI_STEPS * cfg.num_layers * 2 * SEMI_DP * SEMI_MP:
        raise AssertionError(f"{tag} the per-rank body ran {calls} times")
    out["profile"] = prof = semi_auto_profile(eng, data, card)
    # the profiled window's kernels against the unprofiled step p50
    prof["kernel_ms_per_step"] = prof["busy_ms"] / 2
    prof["kernel_share_of_p50"] = prof["busy_ms"] / 2 / \
        sharded["step_ms_p50"]
    log(f"{tag} kernels {prof['kernel_ms_per_step']:.1f} ms a step against "
        f"the unprofiled step p50 {sharded['step_ms_p50']:.1f} ms: "
        f"{prof['kernel_share_of_p50']:.3f}")
    del model, eng
    free_card()
    return sharded["launches"], out


# ------------------------------------------------- expert-parallel MoE
# the repo's production MoE layout (scripts/aot_northstar.py's MoE leg):
# GPT-MoE at gpt3_6_7b widths, 8 experts, top-2 naive gate, capacity
# factor 1.25, aux weight 0.01, bf16, cut to MOE_LAYERS of 32 layers
MOE_LAYERS = 2
MOE_BATCH, MOE_SEQ = 4, 2048
MOE_WARMUP, MOE_STEPS = 1, 4
# (label, hybrid_configs or None for the serial trainer, microbatches of
# the timed steps; step 1 against serial runs at microbatches 1)
MOE_RUNS = (("serial", None, 1),
            ("ep2_pp2_sharding2",
             {"ep_degree": 2, "pp_degree": 2, "sharding_degree": 2}, 2),
            ("dp2_ep2_mp2",
             {"dp_degree": 2, "ep_degree": 2, "mp_degree": 2}, 1))
# step 1's relative loss gap to serial: 5x the larger reading of the
# first run (3.914e-5, {dp 2, ep 2, mp 2}; PERF.md), whose limit
# was 1e-2
MOE_GAP_LIMIT = 1.96e-4
MOE_SEED = 4321
# the profile's kinds: the port's kernels by name, then the MoE ranges of
# the forward and the autograd nodes of their backward
MOE_GEMM = ("nvjet", "gemm", "cutlass", "sm90_xmma")
MOE_EXPERT_OPS = ("moe.experts", "BmmBackward0", "BaddbmmBackward0")
MOE_ROUTE_OPS = ("moe.dispatch", "moe.combine", "_DispatchBackward",
                 "_CombineBackward")


def moe_config():
    from paddle_tpu_torch.models import GPTMoEConfig
    return GPTMoEConfig(vocab_size=50304, hidden_size=4096, num_heads=32,
                        max_seq_len=2048, num_layers=MOE_LAYERS,
                        num_experts=8, top_k=2, gate="naive", moe_every=1,
                        capacity_factor=1.25, aux_weight=0.01,
                        dtype="bfloat16")


def moe_params(cfg) -> tuple:
    """``(all parameters, active parameters a token)``: the active count
    is what one token's forward multiplies through, attention, the gate,
    ``top_k`` experts' w0 / w1 and the tied head (capacity padding is no
    useful work)."""
    h, f, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    attn = 4 * h * h + 4 * h
    expert = 2 * h * f + f + h
    tables = (cfg.vocab_size + cfg.max_seq_len) * h
    total = cfg.num_layers * (attn + 4 * h + h * E + E * expert) + tables \
        + 2 * h
    active = cfg.num_layers * (attn + h * E + cfg.top_k * 2 * h * f) + \
        cfg.vocab_size * h
    return total, active


def moe_want(cfg, hybrid, microbatches, batch) -> dict:
    """Each kernel's launches in one train step, from the layout: the
    microbatch rows each batch group (dp x sharding) takes (ceil(rows /
    groups)), each block's attention and its two LayerNorms once per
    (microbatch, group) (attention and norms stay whole over mp and ep),
    ln_f once per vocab shard (pp); one AdamW launch per slice updated,
    once on the card: a block of an expert tensor over ep and mp, the
    wte / wpe rows over pp, ZeRO's slices (the first free dim of the
    stacked layout that splits over ``sharding``; the stacked layer dim
    hands whole blocks to one rank).  Serial: one launch a parameter
    tensor."""
    deg = {a: (hybrid or {}).get(f"{a}_degree", 1)
           for a in ("dp", "pp", "sharding", "ep", "mp")}
    S, D, L = deg["pp"], deg["sharding"], cfg.num_layers
    G = deg["dp"] * D
    M = microbatches if S > 1 else 1
    mb = batch // M
    per = -(-mb // G)
    units = M * sum(1 for g in range(G) if g * per < mb)
    h, f, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    X = "ep" if deg["ep"] > 1 else "dp"
    mp = "mp" if deg["mp"] > 1 else None
    block = [((h,), ())] * 4 + [((h, 3 * h), ()), ((3 * h,), ()),
                                ((h, h), ()), ((h,), ()), ((h, E), ()),
                                ((E, h, f), (X, None, mp)),
                                ((E, f), (X, mp)),
                                ((E, f, h), (X, mp, None)),
                                ((E, h), (X, None))]
    nonblock = [((cfg.vocab_size, h), ("pp" if S > 1 else None, None)),
                ((cfg.max_seq_len, h), ("pp" if S > 1 else None, None)),
                ((h,), ()), ((h,), ())]
    if hybrid is None:
        adamw = L * len(block) + len(nonblock)
    else:
        adamw = 0
        for lead, items in (((L,), block), ((), nonblock)):
            for shape, spec in items:
                spec = tuple(spec) + (None,) * (len(shape) - len(spec))
                blocks = math.prod(deg[a] for a in spec if a)
                full = lead + shape
                fspec = (("pp" if S > 1 else None),) * len(lead) + spec
                slices = 1
                if D > 1:
                    for i, n in enumerate(full):
                        if fspec[i] is None and n % D == 0 and n >= D:
                            slices = 1 if i < len(lead) else D
                            break
                adamw += (L if lead else 1) * blocks * slices
    vocab = S if hybrid and S > 1 else 1
    flash = L * units
    norms = units * (2 * L + vocab)
    return {"flash_attention_fwd": flash, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash, "layer_norm_fwd": norms,
            "layer_norm_bwd": norms, "fused_adamw": adamw}


def moe_trainer(cfg, hybrid, microbatches: int, opt):
    """``GPTMoEHybridTrainer`` as a fleet script builds it (every rank on
    this card), weights from a generator seeded with ``MOE_SEED``."""
    import torch
    from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                              get_hybrid_communicate_group)
    from paddle_tpu_torch.models import GPTMoEHybridTrainer
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(MOE_SEED)
    if hybrid is None:
        return GPTMoEHybridTrainer(cfg, optimizer=opt, device=DEVICE,
                                   generator=gen)
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    fleet.init(is_collective=True, strategy=s,
               devices=[DEVICE] * math.prod(hybrid.values()))
    return GPTMoEHybridTrainer(cfg, get_hybrid_communicate_group(), opt,
                               microbatches=microbatches, generator=gen)


def flash_rows(tag: str, g, b: int, s: int, h: int, d: int, causal: bool,
               packed: bool = False) -> dict:
    """Rows 4-6 on random bf16 q / k / v / dO ``[b, s, h, d]`` (views of
    a fused QKV with ``packed``) against their plain versions (``FLASH_
    REL`` and each element within its own limit), each timed (CUDA
    events) beside its plain version, its bound and SDPA (the backward's
    dq, dk and dv together on a retained graph)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_case(g, torch.bfloat16, b, s, s, h, h, d,
                              packed=packed)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ro, rl = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    rdq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                              causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                    causal=causal)
    torch.cuda.synchronize()
    shape = f"[{b}, {s}, {h}, {d}] bf16 " + \
        ("causal" if causal else "non-causal") + \
        (" (views of a fused QKV)" if packed else "")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    del o_lib, qt, kt, vt
    rec = {}
    for name, pairs, lses, call, plain in (
            ("flash_attention_fwd", ((out, ro),), ((lse, rl),),
             lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
             lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                      causal=causal)),
            ("flash_attention_bwd_dq", ((dq, rdq),), (),
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal=causal),
             lambda: fa.flash_attention_bwd_dq_reference(
                 q, k, v, do, lse, delta, causal=causal)),
            ("flash_attention_bwd_dkv", ((dk, rdk), (dv, rdv)), (),
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal=causal),
             lambda: fa.flash_attention_bwd_dkv_reference(
                 q, k, v, do, lse, delta, causal=causal))):
        err, rel, read = check_pairs(f"{tag} {name} at {shape}",
                                     torch.bfloat16, pairs, lses)
        bound, by = flash_bounds(b, s, s, h, h, d, causal, 2)[name]
        rec[name] = {"shape": shape, "max_abs_err": err, "rel_err": rel,
                     "reading": read, "ms": time_ms(call),
                     "plain_ms": time_ms(plain, iters=3, warmup=2,
                                         windows=3),
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": lib_fwd if name.endswith("fwd") else None}
        if not name.endswith("fwd"):
            rec[name]["library_ms_dq_dkv_together"] = lib_bwd
    return rec


def flash_decode_rows(tag: str, g, b: int, h: int, d: int,
                      lengths) -> dict:
    """Row 4 at cached decoding's self-attention shape: one bf16 query row
    ``[b, 1, h, d]`` against each of ``lengths`` keys, non-causal, against
    its plain version (``FLASH_REL``, each element within its own limit,
    the lse within 1e-4 relative), each timed (CUDA events) beside its
    plain version, its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    rec = {}
    for sk in lengths:
        q, k, v, _ = _flash_case(g, torch.bfloat16, b, 1, sk, h, h, d)
        out, lse = fa.flash_attention_fwd(q, k, v)
        ro, rl = fa.flash_attention_fwd_reference(q, k, v)
        torch.cuda.synchronize()
        shape = f"q [{b}, 1, {h}, {d}], k / v [{b}, {sk}, {h}, {d}] bf16 " \
            f"non-causal"
        err, rel, read = check_pairs(f"{tag} flash_attention_fwd at "
                                     f"{shape}", torch.bfloat16,
                                     ((out, ro),), ((lse, rl),))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound, by = flash_bounds(b, 1, sk, h, h, d, False,
                                 2)["flash_attention_fwd"]
        rec[f"sq1_sk{sk}"] = {
            "shape": shape, "max_abs_err": err, "rel_err": rel,
            "reading": read,
            "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v), iters=5, warmup=2, windows=3),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt))}
    return rec


def layer_norm_rows(tag: str, g, rows: int, hid: int) -> dict:
    """Rows 9-10 on random bf16 rows ``[rows, hid]`` against their plain
    versions (``norm_calls``' limits), each timed (CUDA events) beside its
    plain version, its bound and ``F.layer_norm`` (its autograd backward
    for row 10)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_norm as fn
    x = torch.randn(rows, hid, generator=g, device=DEVICE).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(hid, generator=g, device=DEVICE)).to(
        torch.bfloat16)
    b = (0.1 * torch.randn(hid, generator=g, device=DEVICE)).to(
        torch.bfloat16)
    gy = torch.randn(rows, hid, generator=g, device=DEVICE).to(
        torch.bfloat16)
    calls = norm_calls(x, w, b, gy)
    _, mean, rstd = fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)
    shape = f"[{rows}, {hid}] bf16"
    lib = time_ms(lambda: F.layer_norm(x, (hid,), w, b, NORM_EPS))
    xl = x.detach().requires_grad_()
    wl, bl = w.detach().requires_grad_(), b.detach().requires_grad_()
    yl = F.layer_norm(xl, (hid,), wl, bl, NORM_EPS)
    lib_b = time_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), gy,
                                                retain_graph=True))
    del yl, xl, wl, bl
    rec = {}
    for name, call, plain in (
            ("layer_norm_fwd", lambda: fn.layer_norm_fwd(x, w, b, NORM_EPS),
             lambda: fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)),
            ("layer_norm_bwd",
             lambda: fn.layer_norm_bwd(x, w, mean, rstd, gy),
             lambda: fn.layer_norm_bwd_reference(x, w, mean, rstd, gy))):
        err = 0.0
        for out_name, got, want, rel in calls[name]:
            if norm_excess(got, want, rel) > 0:
                raise AssertionError(f"{tag} {name} {out_name} disagrees "
                                     f"with its plain version at {shape}")
            err = max(err, (got.float() - want.float()).abs().max().item())
        bound, by = norm_bound(name, rows, hid, 2, 2)
        rec[name] = {"shape": shape, "max_abs_err": err, "ms": time_ms(call),
                     "plain_ms": time_ms(plain, iters=5, warmup=2,
                                         windows=3),
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": lib if name.endswith("fwd") else lib_b}
    return rec


def moe_kernels(card: str, cfg) -> dict:
    """Rows 4-6 and 9-11 at this path's shapes against their plain
    versions, each timed there (CUDA events) beside its bound and a
    library call: the flash kernels on one batch group's q / k / v [1,
    2048, 32, 128] bf16 causal (views of the fused QKV), the LayerNorm
    pair on its rows [2048, 4096] bf16, fused AdamW on the largest slice
    the example's layout updates (one ep block of w0, its ZeRO half: [4,
    2048, 16384], f32 master, bf16 gradient and parameter)."""
    import torch
    from paddle_tpu_torch.kernels.fused_adamw import (fused_adamw,
                                                      fused_adamw_reference)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(6)
    rec = {**flash_rows("[train:moe]", g, 1, MOE_SEQ, cfg.num_heads,
                        cfg.head_dim, True, packed=True),
           **layer_norm_rows("[train:moe]", g, MOE_SEQ, cfg.hidden_size)}
    E_l, half, f = cfg.num_experts // 2, cfg.hidden_size // 2, cfg.ffn_size
    numel = E_l * half * f
    master = torch.randn(numel, generator=g, device=DEVICE)
    grad = torch.randn(numel, generator=g, device=DEVICE).to(torch.bfloat16)
    m = torch.randn(numel, generator=g, device=DEVICE) * 1e-2
    v2 = torch.rand(numel, generator=g, device=DEVICE) * 1e-3
    low = master.to(torch.bfloat16)
    kw = dict(lr=TRAIN_LR, weight_decay=0.01, step=3)
    ref = [t.clone() for t in (master, m, v2, low)]
    fused_adamw(master, grad, m, v2, low=low, **kw)
    fused_adamw_reference(ref[0], grad, ref[1], ref[2], low=ref[3], **kw)
    torch.cuda.synchronize()
    err = 0.0
    for nm, got, want in zip(("p", "m", "v", "low"), (master, m, v2, low),
                             ref):
        ok = torch.allclose(got, want, rtol=1e-6, atol=1e-7) \
            if got.dtype == torch.float32 else _ulp_ok(got, want, got.dtype)
        if not ok:
            raise AssertionError(f"[train:moe] fused_adamw disagrees with its "
                                 f"plain version on {nm} at [{E_l}, {half}, "
                                 f"{f}]")
        err = max(err, (got.float() - want.float()).abs().max().item())
    del ref
    tp = torch.nn.Parameter(master.clone())
    tp.grad = grad.float()
    topt = torch.optim.AdamW([tp], lr=TRAIN_LR, weight_decay=0.01,
                             fused=True)
    adam_lib = time_ms(topt.step, iters=5, warmup=2, windows=3)
    del tp, topt
    nbytes = numel * 28
    rec["fused_adamw"] = {
        "shape": f"[{E_l}, {half}, {f}]: f32 master, bf16 grad, f32 m/v, "
                 f"bf16 parameter copy (28 B per element)",
        "max_abs_err": err,
        "ms": time_ms(lambda: fused_adamw(master, grad, m, v2, low=low,
                                          **kw), iters=5, warmup=2,
                      windows=3),
        "plain_ms": time_ms(lambda: fused_adamw_reference(
            master, grad, m, v2, low=low, **kw), iters=2, warmup=1,
            windows=3),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": adam_lib}
    del master, grad, m, v2, low
    torch.cuda.empty_cache()
    log(f"[train:moe] rows 4-6, 9-11 at this path's shapes against their "
        f"plain versions (flash: FLASH_REL and each element within its own "
        f"limit; LayerNorm: 1e-5 / dw, db 1e-4 of max(1, max |plain|) plus "
        f"an ulp; AdamW: f32 rtol 1e-6, bf16 one ulp), each timed beside its "
        f"plain version, bound and library call: {json.dumps(rec)} "
        f"(card: {card})")
    return rec


def ops_at_launch(events) -> tuple:
    """``(kernels, at)`` of a chrome trace's events: its kernel events,
    and for each launch's correlation id the ops and ranges open on the
    launching thread at the launch, outermost first, as ``(name,
    sequence number or None)`` (a backward node carries its forward op's
    number)."""
    launch, ops = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat in ("cpu_op", "user_annotation"):
            ops.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"], e.get("args", {}).get("Sequence number")))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the ops open at each launch: a sweep over each thread's nested ops
    at = {}
    for tid, items in ops.items():
        items.sort(key=lambda x: (x[0], -x[1]))
        calls = sorted((ts, c) for c, (t, ts) in launch.items() if t == tid)
        stack, i = [], 0
        for ts, c in calls:
            while i < len(items) and items[i][0] <= ts:
                while stack and stack[-1][1] < items[i][0]:
                    stack.pop()
                stack.append(items[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            at[c] = [(n, q) for _, _, n, q in stack]
    return kernels, at


def busy_ms(kernels) -> float:
    """The union of the kernels' intervals, in ms."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def moe_kinds(events) -> tuple:
    """``(device ms by kind, busy ms, kernels)`` of a chrome trace's
    events: each kernel's kind from its name and from the ops and ranges
    open on its launching thread at its launch (``moe_profile``)."""
    kernels, stacks = ops_at_launch(events)
    at = {c: [n for n, _ in st] for c, st in stacks.items()}
    kinds = ("flash", "norms", "adamw", "dispatch_combine", "expert_bmm",
             "dense_gemm", "rest")
    ms = {k: 0.0 for k in kinds}
    rest = {}
    for e in kernels:
        name = e["name"]
        opened = at.get(e.get("args", {}).get("correlation"), [])
        gemm = any(x in name for x in MOE_GEMM)
        if any(x in name for x in ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                                   "dkv_wgmma_kernel")):
            kind = "flash"
        elif any(x in name for x in ("ln_fwd_", "norm_bwd_")):
            kind = "norms"
        elif "adamw_kernel" in name:
            kind = "adamw"
        elif any(any(r in o for r in MOE_ROUTE_OPS) for o in opened):
            kind = "dispatch_combine"
        elif gemm and any(any(r in o for r in MOE_EXPERT_OPS)
                          for o in opened):
            kind = "expert_bmm"
        elif gemm:
            kind = "dense_gemm"
        else:
            kind = "rest"
            rest[name] = rest.get(name, 0.0) + float(e["dur"]) / 1e3
        ms[kind] += float(e["dur"]) / 1e3
    ms["rest_top"] = dict(sorted(rest.items(), key=lambda kv: -kv[1])[:8])
    return ms, busy_ms(kernels), kernels


def moe_profile(tr, ids, labels, card: str, label: str) -> dict:
    """One step under the port's ``Profiler`` (CPU and GPU targets,
    ``scheduler=(1, 2)``: step 0 closed, step 1 recorded): each kernel's
    device time by kind, from the op and range enclosing its launch.
    Kinds: flash, norms and AdamW (the port's kernels), dispatch and
    combine (kernels under the ``moe.dispatch`` / ``moe.combine`` ranges
    and their backward nodes), expert bmm (GEMMs under ``moe.experts``
    and the bmm / baddbmm backward nodes), dense GEMMs (every other
    GEMM), the rest; and the busy share, the union of the kernel
    intervals over the recorded step's wall time."""
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget
    root = tempfile.mkdtemp(prefix="moe_profile_")
    try:
        p = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                     scheduler=(1, 2), trace_dir=root)
        walls = []
        torch.cuda.synchronize()
        with p:
            for _ in range(2):
                t = time.perf_counter()
                float(tr.train_step(ids, labels))
                walls.append((time.perf_counter() - t) * 1e3)
                p.step()
        events = p.device_events()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ms, busy_ms, kernels = moe_kinds(events)
    top = {k[:90]: v for k, v in ms.pop("rest_top").items()}
    out = {"wall_ms": walls[1], "kernel_events": len(kernels),
           "device_ms_by_kind": ms, "device_ms": sum(ms.values()),
           "rest_top_ms": top,
           "busy_ms": busy_ms,
           "busy_share": busy_ms / walls[1] if walls[1] else None}
    log(f"[train:moe] {label}: one step under the port's Profiler: "
        f"{walls[1]:.1f} ms wall, {len(kernels)} kernels, "
        f"{out['busy_ms']:.1f} ms busy (share {out['busy_share']:.3f}); "
        f"device ms by kind "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}; the rest's "
        f"largest {json.dumps({k: round(v, 3) for k, v in top.items()})} "
        f"(card: {card})")
    if not kernels or ms["expert_bmm"] <= 0 or ms["dispatch_combine"] <= 0 \
            or ms["flash"] <= 0:
        raise AssertionError(f"[train:moe] {label}: the profile shows no "
                             f"expert bmm, dispatch / combine or flash time: "
                             f"{json.dumps(ms)}")
    return out


def phase_train_moe(card: str) -> tuple:
    """The reference's expert-parallel GPT-MoE training on the port at the
    repo's production MoE width (``moe_config``: gpt3_6_7b widths, 8
    experts, top-2, cut to ``MOE_LAYERS`` of 32 layers), bf16, batch
    ``MOE_BATCH`` x ``MOE_SEQ``, ``FusedAdamW(multi_precision=True)``,
    every rank on this card: rows 4-6 and 9-11 at the path's shapes; then
    the serial trainer, ``{ep 2, pp 2, sharding 2}`` (ZeRO-1, the
    example's layout) and ``{dp 2, ep 2, mp 2}``, each built from the same
    weights and freed in turn: step 1 at microbatches 1 against serial
    (the loss, and the share of tokens whose top-k set differs, layer by
    layer), ``MOE_WARMUP`` and ``MOE_STEPS`` timed steps (layout 2 at 2
    microbatches) with the counts zeroed just before and read just after
    and held to ``moe_want``; step p50, tokens/s, the model-FLOP share
    over the active parameters, memory after the build and at the peak,
    ``expert_util`` and ``token_keep_rate`` per layer; one step of the
    serial and of the example's layout under the port's ``Profiler``;
    then the example script at its defaults on the card.  Returns each
    run's launches over its timed steps and the records."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import moe, topology
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adamw as fw
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.optimizer import FusedAdamW
    tag = "[train:moe]"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe_config()
    kernels = [getattr(fa, k) for k in HYBRID_KERNELS[:3]] + \
        [getattr(fn, k) for k in HYBRID_KERNELS[3:5]] + [fw.fused_adamw]
    total, active = moe_params(cfg)
    out = {"kernels": moe_kernels(card, cfg), "runs": {},
           "params": total, "active_params": active}
    launches = {}
    serial_loss = serial_routes = None
    route = moe.moe_route
    for label, hybrid, m in MOE_RUNS:
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = moe_trainer(cfg, hybrid, 1, FusedAdamW(
            learning_rate=TRAIN_LR, multi_precision=True))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        built_gb = (torch.cuda.memory_allocated() - base) / 1e9
        ids, labels = tr.make_batch(MOE_BATCH, MOE_SEQ, seed=0)
        routes = []

        def spy(val, idx, E, C):
            routes.append(idx.detach().sort(-1).values.cpu())
            return route(val, idx, E, C)
        moe.moe_route = spy
        try:
            losses = [float(tr.train_step(ids, labels))]
        finally:
            moe.moe_route = route
        if serial_loss is None:
            serial_loss, serial_routes = losses[0], routes
        gap = abs(losses[0] - serial_loss) / abs(serial_loss)
        flips = [float((a != b).any(-1).float().mean())
                 for a, b in zip(routes, serial_routes)]
        tr.M = m
        losses += [float(tr.train_step(ids, labels))
                   for _ in range(MOE_WARMUP)]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        step_ms = []
        for _ in range(MOE_STEPS):
            t = time.perf_counter()
            losses.append(float(tr.train_step(ids, labels)))
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in zip(HYBRID_KERNELS, kernels)}
        want = {k: v * MOE_STEPS for k, v in moe_want(
            cfg, hybrid, m, MOE_BATCH).items()}
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        p50 = float(np.median(step_ms))
        tok_s = MOE_BATCH * MOE_SEQ / (p50 / 1e3)
        flops = 6 * active + 12 * cfg.num_layers * cfg.hidden_size * MOE_SEQ
        mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
        routing = tr.routing()
        rec = {"hybrid": hybrid, "microbatches": m, "losses": losses,
               "step1_gap": gap, "gap_limit": MOE_GAP_LIMIT,
               "routing_flip_share": flips, "step_ms": step_ms,
               "step_ms_p50": p50, "tokens_per_s": tok_s,
               "active_mfu": mfu, "built_gb": built_gb, "peak_gb": peak_gb,
               "build_s": build_s, "stage_calls": getattr(
                   tr, "stage_calls", None), **routing,
               "launches_per_step": {k: v / MOE_STEPS
                                     for k, v in got.items()},
               "launches_per_step_want": {k: v / MOE_STEPS
                                          for k, v in want.items()}}
        out["runs"][label] = rec
        log(f"{tag} {label} (gpt3_6_7b widths, 8 experts top-2, "
            f"{cfg.num_layers} of 32 layers, {total / 1e9:.3f}B params, "
            f"{active / 1e9:.3f}B active a token, bf16, batch {MOE_BATCH} x "
            f"{MOE_SEQ}, {m} microbatches): step 1 loss {losses[0]:.6f}, "
            f"relative gap to serial {gap:.3e} (limit {MOE_GAP_LIMIT}), "
            f"tokens whose top-2 set differs from serial's, by layer, "
            f"{flips}; step p50 {p50:.1f} ms "
            f"({[round(x, 1) for x in step_ms]}), {tok_s:.0f} tokens/s, "
            f"active model-FLOP share {mfu:.3f}; memory after the build "
            f"{built_gb:.2f} GB (built in {build_s:.1f} s), peak "
            f"{peak_gb:.2f} GB; expert_util {routing['expert_util']}, "
            f"token_keep_rate {routing['token_keep_rate']}; losses "
            f"{[round(x, 5) for x in losses]}; launches a step "
            f"{json.dumps(rec['launches_per_step'])} (want "
            f"{json.dumps(rec['launches_per_step_want'])}) (card: {card})")
        if got != want:
            raise AssertionError(f"{tag} {label}: launches {got} != the "
                                 f"layout's {want}")
        if not all(np.isfinite(losses)) or not gap <= MOE_GAP_LIMIT:
            raise AssertionError(f"{tag} {label}: losses {losses} (step 1 "
                                 f"gap to serial {gap})")
        launches[label] = got
        if label in ("serial", "ep2_pp2_sharding2"):
            rec["profile"] = moe_profile(tr, ids, labels, card, label)
        del tr
        topology.set_hybrid_communicate_group(None)
    free_card()
    # the example at its defaults on the card
    from paddle_tpu_torch.examples import train_moe_ep
    t0 = time.perf_counter()
    ex = train_moe_ep.main([])
    out["example"] = {"losses": ex, "seconds": time.perf_counter() - t0}
    log(f"{tag} paddle_tpu_torch/examples/train_moe_ep.py at its defaults on "
        f"{DEVICE} (ep 2 x pp 2 x sharding 2, gpt_moe_tiny, 5 steps): losses "
        f"{[round(x, 4) for x in ex]} in {out['example']['seconds']:.1f} s")
    topology.set_hybrid_communicate_group(None)
    free_card()
    return launches, out


# ------------------------------------------------------------ train:wmt
# BASELINE config #2 at the repo's WMT row (scripts/tpu_r5_profile.py:
# 210-256): a shared Embedding(32000, 512), Transformer-base (6 + 6
# layers, 8 heads, ffn 2048) and a Linear(512, 32000) head, bf16, batch
# 32 x 512 source and target tokens, no positional encoding (as the row)
WMT_VOCAB, WMT_D, WMT_HEADS, WMT_FFN, WMT_LAYERS = 32000, 512, 8, 2048, 6
WMT_BATCH, WMT_SEQ = 32, 512
WMT_PAD = 0
# the source and target lengths of the recipe: drawn in [256, 512]
WMT_MIN_LEN = 256
WMT_WARMUP, WMT_STEPS = 2, 6
WMT_SEED = 2401
WMT_DECODE_STEPS = 32
# the key counts at which row 4 is held at decoding's one query row: the
# first step, a middle one, the last of (c), and a full source
WMT_DECODE_KEYS = (1, 7, WMT_DECODE_STEPS, WMT_SEQ)
# parameters and tensors of the row (emb 16.38M, head 16.42M, encoder
# layers 3,152,384 each, decoder layers 4,204,032 each)
WMT_PARAMS, WMT_TENSORS = 76938496, 255
# step 1's relative loss gap, bf16 against f32 at dropout 0: 5x the
# first run's reading (5.509e-7; PERF.md), whose limit was 1e-2
WMT_PARITY_LIMIT = 2.76e-6
# cached decoding against the uncached causal decoder, the largest logit
# difference relative to max(1, max |logit|): 5x the first run's reading
# (7.812e-3), whose limit was 5e-2
WMT_DECODE_LIMIT = 3.91e-2
# one MHA call at [32, 512] through the flash kernels against the dense
# form: bf16's FLASH_REL
WMT_MHA_REL = FLASH_REL["bfloat16"]
WMT_KERNELS = HYBRID_KERNELS


def wmt_shapes() -> list:
    """The row's parameter shapes in ``named_parameters`` order."""
    d, f, v = WMT_D, WMT_FFN, WMT_VOCAB
    mha = [(d, d), (d,)] * 4
    ffn = [(d, f), (f,), (f, d), (d,)]
    enc = mha + ffn + [(d,)] * 4
    dec = mha * 2 + ffn + [(d,)] * 6
    return [(v, d)] + enc * WMT_LAYERS + dec * WMT_LAYERS + [(d, v), (v,)]


def wmt_model(dtype, attn_dropout: float, dropout: float = 0.1):
    """The row on the card, weights drawn from a generator seeded with
    ``WMT_SEED`` (which every dropout then draws from), as a module with
    the JAX ``Sequential``'s names ``emb`` / ``tr`` / ``head``."""
    import torch
    from paddle_tpu_torch import nn
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(WMT_SEED)
    kw = dict(device=DEVICE, dtype=dtype, generator=gen)
    m = torch.nn.Module()
    m.emb = nn.Embedding(WMT_VOCAB, WMT_D, **kw)
    m.tr = nn.Transformer(WMT_D, WMT_HEADS, WMT_LAYERS, WMT_LAYERS, WMT_FFN,
                          dropout=dropout, attn_dropout=attn_dropout, **kw)
    m.head = nn.Linear(WMT_D, WMT_VOCAB, **kw)
    return m


def wmt_optimizer(m) -> tuple:
    """The recipe's ``(NoamDecay(512, 4000), FusedAdamW(beta2 0.997,
    epsilon 1e-9, no decay, multi_precision))`` bound to ``m``."""
    from paddle_tpu_torch.optimizer import FusedAdamW
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    sched = NoamDecay(d_model=WMT_D, warmup_steps=4000)
    opt = FusedAdamW(learning_rate=sched, beta1=0.9, beta2=0.997,
                     epsilon=1e-9, weight_decay=0.0, multi_precision=True)
    return sched, opt.bind(m)


def wmt_batch(padded_src: bool) -> dict:
    """Token ids drawn from ``WMT_SEED`` on the card: sources of lengths
    in [256, 512] (full length unless ``padded_src``) padded with
    ``WMT_PAD``, their bool key-padding mask ``[B, 1, 1, S]`` (None
    without padding) as ``src_mask`` and ``memory_mask``; targets of
    lengths in [256, 512] (the labels after the pad are ignored), the
    decoder input one token behind the labels, and the causal mask."""
    import torch
    from paddle_tpu_torch import nn
    g = torch.Generator(device=DEVICE)
    g.manual_seed(WMT_SEED)
    b, s = WMT_BATCH, WMT_SEQ

    def lengths():
        return torch.randint(WMT_MIN_LEN, s + 1, (b,), generator=g,
                             device=DEVICE)
    src_len, tgt_len = lengths(), lengths()
    if not padded_src:
        src_len = torch.full_like(src_len, s)
    pos = torch.arange(s + 1, device=DEVICE)
    keep = pos[None, :s] < src_len[:, None]
    src = torch.randint(1, WMT_VOCAB, (b, s), generator=g, device=DEVICE)
    tgt = torch.randint(1, WMT_VOCAB, (b, s + 1), generator=g,
                        device=DEVICE)
    tgt = torch.where(pos[None, :] <= tgt_len[:, None], tgt, WMT_PAD)
    mask = keep[:, None, None, :] if padded_src else None
    return {"src": torch.where(keep, src, WMT_PAD), "tgt_in": tgt[:, :s],
            "labels": tgt[:, 1:], "src_mask": mask, "memory_mask": mask,
            "tgt_mask": nn.Transformer.generate_square_subsequent_mask(
                s, device=DEVICE)}


def wmt_logits(m, batch):
    out = m.tr(m.emb(batch["src"]), m.emb(batch["tgt_in"]),
               batch["src_mask"], batch["tgt_mask"], batch["memory_mask"])
    return m.head(out)


def wmt_step(m, opt, sched, batch):
    """One train step of the recipe: the loss (``F.cross_entropy`` with
    ``ignore_index`` the pad and label smoothing 0.1) under the
    ``wmt.cross_entropy`` range, backward, the update, the schedule."""
    import torch
    from paddle_tpu_torch.nn import functional as F
    logits = wmt_logits(m, batch)
    with torch.profiler.record_function("wmt.cross_entropy"):
        loss = F.cross_entropy(logits, batch["labels"],
                               ignore_index=WMT_PAD, label_smoothing=0.1)
    loss.backward()
    opt.step()
    sched.step()
    opt.clear_grad()
    return loss.detach()


def wmt_want(flash_route: bool, decode_steps: int = 0) -> dict:
    """Each kernel's launches (and the dense attention calls) in one train
    step, from the layout: per forward 2 LayerNorms an encoder layer and
    3 a decoder layer; the encoder's self- and the decoder's cross
    attention through the flash kernels on the flash route (the decoder's
    self-attention under its causal mask is dense either way, as every
    call is on the recipe's route); one AdamW launch a parameter tensor.
    With ``decode_steps``: the cached decoder, a flash forward (self) and
    a dense call (cross, under ``memory_mask``) a layer and step."""
    L = WMT_LAYERS
    if decode_steps:
        n = L * decode_steps
        return {"flash_attention_fwd": n, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "layer_norm_fwd": 3 * n,
                "layer_norm_bwd": 0, "fused_adamw": 0, "dense_calls": n}
    flash = 2 * L if flash_route else 0
    return {"flash_attention_fwd": flash, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash, "layer_norm_fwd": 5 * L,
            "layer_norm_bwd": 5 * L, "fused_adamw": len(wmt_shapes()),
            "dense_calls": (1 if flash_route else 3) * L}


def wmt_counters():
    """The path's counters: the six kernels' wrappers and the dense
    attention calls, as ``{name: (object, attribute)}``."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adamw as fw
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.nn import functional as F
    mods = (fa, fa, fa, fn, fn, fw)
    return {**{k: (getattr(m, k), "launches")
               for k, m in zip(WMT_KERNELS, mods)},
            "dense_calls": (F.scaled_dot_product_attention, "dense_calls")}


def wmt_zero(counters) -> None:
    for obj, attr in counters.values():
        setattr(obj, attr, 0)


def wmt_read(counters) -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}


def wmt_kernels(card: str) -> dict:
    """Rows 4-6 and 9-11 at this phase's shapes against their plain
    versions, each timed there (CUDA events) beside its bound and a
    library call: the flash kernels on q / k / v [32, 512, 8, 64] bf16,
    non-causal (the encoder's self- and the cross attention on the flash
    route), the flash forward at one query row against
    ``WMT_DECODE_KEYS`` keys (cached decoding's self-attention, under
    row 4's ``decode``), the LayerNorm pair on the rows [16384, 512] bf16, fused
    AdamW over the row's 255 tensors (f32 masters, bf16 gradients and
    parameters) against ``torch.optim.AdamW(fused=True)`` over the same
    tensors in f32."""
    import torch
    from paddle_tpu_torch.kernels.fused_adamw import (fused_adamw,
                                                      fused_adamw_reference)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(7)
    rec = {**flash_rows("[train:wmt]", g, WMT_BATCH, WMT_SEQ, WMT_HEADS,
                        WMT_D // WMT_HEADS, False),
           **layer_norm_rows("[train:wmt]", g, WMT_BATCH * WMT_SEQ, WMT_D)}
    rec["flash_attention_fwd"]["decode"] = flash_decode_rows(
        "[train:wmt]", g, WMT_BATCH, WMT_HEADS, WMT_D // WMT_HEADS,
        WMT_DECODE_KEYS)
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.997, epsilon=1e-9,
              weight_decay=0.0, step=3)
    sets = []
    for sh in wmt_shapes():
        master = torch.randn(sh, generator=g, device=DEVICE)
        sets.append((master,
                     torch.randn(sh, generator=g, device=DEVICE).to(
                         torch.bfloat16),
                     torch.randn(sh, generator=g, device=DEVICE) * 1e-2,
                     torch.rand(sh, generator=g, device=DEVICE) * 1e-3,
                     master.to(torch.bfloat16)))
    numel = sum(t[0].numel() for t in sets)
    err = 0.0
    for master, grad, m, v2, low in sets:
        ref = [t.clone() for t in (master, m, v2, low)]
        fused_adamw(master, grad, m, v2, low=low, **kw)
        fused_adamw_reference(ref[0], grad, ref[1], ref[2], low=ref[3], **kw)
        for nm, got, want in zip(("p", "m", "v", "low"),
                                 (master, m, v2, low), ref):
            ok = torch.allclose(got, want, rtol=1e-6, atol=1e-7) \
                if got.dtype == torch.float32 else \
                _ulp_ok(got, want, got.dtype)
            if not ok:
                raise AssertionError(f"[train:wmt] fused_adamw disagrees "
                                     f"with its plain version on {nm} at "
                                     f"{list(master.shape)}")
            err = max(err, (got.float() - want.float()).abs().max().item())
    del ref
    tps = []
    for master, grad, *_ in sets:
        tp = torch.nn.Parameter(master.clone())
        tp.grad = grad.float()
        tps.append(tp)
    topt = torch.optim.AdamW(tps, lr=1e-4, betas=(0.9, 0.997), eps=1e-9,
                             weight_decay=0.0, fused=True)
    adam_lib = time_ms(topt.step, iters=5, warmup=2, windows=3)
    del tps, topt
    rec["fused_adamw"] = {
        "shape": f"the row's {len(sets)} tensors ({numel} elements): f32 "
                 f"masters, bf16 grads, f32 m/v, bf16 parameter copies "
                 f"(28 B per element), one launch a tensor",
        "max_abs_err": err,
        "ms": time_ms(lambda: [fused_adamw(t[0], t[1], t[2], t[3], low=t[4],
                                           **kw) for t in sets],
                      iters=5, warmup=2, windows=3),
        "plain_ms": time_ms(lambda: [fused_adamw_reference(
            t[0], t[1], t[2], t[3], low=t[4], **kw) for t in sets],
            iters=1, warmup=1, windows=3),
        "bound_ms": numel * 28 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": adam_lib}
    del sets
    torch.cuda.empty_cache()
    log(f"[train:wmt] rows 4-6, 9-11 at this phase's shapes against their "
        f"plain versions (flash, the forward also at one query row against "
        f"{list(WMT_DECODE_KEYS)} keys: FLASH_REL and each element within "
        f"its own limit; LayerNorm: 1e-5 / dw, db 1e-4 of max(1, max "
        f"|plain|) plus an ulp; AdamW: f32 rtol 1e-6, bf16 one ulp), each "
        f"timed beside its plain version, bound and library call: "
        f"{json.dumps(rec)} (card: {card})")
    return rec


def wmt_parity(card: str) -> dict:
    """Step 1 of the recipe (batch, masks, loss and optimizer) at dropout
    0, twice from the same weights: in f32 (TF32 off) and in bf16 (the
    same model cast).  The relative loss gap within
    ``WMT_PARITY_LIMIT``."""
    import torch
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = wmt_model(torch.float32, 0.0, dropout=0.0).to(dtype)
        sched, opt = wmt_optimizer(m)
        losses[str(dtype)] = float(wmt_step(m, opt, sched, wmt_batch(True)))
        del m, opt
        free_card()
    l32, l16 = losses["torch.float32"], losses["torch.bfloat16"]
    gap = abs(l16 - l32) / abs(l32)
    log(f"[train:wmt] parity: step 1 at dropout 0 from the same weights, "
        f"f32 loss {l32:.6f}, bf16 {l16:.6f}, relative gap {gap:.3e} "
        f"(limit {WMT_PARITY_LIMIT}) (card: {card})")
    if not math.isfinite(gap) or gap > WMT_PARITY_LIMIT:
        raise AssertionError(f"[train:wmt] parity gap {gap} over "
                             f"{WMT_PARITY_LIMIT}")
    return {"loss_f32": l32, "loss_bf16": l16, "gap": gap,
            "limit": WMT_PARITY_LIMIT}


def wmt_kinds(events) -> tuple:
    """``(device ms by kind, busy ms, kernels)`` of a chrome trace: the
    port's kernels by name (flash, LayerNorm, AdamW); dense attention and
    cross entropy by the port's ``sdpa.dense`` range (``attention.
    DENSE_RANGE``) / the ``wmt.cross_entropy`` range open at the launch,
    or, in the backward, by the autograd node whose sequence number
    belongs to an op of such a range; the other GEMMs by name; the
    rest."""
    from paddle_tpu_torch.nn.functional.attention import DENSE_RANGE
    kernels, at = ops_at_launch(events)
    ranges = {DENSE_RANGE: "dense_attention",
              "wmt.cross_entropy": "cross_entropy"}
    # the sequence numbers of the ops inside each range
    seqs = {kind: set() for kind in ranges.values()}
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in ranges:
            spans.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 ranges[e["name"]]))
    for e in events:
        q = e.get("args", {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or q is None:
            continue
        ts = float(e["ts"])
        for a, b, kind in spans.get(e["tid"], ()):
            if a <= ts <= b:
                seqs[kind].add(q)
    kinds = ("gemm", "dense_attention", "cross_entropy", "layer_norm",
             "adamw", "flash", "rest")
    ms = {k: 0.0 for k in kinds}
    rest = {}
    for e in kernels:
        name = e["name"]
        opened = at.get(e.get("args", {}).get("correlation"), [])
        kind = None
        if any(x in name for x in ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                                   "dkv_wgmma_kernel")):
            kind = "flash"
        elif any(x in name for x in ("ln_fwd_", "norm_bwd_")):
            kind = "layer_norm"
        elif "adamw_kernel" in name:
            kind = "adamw"
        for r, k in ranges.items():
            if kind is None and any(
                    n == r or ("Backward" in n and q in seqs[k])
                    for n, q in opened):
                kind = k
        if kind is None:
            kind = "gemm" if any(x in name for x in MOE_GEMM) else "rest"
        if kind == "rest":
            rest[name] = rest.get(name, 0.0) + float(e["dur"]) / 1e3
        ms[kind] += float(e["dur"]) / 1e3
    ms["rest_top"] = dict(sorted(rest.items(), key=lambda kv: -kv[1])[:8])
    return ms, busy_ms(kernels), kernels


def wmt_profile(m, opt, sched, batch, card: str, label: str) -> dict:
    """One train step under torch.profiler (CPU and CUDA; a step before
    it warms the profiler): device ms by kind (``wmt_kinds``) and the busy
    share, the union of the kernel intervals over the step's wall
    time."""
    import shutil
    import tempfile

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    root = tempfile.mkdtemp(prefix="wmt_profile_")
    path = os.path.join(root, "trace.json")
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):
                t = time.perf_counter()
                float(wmt_step(m, opt, sched, batch))
                walls.append((time.perf_counter() - t) * 1e3)
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ms, busy, kernels = wmt_kinds(events)
    top = {k[:90]: v for k, v in ms.pop("rest_top").items()}
    out = {"wall_ms": walls[1], "kernel_events": len(kernels),
           "device_ms_by_kind": ms, "device_ms": sum(ms.values()),
           "rest_top_ms": top, "busy_ms": busy,
           "busy_share": busy / walls[1] if walls[1] else None}
    log(f"[train:wmt] {label}: one step under torch.profiler: "
        f"{walls[1]:.1f} ms wall, {len(kernels)} kernels, {busy:.1f} ms "
        f"busy (share {out['busy_share']:.3f}); device ms by kind "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}; the rest's "
        f"largest {json.dumps({k: round(v, 3) for k, v in top.items()})} "
        f"(card: {card})")
    if not kernels or ms["gemm"] <= 0 or ms["layer_norm"] <= 0 \
            or ms["adamw"] <= 0:
        raise AssertionError(f"[train:wmt] {label}: the profile shows no "
                             f"GEMM, LayerNorm or AdamW time: "
                             f"{json.dumps(ms)}")
    return out


def wmt_mha_check(m, card: str) -> dict:
    """One ``MultiHeadAttention`` call of the model (the first encoder
    layer's, attention dropout 0) at [32, 512, 512] bf16 through the
    flash kernels (no mask) and through the dense form (an all-keep
    mask): the output and the gradients of the query input and of the
    q / k / v / out projection weights within ``WMT_MHA_REL`` of
    max(1, max |dense|)."""
    import torch
    mha = m.tr.encoder.layers[0].self_attn
    g = torch.Generator(device=DEVICE)
    g.manual_seed(11)
    x = torch.randn(WMT_BATCH, WMT_SEQ, WMT_D, generator=g,
                    device=DEVICE).to(torch.bfloat16).requires_grad_()
    gy = torch.randn(WMT_BATCH, WMT_SEQ, WMT_D, generator=g,
                     device=DEVICE).to(torch.bfloat16)
    names = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
             "out_proj.weight")
    params = dict(mha.named_parameters())
    keep = torch.ones(WMT_BATCH, 1, 1, WMT_SEQ, dtype=torch.bool,
                      device=DEVICE)
    res = {}
    for route, mask in (("flash", None), ("dense", keep)):
        out = mha(x, attn_mask=mask)
        res[route] = [out] + list(torch.autograd.grad(
            out, [x] + [params[n] for n in names], gy))
    errs = {}
    for what, got, want in zip(("out", "d_query") + names, res["flash"],
                               res["dense"]):
        scale = max(1.0, want.float().abs().max().item())
        errs[what] = (got.float() - want.float()).abs().max().item() / scale
    log(f"[train:wmt] one MultiHeadAttention call at [{WMT_BATCH}, "
        f"{WMT_SEQ}, {WMT_D}] bf16, flash against dense, error relative to "
        f"max(1, max |dense|): {json.dumps(errs)} (limit {WMT_MHA_REL}) "
        f"(card: {card})")
    if max(errs.values()) > WMT_MHA_REL:
        raise AssertionError(f"[train:wmt] MHA flash against dense: {errs}")
    return {"rel_err": errs, "limit": WMT_MHA_REL}


def wmt_decode(m, batch, card: str, counters) -> tuple:
    """Cached decoding on the trained model in eval: the encoder's memory
    of the padded sources, ``decoder.gen_cache(memory)``, then
    ``WMT_DECODE_STEPS`` steps of one target token for each of the 32
    rows (teacher-forced: the batch's decoder input), the counts zeroed
    just before and read just after.  Every step's logits against the
    uncached decoder over the same prefix under the causal mask, within
    ``WMT_DECODE_LIMIT``; ms a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import nn
    n = WMT_DECODE_STEPS
    m.eval()
    try:
        with torch.no_grad():
            memory = m.tr.encoder(m.emb(batch["src"]), batch["src_mask"])
            cache = m.tr.decoder.gen_cache(memory)
            tgt = batch["tgt_in"][:, :n]
            torch.cuda.synchronize()
            wmt_zero(counters)
            steps, step_ms = [], []
            for t in range(n):
                t0 = time.perf_counter()
                out, cache = m.tr.decoder(m.emb(tgt[:, t:t + 1]), memory,
                                          None, batch["memory_mask"], cache)
                steps.append(m.head(out)[:, 0].float())
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            got = wmt_read(counters)
            full = m.head(m.tr.decoder(
                m.emb(tgt), memory,
                nn.Transformer.generate_square_subsequent_mask(
                    n, device=DEVICE), batch["memory_mask"])).float()
            scale = max(1.0, full.abs().max().item())
            gap = max((s - full[:, t]).abs().max().item()
                      for t, s in enumerate(steps)) / scale
            agree = float((torch.stack(steps, 1).argmax(-1)
                           == full.argmax(-1)).float().mean())
    finally:
        m.train()
    want = wmt_want(False, n)
    p50 = float(np.median(step_ms))
    rec = {"steps": n, "rows": WMT_BATCH, "step_ms": step_ms,
           "step_ms_p50": p50, "rel_gap": gap, "limit": WMT_DECODE_LIMIT,
           "argmax_agree": agree, "launches": got, "launches_want": want,
           "cache_rows": int(cache[0][0].k.shape[1])}
    log(f"[train:wmt] (c) cached decoding, {WMT_BATCH} rows x {n} steps "
        f"over the padded memory: step p50 {p50:.2f} ms "
        f"({[round(x, 2) for x in step_ms[:4]]} ...), logits against the "
        f"uncached causal decoder {gap:.3e} of max(1, max |logit|) (limit "
        f"{WMT_DECODE_LIMIT}), argmax agreement {agree:.4f}; launches "
        f"{json.dumps(got)} (want {json.dumps(want)}) (card: {card})")
    if got != want:
        raise AssertionError(f"[train:wmt] decoding launches {got} != "
                             f"{want}")
    if not math.isfinite(gap) or gap > WMT_DECODE_LIMIT:
        raise AssertionError(f"[train:wmt] cached decoding gap {gap}")
    return got, rec


def phase_train_wmt(card: str) -> tuple:
    """BASELINE config #2 on the port at the repo's WMT row: rows 4-6 and
    9-11 at the phase's shapes (``wmt_kernels``); step 1 in f32 against
    bf16 (``wmt_parity``); (a) the published recipe (padded sources,
    key-padding and causal masks, dropout 0.1 everywhere, so every
    attention call is dense) and (b) the flash route on the same model
    (attention dropout 0, full-length sources: the encoder's and the
    cross attention on the flash kernels, the decoder's causal
    self-attention dense): ``WMT_WARMUP`` and ``WMT_STEPS`` timed steps
    each with the counts zeroed just before and read just after and held
    to ``wmt_want``; step p50, tokens/s (every target position, and the
    non-pad labels), the model-FLOP share by the row's formula, peak
    memory, one profiled step by kind; (b) one MHA call flash against
    dense; (c) cached decoding on (a)'s model.  Returns each run's
    launches and the records."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = "[train:wmt]"
    counters = wmt_counters()
    out = {"kernels": wmt_kernels(card), "parity": wmt_parity(card),
           "runs": {}}
    launches = {}
    for label, attn_dropout, padded in (("a_recipe", 0.1, True),
                                        ("b_flash", 0.0, False)):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m = wmt_model(torch.bfloat16, attn_dropout)
        sched, opt = wmt_optimizer(m)
        batch = wmt_batch(padded)
        params = list(m.parameters())
        n_params = sum(p.numel() for p in params)
        if (n_params, len(params)) != (WMT_PARAMS, WMT_TENSORS) or \
                [tuple(p.shape) for p in params] != wmt_shapes():
            raise AssertionError(f"{tag} the row has {n_params} parameters "
                                 f"in {len(params)} tensors")
        losses = [float(wmt_step(m, opt, sched, batch))
                  for _ in range(WMT_WARMUP)]
        torch.cuda.synchronize()
        wmt_zero(counters)
        step_ms = []
        for _ in range(WMT_STEPS):
            t = time.perf_counter()
            losses.append(float(wmt_step(m, opt, sched, batch)))
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        got = wmt_read(counters)
        want = {k: v * WMT_STEPS for k, v in wmt_want(not padded).items()}
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        p50 = float(np.median(step_ms))
        positions = WMT_BATCH * WMT_SEQ
        real = int((batch["labels"] != WMT_PAD).sum())
        tok_s = positions / (p50 / 1e3)
        flops = 6 * n_params + 12 * 2 * WMT_LAYERS * WMT_D * WMT_SEQ
        mfu = flops * tok_s / PEAK_FLOPS["bfloat16"]
        rec = {"losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
               "tokens_per_s": tok_s, "target_tokens": real,
               "nonpad_target_tokens_per_s": real / (p50 / 1e3),
               "source_tokens": int((batch["src"] != WMT_PAD).sum()),
               "mfu": mfu, "peak_gb": peak_gb,
               "launches_per_step": {k: v / WMT_STEPS
                                     for k, v in got.items()},
               "launches_per_step_want": {k: v / WMT_STEPS
                                          for k, v in want.items()}}
        out["runs"][label] = rec
        log(f"{tag} {label} (Transformer {WMT_LAYERS} + {WMT_LAYERS}, d "
            f"{WMT_D}, {WMT_HEADS} heads, ffn {WMT_FFN}, vocab {WMT_VOCAB}, "
            f"{n_params} parameters, bf16, batch "
            f"{WMT_BATCH} x {WMT_SEQ}, attention dropout {attn_dropout}, "
            f"{'padded' if padded else 'full-length'} sources "
            f"{rec['source_tokens']} tokens, {real} target labels): step "
            f"p50 {p50:.1f} ms ({[round(x, 1) for x in step_ms]}), "
            f"{tok_s:.0f} tokens/s ({rec['nonpad_target_tokens_per_s']:.0f} "
            f"non-pad target tokens/s), model-FLOP share {mfu:.3f}, peak "
            f"{peak_gb:.2f} GB; losses {[round(x, 5) for x in losses]}; "
            f"launches a step {json.dumps(rec['launches_per_step'])} (want "
            f"{json.dumps(rec['launches_per_step_want'])}) (card: {card})")
        if got != want:
            raise AssertionError(f"{tag} {label}: launches {got} != the "
                                 f"layout's {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag} {label}: losses {losses}")
        launches[label] = got
        rec["profile"] = wmt_profile(m, opt, sched, batch, card, label)
        if padded:
            launches["c_decode"], out["decode"] = wmt_decode(
                m, batch, card, counters)
            if rec["profile"]["device_ms_by_kind"]["dense_attention"] <= 0:
                raise AssertionError(f"{tag} {label}: no dense attention "
                                     f"in the profile")
        else:
            rec["mha_check"] = wmt_mha_check(m, card)
        del m, opt, sched, batch, params
    free_card()
    return launches, out


def run_phase(name: str, fn, *args):
    """``fn(*args)``, then its wall time and its peak device memory (the
    peak is reset just before it)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return out


def free_card() -> None:
    """Return what the finished phases held to the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


AB_KEYS = ("ttft_p50_ms", "ttft_median_ms", "ttft_cold_median_ms",
           "ttft_warm_median_ms", "decode_step_ms_p50", "capture_ms",
           "prefill_capture_ms", "prefill_widths", "graph_pool_gb",
           "peak_mem_gb", "capture_end_ms", "gc_max_ms", "tokens_per_s",
           "prefill_chunks", "decode_steps", "prefill_profile",
           "decode_profile")
# calls of the wrapper a window of its host-time measure makes
HOST_CALLS = 100


def host_us(calls: dict) -> dict:
    """Host microseconds per call of each of ``calls`` (name ->
    function): windows of ``HOST_CALLS`` calls back to back with no sync
    (the host never waits on the card, whose queue holds them all), the
    calls' windows in turns, the median of 5 after a warm-up round."""
    import statistics

    import torch
    windows = {name: [] for name in calls}
    for i in range(6):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            if i:
                windows[name].append((time.perf_counter() - t0)
                                     / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return {name: statistics.median(w) for name, w in windows.items()}


def wrapper_times() -> dict:
    """``decode_attention`` at the four serving shapes: the events time,
    the card's time and the wrapper's host time per call (``host_us``);
    at the decode shapes also the host time of the same call in f32, in
    turns with it in one process: the same Python, with neither tensor
    maps nor a workspace on either tree."""
    import torch
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    times = {}
    for name, (qs, ks, lens) in DECODE_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device=DEVICE)
                   .to(torch.bfloat16) for shape in (qs, ks, ks))
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=DEVICE)

        def call(q=q, k=k, v=v):
            return decode_attention(q, k, v, seq_lens)
        calls = {"host_us": call}
        if qs[1] == 1:
            f32 = [x.float() for x in (q, k, v)]
            calls["host_us_f32"] = lambda: call(*f32)
        times[name] = {"ms": time_ms(call), "device_ms": device_ms(call),
                       **host_us(calls)}
    return times


def gemv_times() -> dict:
    """Each GEMV_SHAPES shape through ``decode_block._gemv``, the call both
    trees make (the parent's split-K kernel or this tree's stream kernel),
    on 4 weight copies in turn: the card's time a call."""
    import torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_block as db
    lib = _build.load("decode_block")
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    out = {}
    for (name, k, widths, rows, in_mode, x32, o32, res, act,
         bias) in GEMV_SHAPES:
        cases = [gemv_case(g, k, widths, rows, in_mode, x32, res, bias)
                 for _ in range(4)]
        n = sum(widths)
        y = torch.empty((rows, n), dtype=torch.float32 if o32
                        else torch.bfloat16, device=dev)
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % 4
            x, ws, bs, kw = cases[state["i"]]
            r = kw.get("res")

            def ptr(t):
                return None if t is None else t.data_ptr()
            db._gemv(lib.decode_block_gemv,
                     torch.cuda.current_stream(dev).cuda_stream, dtype=2,
                     inp=x.data_ptr(), ld_in=x.stride(0), K=k, rows=rows,
                     weights=[(w, w.stride(0)) for w in ws],
                     biases=[ptr(b) for b in bs], out=y.data_ptr(),
                     ld_out=n, out_f32=int(o32),
                     cap=db._pick_block_f(2, db.SMEM_BUDGET), itemsize=2,
                     device=dev, in_mode=in_mode, in_f32=int(x32),
                     stats=ptr(kw.get("stats")), nw=ptr(kw.get("norm_w")),
                     nb=ptr(kw.get("norm_b")), res=ptr(r),
                     ld_res=0 if r is None else r.stride(0),
                     res_f32=int(res == "f32"), act=act)
        out[name] = {"device_ms": device_ms(call), "ms": time_ms(call)}
        del cases, y
    torch.cuda.empty_cache()
    return out


def block_times() -> dict:
    """decode_block_attn and decode_block_mlp at one gpt3_6_7b and one
    llama_7b layer (random bf16 weights, 8 slots), and the tp=2 shard
    attention ``decode_block_attn_tp`` at both models' shard shapes
    (``ATTN_TP_SHARDS``, 4 slab copies in turn): the card's time a call;
    the wrappers', both ring hops' and ``layer_norm_fwd``'s (x [8, 4096])
    host time a call (``host_us``)."""
    import torch
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels.decode_block import (decode_block_attn,
                                                       decode_block_mlp)
    from paddle_tpu_torch.kernels.decode_block_tp import (
        decode_block_attn_tp, ring_entry_hop, ring_exit_hop)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    out = {}
    for model, s_max, ffn, wiring in (("gpt3_6_7b", 2048, 16384, "gpt"),
                                      ("llama_7b", 4096, 11008, "llama")):
        x, k, v, kw = block_case(g, b=8, s_max=s_max, heads=32, kv_heads=32,
                                 dh=128, ffn=ffn, dtype=torch.bfloat16,
                                 wiring=wiring)
        pos = torch.full((8,), s_max // 2, dtype=torch.int32, device=dev)
        attn, _, _ = attn_call(decode_block_attn, x, k, v, pos, kw)

        def a_call():
            return attn_call(decode_block_attn, x, k, v, pos, kw)

        def m_call():
            return mlp_call(decode_block_mlp, x, attn, kw)
        out[model] = {"attn_device_ms": device_ms(a_call),
                      "mlp_device_ms": device_ms(m_call)}
        if model == "gpt3_6_7b":
            hx = torch.randn((4, 4096), generator=g, device=dev).to(
                torch.bfloat16)
            hw = kw["wq"][:, :2048].contiguous()
            hy = torch.randn((4, 2048), generator=g, device=dev).to(
                torch.bfloat16)
            hwo = kw["wo"][:2048].contiguous()
            out["host_us"] = host_us({
                "decode_block_attn": a_call, "decode_block_mlp": m_call,
                "ring_entry_hop": lambda: ring_entry_hop(hx, hw),
                "ring_exit_hop": lambda: ring_exit_hop(hy, hwo)})
        del x, k, v, kw, attn
        torch.cuda.empty_cache()
    for model in ATTN_TP_SHARDS:
        q, k, v, slabs, nxt, pos, akw = attn_tp_shard(g, model)

        def t_call():
            return decode_block_attn_tp(q, k, v, *nxt(), pos, **akw)
        out[model]["attn_tp_device_ms"] = device_ms(t_call)
        out[model]["attn_tp_ms"] = time_ms(t_call)
        if model == "gpt3_6_7b":
            xn = torch.randn((8, 4096), generator=g, device=dev).to(
                torch.bfloat16)
            wn, bn = xn[0].clone(), xn[1].clone()
            out["host_us"].update(host_us({
                "decode_block_attn_tp": t_call,
                "layer_norm_fwd": lambda: fn.layer_norm_fwd(xn, wn, bn,
                                                            NORM_EPS)}))
        del slabs
        torch.cuda.empty_cache()
    return out


def norm_times() -> dict:
    """``layer_norm_fwd`` beside ``F.layer_norm``, and ``rms_norm_bwd`` /
    ``layer_norm_bwd`` beside the autograd backward of ``F.rms_norm`` /
    ``F.layer_norm``, on x (and g) [rows, 4096] at ``NORM_TIMED``'s rows
    and dtypes (bf16 at the decode, prefill-chunk and train rows, f32 at
    the train rows), on 4 copies in turn (the train shape's then stream
    from device memory): each one's events ms, device ms (and its split
    by kernel) and host µs a call (``host_us``), and the bound, in one
    process, as ``{kernel: {shape: record}}``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_norm as fn
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    h = 4096
    lib_rms = getattr(F, "rms_norm", None)
    out = {"layer_norm_fwd": {}, "rms_norm_bwd": {}, "layer_norm_bwd": {}}
    for shape, (rows, dname) in NORM_TIMED.items():
        dtype = getattr(torch, dname)
        w = (torch.randn(h, generator=g, device=dev) * 0.5 + 1).to(dtype)
        b = (torch.randn(h, generator=g, device=dev) * 0.3).to(dtype)

        def make():
            x = (torch.randn((rows, h), generator=g, device=dev) * 2
                 + 0.5).to(dtype)
            gy = torch.randn((rows, h), generator=g, device=dev).to(dtype)
            _, rstd = fn.rms_norm_fwd_reference(x, w, NORM_EPS)
            _, mean, lrstd = fn.layer_norm_fwd_reference(x, w, b, NORM_EPS)
            xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
            return {"x": x, "g": gy, "rstd": rstd, "mean": mean,
                    "lrstd": lrstd, "leaves": (xr, wr, br),
                    "ln_y": F.layer_norm(xr, (h,), wr, br, NORM_EPS),
                    "rms_y": None if lib_rms is None else
                    lib_rms(xr, (h,), wr, NORM_EPS)}
        items, nxt = _cycled(make)

        def ln_fwd():
            return fn.layer_norm_fwd(nxt()["x"], w, b, NORM_EPS)

        def ln_fwd_lib():
            return F.layer_norm(nxt()["x"], (h,), w, b, NORM_EPS)

        def rms_bwd():
            c = nxt()
            return fn.rms_norm_bwd(c["x"], w, c["rstd"], c["g"])

        def rms_bwd_lib():
            c = nxt()
            return torch.autograd.grad(c["rms_y"], c["leaves"][:2], c["g"],
                                       retain_graph=True)

        def ln_bwd():
            c = nxt()
            return fn.layer_norm_bwd(c["x"], w, c["mean"], c["lrstd"],
                                     c["g"])

        def ln_bwd_lib():
            c = nxt()
            return torch.autograd.grad(c["ln_y"], c["leaves"], c["g"],
                                       retain_graph=True)
        for name, kern, lib in (
                ("layer_norm_fwd", ln_fwd, ln_fwd_lib),
                ("rms_norm_bwd", rms_bwd,
                 None if lib_rms is None else rms_bwd_lib),
                ("layer_norm_bwd", ln_bwd, ln_bwd_lib)):
            calls = {"kernel": kern} if lib is None else {"kernel": kern,
                                                          "library": lib}
            host = host_us(calls)
            by_kernel = device_ms_by_kernel(kern)
            es = dtype.itemsize
            rec = {"rows": rows, "dtype": dname, "ms": time_ms(kern),
                   "device_ms": sum(by_kernel.values()),
                   "device_by_kernel": {k[:80]: v
                                        for k, v in by_kernel.items()},
                   "host_us": host["kernel"],
                   "bound_ms": norm_bound(name, rows, h, es, es)[0]}
            rec.update({"library_ms": None, "library_device_ms": None,
                        "library_host_us": None} if lib is None else {
                "library_ms": time_ms(lib), "library_device_ms":
                device_ms(lib), "library_host_us": host["library"]})
            out[name][shape] = rec
        del items
    torch.cuda.empty_cache()
    return out


def tp2_serving(card: str) -> dict:
    """The full-depth gpt3_6_7b served at tp=2 on ``tp_fused_block`` (both
    shards on the card, every decode step through the ring hops): a warm
    round, then ``serve_run``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_6_7b
    from paddle_tpu_torch.serving import ServingEngine
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    cfg = gpt3_6_7b()
    model = GPTForCausalLM(cfg, device=DEVICE, generator=gen).eval()
    rs = np.random.RandomState(3)
    eng = ServingEngine(model, fused_decode=True, tensor_parallel=TP,
                        devices=TP_DEVICES, **ENGINE_KW)
    eng.serve_batch([rs.randint(0, cfg.vocab_size, (n,))
                     for n in (600, 64, 300, 130, 700, 64, 1000, 200)],
                    max_new_tokens=4)
    eng.close()
    _, res = serve_run(model, card, True, SERVE_WAVES["gpt"], tp=TP)
    del model
    free_card()
    return {k: res.get(k) for k in AB_KEYS}


def ab_child(root: str) -> int:
    """One side of ``--serve-ab``: this file's serving phases (GPT, then
    Llama) and ``wrapper_times`` on the ``paddle_tpu_torch`` of the
    checkout at ``root``, built from its own sources; prints their results
    as the last line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from paddle_tpu_torch.kernels import _build
    if not _build.__file__.startswith(root):
        raise AssertionError(f"imported {_build.__file__}, not {root}")
    _build.build(sorted(f[:-3] for f in os.listdir(_build._CSRC)
                        if f.endswith(".cu")))
    card = card_line()
    out = {"root": root, "card": card, "decode_attention": wrapper_times(),
           "gemv": gemv_times(), "block": block_times(),
           "norm": norm_times()}
    free_card()
    for family in ("gpt", "llama"):
        runs = phase_serving(card, family)
        out[family] = {path: {k: runs[path][1].get(k) for k in AB_KEYS}
                       for path in ("unfused", "fused")}
        del runs
        free_card()
    out["tp2"] = tp2_serving(card)
    print(json.dumps(out), flush=True)
    return 0


def serve_ab(parent: str) -> int:
    """``python3 chip_smoke.py --serve-ab PARENT``: ``ab_child`` on the
    checkout at PARENT and on this one, in turns (parent, this, this,
    parent), each in its own process on the one card; logs each side's
    numbers and the wrapper's host time per decode step (a call per
    layer) against the parent's."""
    import statistics

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --serve-ab needs a CUDA card", file=sys.stderr)
        return 2
    results = []
    for root in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-child", root],
                              capture_output=True, text=True, timeout=1500)
        sys.stderr.write(proc.stderr[-3000:])
        if proc.returncode != 0:
            print(proc.stdout[-6000:])
            raise AssertionError(f"the serving run of {root} failed "
                                 f"(exit {proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        side = "parent" if res["root"] != HERE else "change"
        results.append({"side": side, **res})
        for name, t in res["decode_attention"].items():
            f32 = (f", f32 {t['host_us_f32']:.2f}" if "host_us_f32" in t
                   else "")
            log(f"[serve-ab] {side} decode_attention {name}: {t['ms']:.4f} "
                f"ms (device {t['device_ms']:.4f}), host "
                f"{t['host_us']:.2f} us a call{f32} (card: {res['card']})")
        for family in ("gpt", "llama"):
            for path in ("unfused", "fused"):
                r = res[family][path]
                prof = (r.get("prefill_profile") or {}).get("chunks") or []
                top = prof[-1]["top_kernels_ms"] if prof else {}
                log(f"[serve-ab] {side} {family} {path}: TTFT median "
                    f"{r['ttft_median_ms']:.2f} ms (histogram p50 "
                    f"{r['ttft_p50_ms']}), decode step p50 "
                    f"{r['decode_step_ms_p50']} ms, {r['tokens_per_s']} "
                    f"tokens/s; last prefill chunk's device ms "
                    f"{[round(c['device_ms'], 4) for c in prof][-1:]}, "
                    f"longest kernels {json.dumps(top)} "
                    f"(card: {res['card']})")
    # the unfused decode step calls the wrapper once a layer (32 layers in
    # both models)
    # host time a call: each tree's median over its turns, and its bf16
    # call against the f32 one of the same process (the 16-bit path's own
    # host work: on the change the workspace and two tensor maps)
    for name in ("decode", "llama_decode"):
        host, own = {}, {}
        for side in ("parent", "change"):
            ts = [r["decode_attention"][name] for r in results
                  if r["side"] == side]
            host[side] = statistics.median(t["host_us"] for t in ts)
            own[side] = statistics.median(t["host_us"] - t["host_us_f32"]
                                          for t in ts)
        log(f"[serve-ab] decode_attention host time at the {name} shape: "
            f"parent {host['parent']:.2f} us, change {host['change']:.2f} "
            f"us a call ({(host['change'] - host['parent']) * 32e-3:+.4f} "
            f"ms per 32-layer unfused decode step); bf16 - f32 in one "
            f"process: parent {own['parent']:+.2f} us, change "
            f"{own['change']:+.2f} us")
    def med(side, get):
        vals = [get(r) for r in results if r["side"] == side]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    slower = []
    for name in results[0]["gemv"]:
        p = med("parent", lambda r: r["gemv"][name]["device_ms"])
        c = med("change", lambda r: r["gemv"][name]["device_ms"])
        slower += [name] if c > p else []
        log(f"[serve-ab] gemv {name}: device {p:.4f} -> {c:.4f} ms "
            f"({c / p:.3f}x; card: {results[0]['card']})")
    for model in ("gpt3_6_7b", "llama_7b"):
        for half in ("attn", "mlp"):
            key = f"{half}_device_ms"
            p = med("parent", lambda r: r["block"][model][key])
            c = med("change", lambda r: r["block"][model][key])
            slower += [f"{model} {half}"] if c > p else []
            log(f"[serve-ab] decode_block_{half} at {model}: device "
                f"{p:.4f} -> {c:.4f} ms")
    for model in ATTN_TP_SHARDS:
        for key in ("attn_tp_device_ms", "attn_tp_ms"):
            p = med("parent", lambda r: r["block"][model][key])
            c = med("change", lambda r: r["block"][model][key])
            slower += [f"{model} {key}"] if c > p else []
            log(f"[serve-ab] decode_block_attn_tp at the {model} tp={TP} "
                f"shard ({key}): {p:.4f} -> {c:.4f} ms ({c / p:.3f}x)")
    for name, times in results[0]["norm"].items():
        for shape, t0 in times.items():
            for key in ("device_ms", "ms", "host_us", "library_device_ms",
                        "library_ms", "library_host_us"):
                p = med("parent", lambda r: r["norm"][name][shape][key])
                c = med("change", lambda r: r["norm"][name][shape][key])
                if key in ("device_ms", "ms") and c > p:
                    slower.append(f"{name} {shape} {key}")
                log(f"[serve-ab] {name} {shape} x [{t0['rows']},4096] "
                    f"{t0['dtype']} {key}: parent {p} -> change {c}")
            for r in results:
                split = r["norm"][name][shape]["device_by_kernel"]
                log(f"[serve-ab] {r['side']} {name} {shape} device ms by "
                    f"kernel: {json.dumps(split)}")
    for name in results[0]["block"]["host_us"]:
        p = med("parent", lambda r: r["block"]["host_us"][name])
        c = med("change", lambda r: r["block"]["host_us"][name])
        log(f"[serve-ab] {name} host time a call: {p:.2f} -> {c:.2f} us")
    for family in ("gpt", "llama"):
        for path in ("unfused", "fused"):
            for key, get in (
                    ("decode step p50 ms",
                     lambda r: r[family][path]["decode_step_ms_p50"]),
                    ("kernel ms a decode step (profiled)",
                     lambda r: (r[family][path]["decode_profile"] or {})
                     .get("device_ms_per_step")),
                    ("wall ms a decode step (profiled)",
                     lambda r: (r[family][path]["decode_profile"] or {})
                     .get("wall_ms_per_step")),
                    ("busy share (profiled)",
                     lambda r: (r[family][path]["decode_profile"] or {})
                     .get("busy_share")),
                    ("profile's step without the profiler ms",
                     lambda r: (r[family][path]["decode_profile"] or {})
                     .get("step_ms_unprofiled")),
                    ("TTFT median ms",
                     lambda r: r[family][path]["ttft_median_ms"]),
                    ("TTFT median ms, cold pass",
                     lambda r: r[family][path]["ttft_cold_median_ms"]),
                    ("TTFT median ms, warm pass",
                     lambda r: r[family][path]["ttft_warm_median_ms"]),
                    ("peak memory GB over the run",
                     lambda r: r[family][path]["peak_mem_gb"]),
                    ("prefill chunk wall ms (profiled, median)",
                     lambda r: (r[family][path]["prefill_profile"] or {})
                     .get("wall_ms_median")),
                    ("prefill chunk busy share (profiled, median)",
                     lambda r: (r[family][path]["prefill_profile"] or {})
                     .get("busy_share_median")),
                    ("prefill chunk wall ms (unprofiled, median)",
                     lambda r: (r[family][path]["prefill_profile"] or {})
                     .get("wall_ms_unprofiled_median")),
                    ("prefill chunk kernels over unprofiled wall (median)",
                     lambda r: (r[family][path]["prefill_profile"] or {})
                     .get("busy_share_unprofiled_median"))):
                log(f"[serve-ab] {family} {path} {key}: parent "
                    f"{med('parent', get)} -> change {med('change', get)}")
            for r in results:
                p = r[family][path]
                log(f"[serve-ab] {r['side']} {family} {path}: prefill "
                    f"widths {p['prefill_widths']}, capture ms per width "
                    f"{json.dumps(p['prefill_capture_ms'])}, decode capture "
                    f"{p['capture_ms']} ms, graph pool {p['graph_pool_gb']} "
                    f"GB")
    for key, get in (("decode step p50 ms",
                      lambda r: r["tp2"]["decode_step_ms_p50"]),
                     ("kernel ms a decode step (profiled)",
                      lambda r: (r["tp2"]["decode_profile"] or {})
                      .get("device_ms_per_step")),
                     ("wall ms a decode step (profiled)",
                      lambda r: (r["tp2"]["decode_profile"] or {})
                      .get("wall_ms_per_step")),
                     ("busy share (profiled)",
                      lambda r: (r["tp2"]["decode_profile"] or {})
                      .get("busy_share")),
                     ("profile's step without the profiler ms",
                      lambda r: (r["tp2"]["decode_profile"] or {})
                      .get("step_ms_unprofiled")),
                     ("TTFT median ms", lambda r: r["tp2"]["ttft_median_ms"]),
                     ("TTFT median ms, cold pass",
                      lambda r: r["tp2"]["ttft_cold_median_ms"]),
                     ("TTFT median ms, warm pass",
                      lambda r: r["tp2"]["ttft_warm_median_ms"]),
                     ("peak memory GB over the run",
                      lambda r: r["tp2"]["peak_mem_gb"])):
        log(f"[serve-ab] gpt tp=2 tp_fused_block {key}: parent "
            f"{med('parent', get)} -> change {med('change', get)}")
    log(f"[serve-ab] slower than the parent (medians of 2 turns): "
        f"{slower or 'none'}")
    sass_rep = sass_ab(parent)
    # the whole record is too long for the end of a log: it goes to a file
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_ab.json")
    with open(path, "w") as f:
        json.dump({"serve_ab": results, "sass": sass_rep,
                   "slower": slower}, f)
    log(f"[serve-ab] every turn's numbers: {path}")
    return 0


def sass_ab(parent: str) -> dict:
    """The kernels this change leaves as they were, instruction for
    instruction against the parent's build (``kernels.sass.compare``):
    the f32 GEMV and the decode block's other kernels, the sharded
    block's GEMV (the ring hops) and f32 attention, the norm forward
    kernels, and every instantiation of flash_attention.cu and
    decode_attention.cu."""
    import glob
    from paddle_tpu_torch.kernels import _build, sass
    out = {}
    for name, kernels in (
            ("decode_block", ["gemv_kernelIf", "attn_", "row_stats"]),
            ("decode_block_tp", ["gemv_kernelIf", "gemv_stream_kernel",
                                 "attn_tp_kernelIf"]),
            ("fused_norm", ["rms_fwd_kernel", "ln_fwd_rows_kernel",
                            "ln_fwd_kernel"]),
            ("flash_attention", [""]), ("decode_attention", [""])):
        old = sorted(glob.glob(os.path.join(
            parent, "paddle_tpu_torch", "kernels", "_build",
            f"lib{name}-*.so")), key=os.path.getmtime)[-1]
        rep = sass.compare(old, str(_build._library_path(name)), kernels)
        same = sum(r["same"] for r in rep.values())
        out[name] = {"same": same, "of": len(rep),
                     "different": [k for k, r in rep.items() if not r["same"]]}
        log(f"[serve-ab] sass compare {name} {kernels}: {same} of "
            f"{len(rep)} instantiations the same instructions as the "
            f"parent's")
        if same != len(rep) or not rep:
            raise AssertionError(f"{name}: kernels this change keeps differ "
                                 f"from the parent's: {out[name]}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using "
        f"{torch.cuda.get_device_name(0)}")
    sources = sorted(f[:-3] for f in os.listdir(_build._CSRC)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    built = _build.build(sources)
    log(f"[device] built {sources} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 2) for k, v in built.items()})})")

    rec, err = run_phase("kernels", phase_kernels, card)
    block = run_phase("block kernels", phase_block_kernels, card)
    gemv_rec = run_phase("gemv", phase_gemv, card)
    tiny = run_phase("tiny serving", phase_tiny_serving, card)
    norm_recs = run_phase("norm kernels", phase_norm_kernels, card)
    runs = run_phase("serving:gpt", phase_serving, card, "gpt")
    run_phase("parity:gpt", phase_parity, "gpt")
    free_card()
    llama_runs = run_phase("serving:llama", phase_serving, card, "llama")
    run_phase("parity:llama", phase_parity, "llama")
    llama_parity = run_phase("train-parity:llama", phase_train_parity,
                             "llama")
    # tensor parallelism at tp=2, both shards on the card
    free_card()
    tp_recs = run_phase("tp kernels", phase_tp_kernels, card)
    tp_runs = run_phase("serving:tp", phase_serving_tp, card,
                        {"gpt": runs, "llama": llama_runs})
    # speculative decoding on four engines, then decode_attention at the
    # verify width and the fused block's attention at long caches
    free_card()
    spec = run_phase("serving:spec", phase_serving_spec, card)
    # fault-tolerant serving: injected faults on full-width engines
    free_card()
    chaos = run_phase("serving:chaos", phase_serving_chaos, card)
    # the journal and the AOT store: a warm engine, a crash and its replay,
    # a quarantine's re-attach, a host with no compiler
    free_card()
    durable = run_phase("serving:durable", phase_serving_durable, card)
    # the fleet tier: replicas on the one model, the KV handoff, failover,
    # hedging, the autoscaler
    free_card()
    fleet = run_phase("serving:fleet", phase_serving_fleet, card)
    # the train phases start from an empty card
    free_card()
    train_recs = run_phase("train kernels", phase_train_kernels, card)
    varlen_launches, varlen_recs = run_phase("varlen", phase_varlen, card)
    train_launches, train = run_phase("train:gpt", phase_train, card, "gpt")
    train["parity"] = run_phase("train-parity:gpt", phase_train_parity,
                                "gpt")
    free_card()
    hybrid_launches, hybrid = run_phase("train:hybrid", phase_train_hybrid,
                                        card)
    free_card()
    example_launches, example = run_phase("train:example",
                                          phase_train_example, card)
    # the semi-auto Engine (llama_7b widths, dp 2 x mp 4) and the profiler
    free_card()
    semi_launches, semi = run_phase("train:semi_auto", phase_train_semi_auto,
                                    card)
    # expert-parallel GPT-MoE at the production MoE width
    free_card()
    moe_launches, moe_train = run_phase("train:moe", phase_train_moe, card)
    # BASELINE config #2: the nn.Transformer encoder-decoder at WMT shape
    free_card()
    wmt_launches, wmt = run_phase("train:wmt", phase_train_wmt, card)
    free_card()
    llama_launches, llama_train = run_phase("train:llama", phase_train, card,
                                            "llama")
    llama_train["parity"] = llama_parity

    (launches_u, serving_u), (launches_f, serving_f) = (
        runs["unfused"], runs["fused"])
    (llama_u, llama_serving_u), (llama_f, llama_serving_f) = (
        llama_runs["unfused"], llama_runs["fused"])
    d = rec["decode"]
    # the speculative engines' runs (their spec_k=4 engines)
    spec_l = {label: r["spec"]["launches"]
              for label, r in spec["engines"].items()}
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/kernels/decode_attention.py:42",
        # 16-bit: the split walk at sq == 1, wgmma for chunks; f32: FMA
        "kernels": ["decode_split_kernel", "chunk_wgmma_kernel",
                    "decode_sq1_kernel (f32)", "decode_tile_kernel (f32)"],
        "launches": launches_u["decode_attention"],
        "launches_by_path": {"unfused": launches_u["decode_attention"],
                             "fused": launches_f["decode_attention"],
                             "llama_unfused": llama_u["decode_attention"],
                             "llama_fused": llama_f["decode_attention"],
                             **{f"spec_{k}": v["decode_attention"]
                                for k, v in spec_l.items()},
                             "durable_attach":
                                 durable["launches_attach"][
                                     "decode_attention"],
                             "fleet": fleet["launches"]["decode_attention"]},
        "max_abs_err": err,
        "ms": d["ms"], "device_ms": d["device_ms"],
        "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"],
        "shape": "decode q[8,1,32,128] kv[8,2048,32,128] seq_len 1024 bf16",
        "prefill": rec["prefill"],
        "llama_decode": rec["llama_decode"],
        "llama_prefill": rec["llama_prefill"],
        "bit_identical": d["bit_identical"],
        "sweep_cases": rec["sweep_cases"],
        "sweep_max_abs_err": rec["sweep_max_abs_err"],
        "sass": rec["sass"],
        # the verify step's shape: 8 slots x 5 queries at 1024 / 3072 rows
        "verify": spec["verify_attention"],
    }]
    for half, line in (("attn", 313), ("mlp", 562)):
        name = f"decode_block_{half}"
        r = block[half]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/decode_block.cu",
            "replaces": f"paddle_tpu/kernels/decode_block.py:{line}",
            "launches": launches_f[name],
            "launches_by_path": {"fused": launches_f[name],
                                 "llama_fused": llama_f[name],
                                 "spec_gpt_fused": spec_l["gpt_fused"][name]},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "unfused_layer_ms": r["unfused_layer_ms"],
            "layer_ms": r["layer_ms"],
            "sweep_max_abs_err": r["sweep_max_abs_err"],
            "shape": r["shape"],
            "llama_7b": r["llama_7b"],
            # the attention half at gpt3_6_7b width over longer caches
            **({"long_cache": spec["block_attn_long"]} if half == "attn"
               else {}),
            # the GEMV of its projections, alone at each projection's shape
            "gemv": {k: gemv_rec["shapes"][k] for k in GEMV_BY_KERNEL[name]},
            "gemv_checks": {k: gemv_rec[k] for k in (
                "sweep_cases", "sweep_max_abs_err", "sass",
                "graph_replay_bit_identical")},
        })
    for name, line, src in (
            ("flash_attention_fwd", 77, "flash_attention"),
            ("flash_attention_bwd_dq", 199, "flash_attention"),
            ("flash_attention_bwd_dkv", 248, "flash_attention"),
            ("fused_adamw", 25, "fused_adamw")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"paddle_tpu/kernels/{src}.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"train": train_launches[name],
                                 "llama_train": llama_launches[name],
                                 **{f"hybrid_{k}": v[name]
                                    for k, v in hybrid_launches.items()},
                                 "example": example_launches[name],
                                 "semi_auto": semi_launches.get(name, 0),
                                 **{f"moe_{k}": v[name]
                                    for k, v in moe_launches.items()},
                                 **{f"wmt_{k}": v[name]
                                    for k, v in wmt_launches.items()}},
            **train_recs[name]})
        if name in semi["kernels"]:
            kernels[-1]["semi_auto"] = semi["kernels"][name]
        kernels[-1]["moe"] = moe_train["kernels"][name]
        kernels[-1]["wmt"] = wmt["kernels"][name]
    # the segment-id variant: the packed flash_attn_unpadded call
    for name, line in (("flash_attention_fwd", 77),
                       ("flash_attention_bwd_dq", 199),
                       ("flash_attention_bwd_dkv", 248)):
        kernels.append({
            "name": f"{name} (segments)",
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line} (seg)",
            "launches": varlen_launches[name],
            "launches_by_path": {"varlen": varlen_launches[name]},
            **varlen_recs[name]})
    # the norm kernels' main paths: Llama serving (unfused) and training
    # for RMSNorm, GPT serving (unfused) and training for LayerNorm
    by_path = {
        "rms_norm_fwd": {"llama_unfused": llama_u, "llama_fused": llama_f,
                         "llama_train": llama_launches,
                         "semi_auto": semi_launches,
                         "spec_llama_unfused": spec_l["llama_unfused"]},
        "rms_norm_bwd": {"llama_train": llama_launches,
                         "semi_auto": semi_launches},
        "layer_norm_fwd": {"unfused": launches_u, "fused": launches_f,
                           "train": train_launches,
                           **{f"hybrid_{k}": v
                              for k, v in hybrid_launches.items()},
                           **{f"moe_{k}": v
                              for k, v in moe_launches.items()},
                           **{f"wmt_{k}": v
                              for k, v in wmt_launches.items()},
                           "example": example_launches,
                           "durable_attach": durable["launches_attach"],
                           "fleet": fleet["launches"],
                           **{f"spec_{k}": v for k, v in spec_l.items()
                              if k.startswith("gpt")}},
        "layer_norm_bwd": {"train": train_launches,
                           **{f"hybrid_{k}": v
                              for k, v in hybrid_launches.items()},
                           **{f"moe_{k}": v
                              for k, v in moe_launches.items()},
                           **{f"wmt_{k}": v
                              for k, v in wmt_launches.items()
                              if k != "c_decode"},
                           "example": example_launches},
    }
    for name, line in zip(NORM_KERNELS, (22, 30, 167, 179)):
        paths = {path: counts[name] for path, counts in by_path[name].items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_norm.cu",
            "replaces": f"paddle_tpu/kernels/fused_norm.py:{line}",
            "launches": next(iter(paths.values())),
            "launches_by_path": paths,
            **norm_recs[name]})
        if name in semi["kernels"]:
            kernels[-1]["semi_auto"] = semi["kernels"][name]
        if name in moe_train["kernels"]:
            kernels[-1]["moe"] = moe_train["kernels"][name]
        if name in wmt["kernels"]:
            kernels[-1]["wmt"] = wmt["kernels"][name]
        if name == "layer_norm_fwd":
            # rows in registers; a row over 1024 16-byte groups re-read
            kernels[-1]["kernels"] = ["ln_fwd_rows_kernel",
                                      "ln_fwd_kernel (rows over 1024 groups)"]
        if name.endswith("bwd"):
            # rows in registers (a row over 512 x 2 16-byte groups or 512 x
            # 8 scalars re-read), then the column sum of the partial rows
            kernels[-1]["kernels"] = [
                "norm_bwd_rows_kernel", "norm_bwd_long_kernel (longer rows)",
                "norm_bwd_sum_kernel"]
    # the sharded decode block's kernels: launched on the tp_fused_block
    # rung only (the tp_fused rung runs decode_attention)
    tp_launches = {"tp_fused_block": tp_runs["gpt"]["tp_fused_block"][0],
                   "tp_fused": tp_runs["gpt"]["tp_fused"][0],
                   "llama_tp_fused_block":
                       tp_runs["llama"]["tp_fused_block"][0],
                   "spec_gpt_tp2_tp_fused_block":
                       spec_l["gpt_tp2_tp_fused_block"]}
    for name, line in (("ring_entry_hop", 194), ("ring_exit_hop", 263),
                       ("decode_block_attn_tp", 368)):
        paths = {path: counts[name] for path, counts in tp_launches.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/decode_block_tp.cu",
            "replaces": f"paddle_tpu/kernels/decode_block_tp.py:{line}",
            "launches": paths["tp_fused_block"],
            "launches_by_path": paths,
            **tp_recs[name]})
        if name in GEMV_BY_KERNEL:
            kernels[-1]["gemv"] = {k: gemv_rec["shapes"][k]
                                   for k in GEMV_BY_KERNEL[name]}
        if name == "decode_block_attn_tp":
            # bf16 at head_dim 64 / 128: split KV on the TMA ring; the rest
            kernels[-1]["kernels"] = [
                "attn_tp_split_kernel",
                "attn_tp_kernel (f32, and bf16 at other head_dims)"]
    serving = {"unfused": serving_u, "fused": serving_f,
               "llama_unfused": llama_serving_u,
               "llama_fused": llama_serving_f}
    for family, tp_family in tp_runs.items():
        for path, (_, res) in tp_family.items():
            serving[f"{'' if family == 'gpt' else 'llama_'}tp{TP}_{path}"] = \
                res
    log(f"[done] {time.perf_counter() - t_start:.1f} s; serving "
        f"{json.dumps(serving)}; speculative serving "
        f"{json.dumps(spec['engines'])}; fault-tolerant serving "
        f"{json.dumps(chaos)}; durable serving {json.dumps(durable)}; "
        f"fleet serving {json.dumps(fleet)}; "
        f"train {json.dumps(train)}; hybrid train {json.dumps(hybrid)}; "
        f"example train {json.dumps(example)}; "
        f"semi-auto train {json.dumps(semi)}; "
        f"moe train {json.dumps(moe_train)}; "
        f"wmt train {json.dumps(wmt)}; "
        f"llama train {json.dumps(llama_train)}; tiny serving "
        f"{json.dumps(tiny)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-ab"]:
        sys.exit(serve_ab(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-child"]:
        sys.exit(ab_child(sys.argv[2]))
    if sys.argv[1:2] == ["--durable-child"]:
        sys.exit(durable_child(*sys.argv[2:5]))
    sys.exit(main())
