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
     shapes beside its plain version, one PyTorch library call computing
     the same function (timed only as a yardstick) and its bound;
  3. serving — ``ServingEngine`` over ``GPTForCausalLM(gpt3_6_7b())`` at
     full width (random bf16 weights drawn on the card from a seeded
     generator): 8 requests, prefix-cache hits, chunked prefill, greedy
     and seeded sampling.  Kernel launch counts are zeroed just before
     and read just after, and must cover every layer of every prefill
     chunk and decode step;
  4. parity — an f32 model of gpt_small width at 2 layers: the engine's
     greedy tokens equal ``generate``'s for 3 requests.

The last lines are a JSON object describing every kernel, the card's
``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bandwidth and bf16 tensor rate;
# f32 work outside the tensor cores peaks at 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back
    calls, by CUDA events after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernels(card: str):
    """Hold the kernel against its plain version over the sweep, then
    time it at the serving path's two shapes.  Returns the kernel's
    record (without launches) and the max abs error at those shapes."""
    import torch
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # f32: only the summation order differs; 16-bit: the output cast and
    # (tensor-core path) the 16-bit P of the P V product
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
           torch.float16: dict(atol=2e-2, rtol=2e-2)}
    worst = {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (64, 128):
            for rep in (1, 4):
                for sq in (1, 7, 48, 512):
                    b, h, s_max = 4, 8, 1024
                    q = rand((b, sq, h, d), dtype)
                    k = rand((b, s_max, h // rep, d), dtype)
                    v = rand((b, s_max, h // rep, d), dtype)
                    # ragged: 1, S_max, past S_max, and shorter than sq
                    lens = torch.tensor([1, s_max, s_max + 37,
                                         max(sq - 3, 0)],
                                        dtype=torch.int32, device=dev)
                    for causal in (True, False):
                        out = decode_attention(q, k, v, lens,
                                               causal_tail=causal)
                        torch.cuda.synchronize()
                        ref = decode_attention_reference(
                            q, k, v, lens, causal_tail=causal)
                        err = (out.float() - ref.float()).abs().max().item()
                        key = str(dtype).replace("torch.", "")
                        worst[key] = max(worst.get(key, 0.0), err)
                        if not torch.allclose(out.float(), ref.float(),
                                              **tol[dtype]):
                            raise AssertionError(
                                f"decode_attention disagrees with its plain "
                                f"version: dtype={dtype} D={d} rep={rep} "
                                f"sq={sq} causal={causal} max_abs_err={err}")
                        cases += 1
    log(f"[kernels] decode_attention sweep: {cases} cases within "
        f"tolerance (f32 atol 1e-4; bf16/f16 atol/rtol 2e-2); max abs err "
        f"{json.dumps(worst)}")

    # the serving path's shapes at gpt3_6_7b width (bf16): a decode step
    # over 8 slots of a 2048-row cache filled to 1024, and a 512-wide
    # prefill chunk whose last query sits at row 1536
    shapes = {
        "decode": ((8, 1, 32, 128), (8, 2048, 32, 128), [1024] * 8),
        "prefill": ((1, 512, 32, 128), (1, 2048, 32, 128), [1536]),
    }
    rec = {}
    err_main = 0.0
    for name, (qs, ks, lens) in shapes.items():
        q = rand(qs, torch.bfloat16)
        k = rand(ks, torch.bfloat16)
        v = rand(ks, torch.bfloat16)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, seq_lens)
        ref = decode_attention_reference(q, k, v, seq_lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(),
                              **tol[torch.bfloat16]):
            raise AssertionError(f"decode_attention disagrees at the {name} "
                                 f"shape: max_abs_err={err}")
        err_main = max(err_main, err)
        bound, bound_by = attention_bound(q, k, seq_lens)
        ms = time_ms(lambda: decode_attention(q, k, v, seq_lens))
        plain_ms = time_ms(lambda: decode_attention_reference(q, k, v,
                                                              seq_lens))
        lib = sdpa_call(q, k, v, seq_lens)
        library_ms = time_ms(lib)
        rec[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "max_abs_err": err,
                     "q": list(qs), "kv": list(ks), "seq_lens": lens[:1]}
        log(f"[kernels] decode_attention {name} q{list(qs)} kv{list(ks)} "
            f"seq_len {lens[0]} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}); max abs err {err:.3g} "
            f"(card: {card})")
    return rec, err_main


# -------------------------------------------------------------- serving
def phase_serving(card: str):
    """Serve 8 requests through the port's ServingEngine at gpt3_6_7b
    width; returns the kernel launch count of the run and the metrics."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_6_7b
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine

    cfg = gpt3_6_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, generator=gen).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serving] gpt3_6_7b: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads x {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, max_seq {cfg.max_seq_len}, bf16, "
        f"{n_params / 1e9:.3f}B params, built on the card in "
        f"{time.perf_counter() - t0:.1f} s (full depth, no cut)")
    eng = ServingEngine(model, num_slots=8, min_bucket=16, block_len=16,
                        prefill_chunk=512)

    rs = np.random.RandomState(7)
    prefix = rs.randint(0, cfg.vocab_size, (512,))

    def prompt(n, shared):
        own = rs.randint(0, cfg.vocab_size, (n - 512 if shared else n,))
        return np.concatenate([prefix, own]) if shared else own

    # (length, shares the 512-token prefix, seed or None for greedy)
    wave1 = [(1536, True, None), (128, False, None), (700, False, 11),
             (300, False, None)]
    wave2 = [(1024, True, None), (900, True, 23), (640, True, None),
             (1200, False, None)]
    ids = {}
    step_ms = []

    def submit(wave):
        for n, shared, seed in wave:
            sp = SamplingParams() if seed is None else SamplingParams(
                do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                seed=seed)
            rid = eng.submit(prompt(n, shared), max_new_tokens=32,
                             sampling=sp)
            ids[rid] = (n, shared, seed)

    def step():
        core = eng.core
        decode_only = not core._prefills and not core.scheduler.waiting
        t = time.perf_counter()
        left = eng.step()
        if decode_only:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return left

    torch.cuda.synchronize()
    decode_attention.launches = 0
    t_run = time.perf_counter()
    submit(wave1)
    # the second wave arrives once the first prefix holder has its first
    # token, so its prefix blocks are in the radix cache
    holder = next(iter(ids))
    while not eng.result(holder).tokens:
        step()
    submit(wave2)
    while step():
        pass
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = decode_attention.launches

    m = eng.metrics_dict()
    reg = eng.registry
    decode_steps = reg.get("serving.phase.decode_dispatch_s").count
    chunks = m["prefill_chunks"]
    want = cfg.num_layers * (chunks + decode_steps)
    log(f"[serving] {len(ids)} requests, {chunks} prefill chunks, "
        f"{decode_steps} decode steps, {m['steps']} engine steps in "
        f"{run_s:.2f} s; decode_attention launches {launches} (want "
        f"{cfg.num_layers} layers x ({chunks} + {decode_steps}) = {want})")
    if launches != want:
        raise AssertionError(f"decode_attention launches {launches} != "
                             f"{want}: the main path bypassed the kernel")
    for rid, (n, shared, seed) in ids.items():
        out = eng.result(rid)
        if not (out.finished and out.status == "finished"
                and len(out.tokens) == 32):
            raise AssertionError(f"request {rid} (len {n}) did not finish "
                                 f"with 32 tokens: {out}")
        if not all(0 <= t < cfg.vocab_size for t in out.tokens):
            raise AssertionError(f"request {rid} emitted an out-of-vocab "
                                 f"token: {out.tokens}")
        log(f"[serving] request {rid}: prompt {n}"
            f"{' (shared prefix)' if shared else ''}, "
            f"{'seed ' + str(seed) if seed is not None else 'greedy'}, "
            f"prefix hit {out.prefix_hit_tokens}, ttft "
            f"{out.ttft_s * 1e3:.1f} ms, first tokens {out.tokens[:6]}")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("no prefix-cache hit in the serving run")
    decode_ms = float(np.median(step_ms)) if step_ms else None
    res = {"requests": len(ids), "prefill_chunks": chunks,
           "decode_steps": decode_steps, "steps": m["steps"],
           "run_s": run_s, "tokens_generated": m["tokens_generated"],
           "tokens_per_s": m["tokens_generated"] / run_s,
           "ttft_p50_ms": m["ttft_p50_ms"],
           "decode_step_ms_p50": decode_ms,
           "decode_only_steps": len(step_ms),
           "prefix_hit_tokens": m["prefix_hit_tokens"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[serving] {res['tokens_per_s']:.1f} tokens/s over the run, TTFT "
        f"p50 {m['ttft_p50_ms']} ms, decode step p50 "
        f"{decode_ms if decode_ms is None else round(decode_ms, 3)} ms "
        f"({len(step_ms)} decode-only steps), prefix hit tokens "
        f"{m['prefix_hit_tokens']}, peak memory {res['peak_mem_gb']:.1f} GB "
        f"(card: {card})")
    res["decode_profile"] = profile_decode(eng, cfg.vocab_size, card)
    eng.close()
    del eng, model
    torch.cuda.empty_cache()
    return launches, res


def profile_decode(eng, vocab: int, card: str, steps: int = 5) -> dict:
    """Where a full-batch decode step's time goes, after the main run:
    fill all 8 slots with short greedy requests, then trace ``steps``
    decode-only steps with torch.profiler.  Reports the wall time per
    step, the device busy share (summed kernel time over wall time; one
    stream, so kernels do not overlap) and the kernels that take the
    most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(11)
    rids = [eng.submit(rs.randint(0, vocab, (64,)), max_new_tokens=steps + 4)
            for _ in range(eng.core.num_slots)]
    while eng.core._prefills or eng.core.scheduler.waiting:
        eng.step()
    torch.cuda.synchronize()
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
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": busy_ms / steps,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top_kernels_ms_per_step": {k[:90]: v / steps for k, v in top}}
    if busy_ms == 0.0:
        log("[profile] the profiler saw no device time: device busy share "
            "not measured")
    else:
        log(f"[profile] decode step, 8 slots busy, under torch.profiler: "
            f"{out['wall_ms_per_step']:.3f} ms wall, "
            f"{out['device_ms_per_step']:.3f} ms of kernels, device busy "
            f"share {out['busy_share']:.3f} (card: {card})")
        for name, ms in out["top_kernels_ms_per_step"].items():
            log(f"[profile]   {ms:8.4f} ms/step  {name}")
    return out


# --------------------------------------------------------------- parity
def phase_parity() -> None:
    """Engine greedy tokens == the port's generate tokens on an f32 model
    of gpt_small width, 2 layers (TF32 off)."""
    import dataclasses

    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(gpt_small(), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    model = GPTForCausalLM(cfg, dtype="float32", generator=gen).eval()
    eng = ServingEngine(model, num_slots=3, min_bucket=16, block_len=16,
                        prefill_chunk=64)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (40, 150, 300)]
    outs = eng.serve_batch(prompts, max_new_tokens=16)
    for p, o in zip(prompts, outs):
        want = model.generate(p[None], max_new_tokens=16)[0, len(p):]
        want = want.cpu().tolist()
        if o.tokens != want:
            raise AssertionError(f"engine tokens {o.tokens} != generate "
                                 f"tokens {want} (prompt len {len(p)})")
    log(f"[parity] gpt_small width, 2 layers, f32: engine greedy tokens == "
        f"generate tokens for {len(prompts)} requests (prompt lengths "
        f"{[len(p) for p in prompts]}, 16 new tokens each)")
    eng.close()


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

    rec, err = phase_kernels(card)
    launches, serving = phase_serving(card)
    phase_parity()

    d = rec["decode"]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/kernels/decode_attention.py:42",
        "launches": launches,
        "max_abs_err": err,
        "ms": d["ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"],
        "shape": "decode q[8,1,32,128] kv[8,2048,32,128] seq_len 1024 bf16",
        "prefill": rec["prefill"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s; serving "
        f"{json.dumps(serving)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
