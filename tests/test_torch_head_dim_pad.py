"""The attention kernels take any head_dim up to 128 by zero padding
(``kernels.head_dim``): padding q / k / v (and dO) with zero columns up to
the built head dim, with the scale of the true head dim, then slicing the
outputs back gives exactly what the true head dim gives.

On the CPU each case runs the plain version at the padded head dim and
holds it to the plain version at the true one (f32, atol 1e-5): decode
attention (one query and a causal chunk), the flash forward, dq and
dk / dv, causal or not, with GQA and with segment ids.  The card-only
case serves gpt_tiny and llama_tiny (head_dim 16) through
``ServingEngine`` on CUDA, whose kernels pad in their wrappers, and holds
their greedy tokens to the port's CPU run.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.decode_attention import (
    decode_attention_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
    flash_attention_fwd_reference)
from paddle_tpu_torch.kernels.head_dim import (KERNEL_HEAD_DIMS,
                                               kernel_head_dim, pad_head_dim)

ATOL = 1e-5


def _t(rs, *shape):
    return torch.as_tensor(rs.randn(*shape).astype(np.float32))


def _pad(*ts):
    dp = kernel_head_dim(ts[0].shape[-1])
    return [pad_head_dim(t, dp) for t in ts]


def test_kernel_head_dim_picks_the_next_built_one():
    assert [kernel_head_dim(d) for d in (8, 16, 32, 64, 80, 96, 128)] == \
        [64, 64, 64, 64, 128, 128, 128]
    assert KERNEL_HEAD_DIMS == (64, 128)
    for bad in (0, 136, 256):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_head_dim(bad)
    x = torch.ones(2, 3, 64)
    assert pad_head_dim(x, 64) is x
    y = pad_head_dim(torch.ones(2, 3, 16), 64)
    assert y.shape == (2, 3, 64) and y[..., 16:].abs().sum() == 0


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("d", [16, 32])
def test_decode_attention_padded_equals_true_head_dim(d, sq):
    rs = np.random.RandomState(d + sq)
    b, s, h, kvh = 3, 24, 4, 2
    q, k, v = _t(rs, b, sq, h, d), _t(rs, b, s, kvh, d), _t(rs, b, s, kvh, d)
    lens = torch.tensor([0, 7, 24], dtype=torch.int32)
    want = decode_attention_reference(q, k, v, lens)
    qp, kp, vp = _pad(q, k, v)
    got = decode_attention_reference(qp, kp, vp, lens,
                                     scale=1.0 / math.sqrt(d))[..., :d]
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32])
def test_flash_padded_equals_true_head_dim(d, causal, segments):
    rs = np.random.RandomState(d + 2 * causal + segments)
    b, sq, sk, h, kvh = 2, 12, 16, 4, 2
    q, k, v = _t(rs, b, sq, h, d), _t(rs, b, sk, kvh, d), _t(rs, b, sk, kvh, d)
    dout = _t(rs, b, sq, h, d)
    ids = {}
    if segments:
        ids = dict(q_segments=torch.as_tensor(
                       np.sort(rs.randint(0, 3, (b, sq))).astype(np.int32)),
                   k_segments=torch.as_tensor(
                       np.sort(rs.randint(0, 3, (b, sk))).astype(np.int32)))
    kw = dict(causal=causal, **ids)
    out, lse = flash_attention_fwd_reference(q, k, v, **kw)
    delta = (dout * out).sum(-1).transpose(1, 2)
    dq = flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               **kw)
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = _pad(q, k, v, dout)
    outp, lsep = flash_attention_fwd_reference(qp, kp, vp, scale, **kw)
    deltap = (dop * outp).sum(-1).transpose(1, 2)
    torch.testing.assert_close(outp[..., :d], out, atol=ATOL, rtol=0)
    torch.testing.assert_close(lsep, lse, atol=ATOL, rtol=0)
    torch.testing.assert_close(deltap, delta, atol=ATOL, rtol=0)
    dqp = flash_attention_bwd_dq_reference(qp, kp, vp, dop, lsep, deltap,
                                           scale, **kw)
    dkp, dvp = flash_attention_bwd_dkv_reference(qp, kp, vp, dop, lsep,
                                                 deltap, scale, **kw)
    for got, want in ((dqp, dq), (dkp, dk), (dvp, dv)):
        torch.testing.assert_close(got[..., :d], want, atol=ATOL, rtol=0)
        assert got[..., d:].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_tiny_models_serve_on_the_card_as_on_the_cpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)
    from paddle_tpu_torch.serving import ServingEngine
    cls, cfg = ((GPTForCausalLM, gpt_tiny()) if family == "gpt"
                else (LlamaForCausalLM, llama_tiny()))
    assert cfg.head_dim == 16
    cpu = cls(cfg, device="cpu").eval()
    card = cls(cfg, device="cuda").eval()
    card.load_state_dict({k: v.to("cuda") for k, v in
                          cpu.state_dict().items()})
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (9, 30, 4)]
    tokens = {}
    before = decode_attention.launches
    for name, model in (("cpu", cpu), ("cuda", card)):
        eng = ServingEngine(model, num_slots=3, min_bucket=8, block_len=16,
                            prefill_chunk=16)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_complete(200)
        tokens[name] = [eng.purge(r).tokens for r in rids]
    assert decode_attention.launches > before
    assert tokens["cuda"] == tokens["cpu"]
