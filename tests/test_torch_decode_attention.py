"""Decode attention in the PyTorch port (paddle_tpu_torch/kernels/
decode_attention.py) against the JAX reference on the CPU.

The port's plain version is held against the JAX Pallas kernel (run in
interpret mode, as the JAX package's own tests run it on the CPU) and
against the JAX dense reference, on identical numpy inputs, at
atol/rtol 1e-5 in float32 — the only difference is summation order.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there; the last test below does the same
under pytest on a machine with a card, and skips without one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference as jax_reference)
from paddle_tpu_torch.kernels.decode_attention import (
    decode_attention, decode_attention_auto, decode_attention_reference)

B, H, S_MAX, D = 4, 4, 32, 16


def _inputs(sq, rep, seed=0, d=D, s_max=S_MAX):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, sq, H, d).astype(np.float32)
    k = rs.randn(B, s_max, H // rep, d).astype(np.float32)
    v = rs.randn(B, s_max, H // rep, d).astype(np.float32)
    # ragged: one row shorter than the chunk, one full, one past S_max
    lens = np.array([max(sq - 1, 0), s_max, s_max + 5, 17], np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("sq", [1, 3, 8, 24])
def test_plain_version_matches_jax(sq, rep):
    q, k, v, lens = _inputs(sq, rep)
    for causal in (True, False):
        got = decode_attention_reference(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(lens), causal_tail=causal).numpy()
        want_kernel = np.asarray(jax_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), causal_tail=causal, interpret=True))
        want_dense = np.asarray(jax_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens), causal_tail=causal))
        np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, want_dense, atol=1e-5, rtol=1e-5)


def test_masked_rows_give_zero():
    """A query that sees no key (seq_len < sq under the causal tail)
    yields exactly 0, like the reference."""
    q, k, v, lens = _inputs(8, 1)
    lens[:] = 2                         # queries 0..5 see nothing
    out = decode_attention_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lens)).numpy()
    assert np.all(out[:, :6] == 0.0)
    assert np.all(np.isfinite(out)) and np.any(out[:, 6:] != 0.0)


def test_auto_dispatch_on_cpu_and_wrapper_contract():
    q, k, v, lens = _inputs(3, 2)
    args = [torch.as_tensor(x) for x in (q, k, v, lens)]
    before = decode_attention.launches
    np.testing.assert_array_equal(decode_attention_auto(*args).numpy(),
                                  decode_attention_reference(*args).numpy())
    assert decode_attention.launches == before
    # the kernel wrapper takes CUDA tensors only: no silent CPU path
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(*args)
    with pytest.raises(ValueError, match="seq_lens"):
        decode_attention_reference(*args[:3], args[3][:2])


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import chip_smoke
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0)),
                       (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
                       (torch.float16, dict(atol=2e-2, rtol=2e-2))):
        for d in (64, 128):
            for sq in (1, 7, 48, 64, 65):
                # 600 rows: three 256-row splits of the sq == 1 kernel,
                # five 128-key tiles of the chunk kernel
                q, k, v, lens = _inputs(sq, 2, d=d, s_max=600)
                args = [torch.as_tensor(x).cuda() for x in (q, k, v)]
                args = [a.to(dtype) for a in args]
                seq = torch.as_tensor(lens).cuda()
                before = decode_attention.launches
                out = decode_attention(*args, seq)
                assert decode_attention.launches == before + 1
                ref = decode_attention_reference(*args, seq)
                torch.testing.assert_close(out.float(), ref.float(), **tol)
                if dtype != torch.float32:
                    # each element within its own limit, as chip_smoke
                    # holds the kernel at the serving shapes
                    assert chip_smoke.row_reading(out, ref) <= 1.0, (dtype,
                                                                    d, sq)


@pytest.mark.cuda
def test_kernels_launch_on_every_device():
    """Both 16-bit regimes (the split walk at sq == 1, the wgmma chunk
    kernel; each takes more than 48 KB of dynamic shared memory, an
    attribute held per device) on every visible card, as the tp=2 engine
    calls them once per shard device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import chip_smoke
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        for sq in (1, 64):
            q, k, v, lens = _inputs(sq, 2, d=128, s_max=600)
            args = [torch.as_tensor(x).to(dev, torch.bfloat16)
                    for x in (q, k, v)]
            seq = torch.as_tensor(lens).to(dev)
            out = decode_attention(*args, seq)
            ref = decode_attention_reference(*args, seq)
            assert out.device == dev
            assert chip_smoke.row_reading(out, ref) <= 1.0, (i, sq)


def test_split_workspace_is_reused_and_grown():
    """The sq == 1 kernel's workspace is kept per (device, stream): a call
    that fits reuses it (its counters stay as the kernel left them, 0),
    a larger call grows both buffers with fresh zero counters."""
    from paddle_tpu_torch.kernels import decode_attention as da
    dev, stream = torch.device("cpu"), 12345
    try:
        part, count = da._workspace(dev, stream, 100, 8)
        assert part.numel() == 100 and torch.equal(count, torch.zeros(8,
                                                   dtype=torch.int32))
        assert da._workspace(dev, stream, 60, 4)[0] is part
        assert da._workspace(dev, stream + 1, 60, 4)[0] is not part
        bigger, counts = da._workspace(dev, stream, 50, 16)
        assert bigger.numel() == 100 and counts.numel() == 16
        assert not counts.any()
    finally:
        da._workspaces.pop((None, stream), None)
        da._workspaces.pop((None, stream + 1), None)
