"""Packed / varlen attention in the PyTorch port against the JAX package,
on the CPU, on identical numpy inputs.

The port's ``flash_attention_varlen`` (segment ids through the flash
decomposition: on CPU tensors the plain versions of the fwd / dq / dkv
kernels) and ``flash_attention_with_lse`` are held to the reference's
Pallas kernels in interpret mode; ``flash_attn_unpadded`` and functional
``flash_attention`` to the reference's functionals, which take their
dense forms on the CPU, as the port's do.  Float32 throughout; atol 1e-5
(the two frameworks sum in different orders; values and gradients are
O(1)).  Rows that see no key give out 0 and zero gradients in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention_varlen as jax_varlen
from paddle_tpu.kernels import flash_attention_with_lse as jax_with_lse
from paddle_tpu.nn.functional.attention import \
    flash_attention as jax_functional_flash
from paddle_tpu.nn.functional.attention import \
    flash_attn_unpadded as jax_unpadded
from paddle_tpu_torch.kernels import (flash_attention_varlen,
                                      flash_attention_with_lse)
from paddle_tpu_torch.nn.functional import flash_attention, \
    flash_attn_unpadded
from paddle_tpu_torch.nn.functional.attention import _segment_ids

ATOL = 1e-5
B, S, H, KVH, D = 2, 96, 4, 2, 64


def _docs(lengths, pad_id=None, total=S):
    """Ids 0, 1, ... for consecutive documents of ``lengths``, then
    ``pad_id`` up to ``total``."""
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
    return np.concatenate([ids, np.full(total - ids.size, pad_id)])


def _ids(pattern):
    """(q ids, k ids), int32 [B, S]."""
    if pattern == "packed_padding":
        # row 0: three packed documents; row 1: two, then padding whose
        # query ids (-1) match no key id (-2): those rows see no key
        q = np.stack([_docs([30, 50, 16]), _docs([40, 33], -1)])
        k = np.stack([_docs([30, 50, 16]), _docs([40, 33], -2)])
    else:
        # row 0: ids in no order; row 1: the second query segment has no
        # keys (its rows see none) and the last key segment no queries
        q0 = np.random.RandomState(5).randint(0, 3, S)
        q = np.stack([q0, _docs([48, 48])])
        k = np.stack([q0, _docs([60, 36]) * 2])
    return q.astype(np.int32), k.astype(np.int32)


def _qkvw(seed, h=H, kvh=KVH):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, h, D).astype(np.float32),
            rs.randn(B, S, kvh, D).astype(np.float32),
            rs.randn(B, S, kvh, D).astype(np.float32),
            rs.randn(B, S, h, D).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pattern", ["packed_padding", "nonmonotone_nokeys"])
def test_varlen_out_and_grads_match_pallas_interpret(pattern, causal):
    """Out and q/k/v gradients of ``sum(out * w)``, GQA (4 query heads
    over 2 kv heads), against ``jax.grad`` of the reference's
    ``flash_attention_varlen(interpret=True)``; rows that see no key give
    out 0 and dq 0, keys no query sees dk = dv = 0."""
    qs, ks = _ids(pattern)
    q, k, v, w = _qkvw(11)

    def jloss(q, k, v):
        out = jax_varlen(q, k, v, qs, ks, causal=causal, interpret=True)
        return jnp.sum(out * w), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention_varlen(tq, tk, tv, qs, ks, causal=causal)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for t, jg, name in zip((tq, tk, tv), jgrads, "qkv"):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, err_msg=f"d{name}")

    seen = qs[:, :, None] == ks[:, None, :]
    if causal:
        seen &= np.tril(np.ones((S, S), bool))[None]
    blind_rows, blind_keys = ~seen.any(2), ~seen.any(1)
    assert blind_rows.any() and blind_keys.any()
    assert np.all(out.detach().numpy()[blind_rows] == 0.0)
    assert np.all(tq.grad.numpy()[blind_rows] == 0.0)
    assert np.all(tk.grad.numpy()[blind_keys] == 0.0)
    assert np.all(tv.grad.numpy()[blind_keys] == 0.0)


def test_with_lse_matches_pallas_interpret():
    """``flash_attention_with_lse``: out and lse [B, H, S], causal GQA."""
    q, k, v, _ = _qkvw(3)
    jout, jlse = jax_with_lse(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=True, interpret=True)
    out, lse = flash_attention_with_lse(
        *(torch.as_tensor(x) for x in (q, k, v)), causal=True)
    assert lse.shape == (B, H, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL)


# (cu_seqlens_q, cu_seqlens_k, causal): aligned causal packs, non-causal
# cross packs (q and k cut differently, the last key sequence unseen),
# causal packs that differ (per-sequence causal: the dense route)
UNPADDED = {"aligned_causal": ([0, 40, 75, 100], [0, 40, 75, 100], True),
            "cross_noncausal": ([0, 40, 100], [0, 30, 70, 90], False),
            "unaligned_causal": ([0, 40, 100], [0, 60, 100], True)}


@pytest.mark.parametrize("case", sorted(UNPADDED))
def test_unpadded_matches_jax(case):
    cu_q, cu_k, causal = UNPADDED[case]
    rs = np.random.RandomState(4)
    q = rs.randn(cu_q[-1], H, D).astype(np.float32)
    k = rs.randn(cu_k[-1], H, D).astype(np.float32)
    v = rs.randn(cu_k[-1], H, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    want, _ = jax_unpadded(*(jnp.asarray(x) for x in (q, k, v)),
                           jnp.asarray(cu_q, jnp.int32),
                           jnp.asarray(cu_k, jnp.int32), 60, 60, scale,
                           causal=causal)
    before = flash_attn_unpadded.dense_calls
    got, soft = flash_attn_unpadded(
        *(torch.as_tensor(x) for x in (q, k, v)), torch.tensor(cu_q),
        torch.tensor(cu_k), 60, 60, scale, causal=causal)
    assert soft is None
    # the CPU always takes the dense form, as the reference does there
    assert flash_attn_unpadded.dense_calls == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if case != "unaligned_causal":
        # what the CUDA route computes for this call: the segment-id
        # kernels' decomposition (here their plain versions) on the
        # packs as one row
        seg_q = _segment_ids(torch.tensor(cu_q), cu_q[-1])
        seg_k = _segment_ids(torch.tensor(cu_k), cu_k[-1])
        kern = flash_attention_varlen(
            *(torch.as_tensor(x)[None] for x in (q, k, v)), seg_q[None],
            seg_k[None], causal=causal, scale=scale)[0]
        np.testing.assert_allclose(kern.numpy(), np.asarray(want),
                                   atol=ATOL)


def test_segment_ids_drop_out_of_range_boundaries():
    """A zero-length sequence repeats a boundary (its id is skipped) and a
    trailing one puts a boundary at ``total`` (dropped), as the
    reference's scatter-add does."""
    got = _segment_ids(torch.tensor([0, 3, 3, 7, 10, 10]), 10)
    np.testing.assert_array_equal(got.numpy(),
                                  [0, 0, 0, 2, 2, 2, 2, 3, 3, 3])
    assert got.dtype == torch.int32


def test_unpadded_raises_on_dropout():
    x = torch.zeros(8, H, D)
    cu = torch.tensor([0, 8])
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attn_unpadded(x, x, x, cu, cu, 8, 8, 0.125, dropout=0.1)


@pytest.mark.parametrize("causal", [True, False])
def test_functional_flash_attention_matches_jax(causal):
    q, k, v, _ = _qkvw(6, kvh=H)
    jout, jsoft = jax_functional_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                       causal=causal)
    out, soft = flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                causal=causal)
    assert jsoft is None and soft is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


def test_segment_ids_are_checked():
    """The kernel wrappers take contiguous int32 [B, S] ids on q's device,
    both or neither."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    q, k, v, _ = (torch.as_tensor(x) for x in _qkvw(0))
    ids = torch.zeros(B, S, dtype=torch.int32)
    flash_attention_fwd(q, k, v, q_segments=ids, k_segments=ids)
    for bad in (ids.long(), ids[:, :-1], torch.zeros(S, B,
                                                     dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="segments"):
            flash_attention_fwd(q, k, v, q_segments=bad, k_segments=ids)
    with pytest.raises(ValueError, match="both"):
        flash_attention_fwd(q, k, v, q_segments=ids)


@pytest.mark.cuda
def test_segment_kernels_match_plain_versions_on_the_card():
    """On a card: the three kernels with segment ids against their plain
    versions, causal and not, f32 and bf16, GQA, padding ids and ids in
    no order.  Max abs error over max(1, max |plain|): f32 1e-5
    (summation order), bf16 2e-2 (the output cast and the 16-bit P and dS
    of the second products)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.kernels import flash_attention as fa
    for pattern in ("packed_padding", "nonmonotone_nokeys"):
        qs, ks = (torch.as_tensor(x).cuda() for x in _ids(pattern))
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for causal in (True, False):
                q, k, v, g = (torch.as_tensor(x).to("cuda", dtype)
                              for x in _qkvw(1))
                kw = dict(causal=causal, q_segments=qs, k_segments=ks)
                out, lse = fa.flash_attention_fwd(q, k, v, **kw)
                ro, rl = fa.flash_attention_fwd_reference(q, k, v, **kw)
                delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
                got = (out, fa.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                      **kw),
                       *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                   **kw))
                want = (ro, fa.flash_attention_bwd_dq_reference(
                    q, k, v, g, lse, delta, **kw),
                    *fa.flash_attention_bwd_dkv_reference(
                        q, k, v, g, lse, delta, **kw))
                torch.cuda.synchronize()
                assert torch.equal(torch.isinf(lse), torch.isinf(rl))
                for a, b_ in zip(got, want):
                    scale = max(1.0, b_.float().abs().max().item())
                    err = (a.float() - b_.float()).abs().max().item()
                    assert err <= rel * scale, (pattern, dtype, causal, err)
