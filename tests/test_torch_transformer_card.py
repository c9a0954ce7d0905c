"""The Transformer path's flash calls on the card (``-m cuda``; no JAX
import).

The flash kernels against their plain versions at the shapes the
encoder-decoder gives them and no earlier path did: one query row
against 1 to 512 keys (cached decoding's self-attention step), and
cross-attention with more or fewer keys than queries, head_dim 64,
bf16, non-causal (forward, dq and dk / dv; each within 2e-2 of
max(1, max |plain|), the bf16 limit of the earlier flash checks).  Then
one ``MultiHeadAttention(512, 8)`` call at the WMT shape ``[32, 512]``
through both routes: unmasked (the flash kernels, one launch of each)
against an all-keep mask (the dense form), the output and the q / k / v
/ out-projection weight gradients within 2e-2 of max(1, max |dense|).
"""

import pytest
import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F

pytestmark = pytest.mark.cuda

REL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within(got, want, what):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * scale, f"{what}: max |diff| {err} (scale {scale})"


@pytest.mark.parametrize("b,sq,sk", [(32, 1, 1), (32, 1, 7), (32, 1, 129),
                                     (32, 1, 512), (4, 512, 300),
                                     (4, 300, 512), (2, 77, 200)])
def test_flash_kernels_at_the_encoder_decoder_shapes(card, b, sq, sk):
    g = torch.Generator(device=card).manual_seed(sq * 1000 + sk)

    def r(*shape):
        return torch.randn(shape, generator=g, device=card).bfloat16()
    q, k, v, do = r(b, sq, 8, 64), r(b, sk, 8, 64), r(b, sk, 8, 64), \
        r(b, sq, 8, 64)
    out, lse = fa.flash_attention_fwd(q, k, v)
    ro, rl = fa.flash_attention_fwd_reference(q, k, v)
    _within(out, ro, "out")
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    _within(dq, fa.flash_attention_bwd_dq_reference(q, k, v, do, lse,
                                                    delta), "dq")
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    _within(dk, rdk, "dk")
    _within(dv, rdv, "dv")


def test_full_width_mha_through_both_routes(card):
    gen = torch.Generator(device=card).manual_seed(24)
    mha = nn.MultiHeadAttention(512, 8, dtype=torch.bfloat16, generator=gen)
    x = torch.randn(32, 512, 512, generator=gen, device=card).bfloat16()
    gy = torch.randn(32, 512, 512, generator=gen, device=card).bfloat16()
    names = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
             "out_proj.weight")
    params = dict(mha.named_parameters())

    def run(mask):
        out = mha(x, attn_mask=mask)
        grads = torch.autograd.grad(out, [params[n] for n in names], gy)
        return out, grads
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    for k in kernels:
        k.launches = 0
    F.scaled_dot_product_attention.dense_calls = 0
    flash_out, flash_grads = run(None)
    assert [k.launches for k in kernels] == [1, 1, 1]
    assert F.scaled_dot_product_attention.dense_calls == 0
    dense_out, dense_grads = run(torch.ones(32, 1, 1, 512, dtype=torch.bool,
                                            device=card))
    assert [k.launches for k in kernels] == [1, 1, 1]
    assert F.scaled_dot_product_attention.dense_calls == 1
    _within(flash_out, dense_out, "out")
    for n, got, want in zip(names, flash_grads, dense_grads):
        _within(got, want, n)
