"""The port's Transformer path (``paddle_tpu_torch/nn``: the functionals,
``MultiHeadAttention``, the encoder / decoder layers and stacks,
``Transformer``, ``CrossEntropyLoss``) against the JAX package on the CPU,
in f32, on inputs made from numpy seeds and weights carried key for key
(``models.layer_state_from_jax``).

The size: d_model 32, 4 heads, 2 + 2 layers, ffn 64, vocab 64, batch 2
with sources of 8 and targets of 6 tokens; every dropout 0 (the JAX side
draws from its global key, the port from explicit generators), so the
cross-package checks run the same function.  Limits: outputs and
gradients within 1e-5 of the reference's largest magnitude, losses rtol
1e-5; ``FusedAdamW`` (Pallas in interpret mode on the JAX side) f32 state
rtol 1e-6, bf16 parameters one ulp.  Dropout's own statistics, the
route ``scaled_dot_product_attention`` takes and the repaired ``Linear``
are checked within the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.functional_call import functional_call, state
from paddle_tpu.optimizer import FusedAdamW as JaxFusedAdamW
from paddle_tpu.optimizer.lr import NoamDecay as JaxNoamDecay
from paddle_tpu_torch import nn
from paddle_tpu_torch.kernels import fused_adamw as fw
from paddle_tpu_torch.models import layer_state_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import FusedAdamW
from paddle_tpu_torch.optimizer.lr import NoamDecay

D, H, FFN, V, LAYERS = 32, 4, 64, 64, 2
B, SS, ST = 2, 8, 6
PAD = 0
REL = 1e-5


def _close(got, want, rel=REL):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max |diff| {err} > {tol}"


def _port(jlayer, cls, *args, **kw):
    """The port's ``cls(*args, **kw)`` on the CPU with ``jlayer``'s
    weights."""
    m = cls(*args, device="cpu", **kw)
    arrays = {k: np.asarray(v) for k, v in state(jlayer)[0].items()}
    m.load_state_dict(layer_state_from_jax(arrays, m))
    return m


def _t(x):
    return torch.as_tensor(np.array(x))


def _masks(rs):
    """A bool key-padding mask ``[B, 1, 1, SS]`` (source lengths 8 and
    5), the causal target mask and the padded ids / labels."""
    lens = np.array([SS, 5])
    keep = np.arange(SS)[None, :] < lens[:, None]
    src = np.where(keep, rs.randint(1, V, (B, SS)), PAD)
    tgt = rs.randint(1, V, (B, ST + 1))
    tgt[1, 4:] = PAD
    return keep[:, None, None, :], src, tgt


class WMTRow(torch.nn.Module):
    """The repo's WMT profile row's structure: a shared embedding, the
    Transformer and a head, under the JAX ``Sequential``'s names."""

    def __init__(self, device, dtype=torch.float32):
        super().__init__()
        self.emb = nn.Embedding(V, D, device=device, dtype=dtype)
        self.tr = nn.Transformer(D, H, LAYERS, LAYERS, FFN, dropout=0.0,
                                 device=device, dtype=dtype)
        self.head = nn.Linear(D, V, device=device, dtype=dtype)

    def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
        out = self.tr(self.emb(src), self.emb(tgt), src_mask, tgt_mask,
                      memory_mask)
        return self.head(out)


def _build_row():
    """The JAX row (seed 24), its parameters and buffers, and the
    batch."""
    paddle_tpu.seed(24)
    big = jnn.Sequential()
    big.add_sublayer("emb", jnn.Embedding(V, D))
    big.add_sublayer("tr", jnn.Transformer(D, H, LAYERS, LAYERS, FFN,
                                           dropout=0.0))
    big.add_sublayer("head", jnn.Linear(D, V))
    params, buffers = state(big)
    rs = np.random.RandomState(24)
    keep, src, tgt = _masks(rs)
    return big, params, buffers, keep, src, tgt


def _jax_loss(big, buffers, keep, src, tgt):
    tr = big._sub_layers["tr"]
    tmask = jnn.Transformer.generate_square_subsequent_mask(ST)

    def loss(p):
        emb = p["emb.weight"]
        out, _ = functional_call(
            tr, {k[3:]: v for k, v in p.items() if k.startswith("tr.")},
            buffers, (jnp.take(emb, src, axis=0),
                      jnp.take(emb, tgt[:, :-1], axis=0),
                      jnp.asarray(keep), tmask, jnp.asarray(keep)),
            train=True)
        logits = out @ p["head.weight"] + p["head.bias"]
        return jF.cross_entropy(logits, jnp.asarray(tgt[:, 1:]),
                                ignore_index=PAD, label_smoothing=0.1), logits
    return loss


def _port_row(params, dtype=torch.float32):
    m = WMTRow("cpu", dtype)
    m.load_state_dict(layer_state_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, m))
    return m


MASK_CASES = [(kind, shape) for kind in ("bool", "additive")
              for shape in ((5, 7), (H, 5, 7), (B, 1, 5, 7), (B, H, 5, 7))]


def _mask_case(kind, shape):
    rs = np.random.RandomState(len(shape) + (kind == "bool"))
    qkv = [rs.randn(B, sq, H, 8).astype(np.float32) for sq in (5, 7, 7)]
    keep = rs.rand(*shape) > 0.3
    keep[..., 2, :] = False
    mask = keep if kind == "bool" else np.where(
        keep, rs.randn(*shape), np.finfo(np.float32).min).astype(np.float32)
    return qkv + [mask]


MHA_CASES = ("self", "cross", "cache", "static_cache")


def _build_mha():
    """A JAX ``MultiHeadAttention`` (seed 5), its inputs and the function
    of its parameters to its outputs: self-attention under a 3-D bool
    mask, cross-attention under a 4-D key-padding mask, self-attention
    under the causal mask (what the incremental cache computes step by
    step) and unmasked cross attention (what a ``StaticCache`` of the
    memory computes)."""
    paddle_tpu.seed(5)
    jm = jnn.MultiHeadAttention(D, H)
    rs = np.random.RandomState(5)
    x = rs.randn(B, 5, D).astype(np.float32)
    mem = rs.randn(B, 7, D).astype(np.float32)
    self_mask = rs.rand(B, 5, 5) > 0.3
    cross_mask = rs.rand(B, 1, 1, 7) > 0.3
    causal = jnn.Transformer.generate_square_subsequent_mask(5)
    params, buffers = state(jm)

    def run(p):
        def call(*a):
            return functional_call(jm, p, buffers, a, train=False)[0]
        return {"self": call(x, x, x, self_mask),
                "cross": call(x, mem, mem, cross_mask),
                "cache": call(x, x, x, causal),
                "static_cache": call(x, mem, mem)}
    return (jm, x, mem, self_mask, cross_mask), params, run


def _build_layers():
    """Both ``normalize_before`` forms of a JAX encoder layer (gelu in
    the pre-norm form) and decoder layer (seed 7), the inputs, and the
    function of their parameters to their outputs."""
    paddle_tpu.seed(7)
    built = {}
    for nb in (False, True):
        act = "gelu" if nb else "relu"
        built[nb] = (
            jnn.TransformerEncoderLayer(D, H, FFN, dropout=0.0,
                                        activation=act, normalize_before=nb),
            jnn.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                        normalize_before=nb))
    rs = np.random.RandomState(7)
    keep, _, _ = _masks(rs)
    src = rs.randn(B, SS, D).astype(np.float32)
    tgt = rs.randn(B, ST, D).astype(np.float32)
    causal = jnn.Transformer.generate_square_subsequent_mask(ST)
    params = {nb: (state(e)[0], state(d)[0]) for nb, (e, d) in built.items()}

    def run(params):
        out = {}
        for nb, (e, d) in built.items():
            pe, pd = params[nb]
            out[nb] = (functional_call(e, pe, {}, (src, keep),
                                       train=False)[0],
                       functional_call(d, pd, {}, (tgt, src, causal, keep),
                                       train=False)[0])
        return out
    return (built, keep, src, tgt, np.asarray(causal)), params, run


CE_CASES = {
    "mean": dict(),
    "ignore_weight_mean": dict(ignore_index=3, weight=True),
    "ignore_smooth_sum": dict(ignore_index=3, label_smoothing=0.1,
                              reduction="sum"),
    "weight_smooth_none_col": dict(weight=True, label_smoothing=0.2,
                                   reduction="none", col=True),
    "soft_mean": dict(soft_label=True),
    "soft_smooth_none": dict(soft_label=True, label_smoothing=0.1,
                             reduction="none"),
}


def _ce_case(case):
    """``(x, label, weight or None, cross_entropy keywords)``: hard labels
    with the ignored id 3 in the first row (a size-1 last dim with
    ``col``), or soft labels summing to 1."""
    kw = dict(CE_CASES[case])
    rs = np.random.RandomState(len(case))
    x = rs.randn(6, 7, 5).astype(np.float32)
    if kw.get("soft_label"):
        label = rs.rand(6, 7, 5).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rs.randint(0, 5, (6, 7))
        label[0, :3] = 3
        if kw.pop("col", False):
            label = label[..., None]
    w = rs.rand(5).astype(np.float32) + 0.5 if kw.pop("weight", False) \
        else None
    return x, label, w, kw


def _weighted(out):
    """A sum that weighs each element of an unreduced loss differently."""
    n = out.size if isinstance(out, jax.Array) else out.numel()
    ramp = np.arange(1, n + 1, dtype=np.float32).reshape(tuple(out.shape))
    return (out * (jnp.asarray(ramp) if isinstance(out, jax.Array)
                   else torch.as_tensor(ramp))).sum()


def _functionals_case():
    rs = np.random.RandomState(11)
    return rs.randn(4, 9).astype(np.float32), rs.randint(0, 9, (4, 1))


ADAMW_KW = dict(beta1=0.9, beta2=0.997, epsilon=1e-9, weight_decay=0.0,
                multi_precision=True)


def _adamw_case(params):
    """Two steps' gradients of the row's parameters (seed 3), and the JAX
    ``FusedAdamW(NoamDecay(512, 4000))`` with its state over the row's
    parameters in bf16 laid end to end as one tensor: the update is the
    same elementwise function on each element whatever tensor holds it,
    so one kernel call a step covers every tensor of the structure."""
    rs = np.random.RandomState(3)
    grads = [{k: rs.randn(*np.shape(v)).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    jo = JaxFusedAdamW(learning_rate=JaxNoamDecay(512, 4000), **ADAMW_KW)

    def flat(d):
        return jnp.asarray(np.concatenate([
            np.ravel(np.asarray(d[k], np.float32)) for k in params]
        ).astype(jnp.bfloat16))
    p = {"w": flat(params)}
    return grads, p, jo.init(p), [{"w": flat(g)} for g in grads], jo


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file from one jitted call, compiled
    once: the row's loss, logits and gradients, the SDPA mask cases, the
    MHA calls, the encoder and decoder layers, the cross entropy cases,
    the other functionals and two ``FusedAdamW`` steps (Pallas in
    interpret mode)."""
    row = _build_row()
    big, params, buffers, keep, src, tgt = row
    mha_in, mha_params, mha_run = _build_mha()
    layers_in, layer_params, layers_run = _build_layers()
    sdpa_cases = [_mask_case(*c) for c in MASK_CASES]
    ce_cases = {c: _ce_case(c) for c in CE_CASES}
    fx, flabel = _functionals_case()
    grads, ap, astate, agrads, jo = _adamw_case(params)
    row_loss = jax.value_and_grad(_jax_loss(big, buffers, keep, src, tgt),
                                  has_aux=True)

    def run(rp, mp, lp, ces, fx, ap, astate, agrads):
        ce = {}
        for c, (_, label, w, kw) in ce_cases.items():
            ce[c] = jax.value_and_grad(lambda x: _weighted(jF.cross_entropy(
                x, label, weight=w, **kw)))(ces[c])
        fun = (jF.softmax_with_cross_entropy(fx, flabel, return_softmax=True),
               jnn.CrossEntropyLoss(ignore_index=2,
                                    label_smoothing=0.1)(fx, flabel),
               jF.log_softmax(fx), jF.softmax(fx, axis=0), jF.relu(fx),
               jF.label_smooth(fx, epsilon=0.2), jF.linear(fx, fx.T))
        for g in agrads:
            ap, astate = jo.update(g, astate, ap)
        return {"row": row_loss(rp),
                "sdpa": [jF.scaled_dot_product_attention(*c)
                         for c in sdpa_cases],
                "mha": mha_run(mp), "layers": layers_run(lp), "ce": ce,
                "functionals": fun,
                "adamw": (ap["w"], astate["master"]["w"],
                          astate["slots"]["w"])}
    out = jax.jit(run)(params, mha_params, layer_params,
                       {c: v[0] for c, v in ce_cases.items()}, fx, ap,
                       astate, agrads)
    return {"row": row, "row_want": out["row"],
            "sdpa": [np.asarray(o) for o in out["sdpa"]],
            "mha": (*mha_in, out["mha"]), "layers": (*layers_in,
                                                     out["layers"]),
            "ce": out["ce"], "functionals": (fx, flabel,
                                             out["functionals"]),
            "adamw": (grads, jax.tree.map(np.asarray, out["adamw"]))}


@pytest.fixture(scope="module")
def row(ref):
    """The JAX row, its parameters as numpy, and the batch."""
    return ref["row"]


def test_transformer_forward_loss_and_every_gradient(ref, row):
    """The row with the key-padding ``src_mask`` / ``memory_mask`` and the
    causal ``tgt_mask``, the WMT loss (``ignore_index`` = pad, label
    smoothing 0.1): the logits, the loss and every parameter's
    gradient."""
    big, params, buffers, keep, src, tgt = row
    (jl, jlogits), jg = ref["row_want"]
    m = _port_row(params)
    tmask = nn.Transformer.generate_square_subsequent_mask(ST, device="cpu")
    F.scaled_dot_product_attention.dense_calls = 0
    logits = m(_t(src), _t(tgt[:, :-1]), _t(keep), tmask, _t(keep))
    loss = F.cross_entropy(logits, _t(tgt[:, 1:]), ignore_index=PAD,
                           label_smoothing=0.1)
    loss.backward()
    # every attention call is masked: 2 encoder + 2 x 2 decoder
    assert F.scaled_dot_product_attention.dense_calls == 3 * LAYERS
    _close(logits, jlogits)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=REL)
    names = dict(m.named_parameters())
    assert sorted(names) == sorted(jg)
    for k, p in names.items():
        assert p.grad is not None, k
        _close(p.grad, jg[k])


def test_cached_decoding_matches_the_uncached_causal_forward(row):
    """``decoder.gen_cache(memory)`` then one token a step, in eval (the
    attention dropout 0.1 off): each step's output equals the uncached
    decoder's over the same prefix under the causal mask (the forward the
    test above holds to the reference).  Cached self-attention takes the
    flash path, the masked cross-attention the dense one."""
    _, params, _, keep, src, tgt = row
    m = _port_row(params)
    tr = m.tr
    for mod in tr.modules():
        if isinstance(mod, nn.MultiHeadAttention):
            mod.dropout = 0.1
    tr.eval()
    s_x, t_x = m.emb(_t(src)), m.emb(_t(tgt[:, :-1]))
    memory = tr.encoder(s_x, _t(keep))
    want = tr.decoder(t_x, memory, nn.Transformer.
                      generate_square_subsequent_mask(ST, device="cpu"),
                      _t(keep))
    cache = tr.decoder.gen_cache(memory)
    assert isinstance(cache[0][0], nn.MultiHeadAttention.Cache)
    assert isinstance(cache[0][1], nn.MultiHeadAttention.StaticCache)
    F.scaled_dot_product_attention.dense_calls = 0
    for t in range(ST):
        out, cache = tr.decoder(t_x[:, t:t + 1], memory, None, _t(keep),
                                cache)
        _close(out[:, 0], want[:, t].detach().numpy())
        assert cache[0][0].k.shape == (B, t + 1, H, D // H)
    # one masked cross-attention a layer and step; self-attention flash
    assert F.scaled_dot_product_attention.dense_calls == ST * LAYERS
    zipped = tr.decoder.gen_cache(memory, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == LAYERS


@pytest.fixture(scope="module")
def sdpa_want(ref):
    """The reference's outputs of every mask case."""
    return ref["sdpa"]


@pytest.mark.parametrize("i", range(len(MASK_CASES)),
                         ids=[f"{k}_{len(s)}d_{s[0]}" for k, s in MASK_CASES])
def test_sdpa_masks_match_the_reference(sdpa_want, i):
    """The dense form against the reference's, bool masks (True keeps) and
    additive ones of 2-D to 4-D shape, each with a fully masked row (the
    reference's uniform average over every key, not NaN)."""
    q, k, v, mask = _mask_case(*MASK_CASES[i])
    F.scaled_dot_product_attention.dense_calls = 0
    got = F.scaled_dot_product_attention(_t(q), _t(k), _t(v), _t(mask))
    assert F.scaled_dot_product_attention.dense_calls == 1
    assert torch.isfinite(got).all()
    _close(got, sdpa_want[i])


@pytest.fixture(scope="module")
def mha(ref):
    """The JAX ``MultiHeadAttention``, its inputs and its outputs."""
    return ref["mha"]


@pytest.mark.parametrize("case", MHA_CASES)
def test_multi_head_attention_matches_the_reference(mha, case):
    """Self-attention under a 3-D bool mask (broadcast over the heads),
    cross-attention under a 4-D key-padding mask, the incremental
    ``Cache`` over 5 steps (against the causal forward) and the
    ``StaticCache`` of the memory."""
    jm, x, mem, self_mask, cross_mask, want = mha
    port = _port(jm, nn.MultiHeadAttention, D, H).eval()
    if case == "self":
        got = port(_t(x), None, None, _t(self_mask))
    elif case == "cross":
        got = port(_t(x), _t(mem), _t(mem), _t(cross_mask))
    elif case == "cache":
        pc = port.gen_cache(_t(x))
        assert pc.k.shape == (B, 0, H, D // H)
        got = []
        for t in range(x.shape[1]):
            po, pc = port(_t(x[:, t:t + 1]), cache=pc)
            got.append(po)
        got = torch.cat(got, 1)
        _close(pc.k, port._split_heads(port.k_proj(_t(x))).detach().numpy())
    else:
        pc = port.gen_cache(_t(mem), _t(mem))
        assert isinstance(pc, nn.MultiHeadAttention.StaticCache)
        got, same = port(_t(x), cache=pc)
        assert same is pc
    _close(got, want[case])


@pytest.fixture(scope="module")
def layers(ref):
    """Both forms of the JAX encoder and decoder layers, the inputs and
    their outputs."""
    return ref["layers"]


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_norm", "pre_norm"])
def test_encoder_and_decoder_layers_match_the_reference(layers,
                                                        normalize_before):
    """Both ``normalize_before`` forms of one encoder layer (bool src
    mask) and one decoder layer (causal and key-padding masks), and the
    gelu activation resolving through ``getattr(F, activation)``."""
    built, keep, src, tgt, causal, want = layers
    jenc, jdec = built[normalize_before]
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    enc = _port(jenc, nn.TransformerEncoderLayer, D, H, FFN,
                activation="gelu" if normalize_before else "relu",
                **kw).eval()
    dec = _port(jdec, nn.TransformerDecoderLayer, D, H, FFN, **kw).eval()
    _close(enc(_t(src), _t(keep)), want[normalize_before][0])
    _close(dec(_t(tgt), _t(src), _t(causal), _t(keep)),
           want[normalize_before][1])


@pytest.fixture(scope="module")
def ce_want(ref):
    """The reference's value and input gradient of every case."""
    return ref["ce"]


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_the_reference(ce_want, case):
    """``cross_entropy`` with ``ignore_index``, class ``weight``,
    ``label_smoothing``, ``soft_label`` and each reduction (hard labels
    also as a size-1 last dim), the loss and its input gradient."""
    x, label, w, kw = _ce_case(case)
    tx = _t(x).requires_grad_()
    out = _weighted(F.cross_entropy(tx, _t(label),
                                    weight=None if w is None else _t(w),
                                    **kw))
    out.backward()
    jv, jg = ce_want[case]
    np.testing.assert_allclose(out.item(), float(jv), rtol=REL)
    _close(tx.grad, jg)


def test_cross_entropy_layer_and_the_other_functionals(ref):
    """``CrossEntropyLoss``, ``softmax_with_cross_entropy`` (with the
    softmax), ``log_softmax`` / ``softmax`` / ``relu`` / ``label_smooth``
    / ``linear`` against the reference."""
    x, label, ((wl, wsm), wloss, *want) = ref["functionals"]
    got, sm = F.softmax_with_cross_entropy(_t(x), _t(label),
                                           return_softmax=True)
    _close(got, wl)
    _close(sm, wsm)
    layer = nn.CrossEntropyLoss(ignore_index=2, label_smoothing=0.1)
    np.testing.assert_allclose(layer(_t(x), _t(label)).item(), float(wloss),
                               rtol=REL)
    tx = _t(x)
    for g, w in zip((F.log_softmax(tx, dtype="float32"),
                     F.softmax(tx, axis=0), F.relu(tx),
                     F.label_smooth(tx, epsilon=0.2), F.linear(tx, tx.T)),
                    want):
        _close(g, w)


def test_fused_adamw_two_steps_of_the_row_match_the_reference(ref, row):
    """Two ``FusedAdamW(NoamDecay(512, 4000), beta2=0.997, epsilon=1e-9,
    multi_precision=True)`` steps over the row's parameters in bf16 with
    f32 masters, the same bf16 gradients, against the JAX ``FusedAdamW``
    (its Pallas kernel in interpret mode, over the same elements laid end
    to end): masters and moments rtol 1e-6, the bf16 parameters within
    one bf16 ulp."""
    _, params, _, _, _, _ = row
    grads, (jp, jmaster, jslots) = ref["adamw"]
    m = _port_row(params, torch.bfloat16)
    sched = NoamDecay(512, 4000)
    opt = FusedAdamW(learning_rate=sched, **ADAMW_KW).bind(m)
    for g in grads:
        opt.step({k: torch.as_tensor(v).bfloat16() for k, v in g.items()})
        sched.step()
    assert fw.fused_adamw.launches == 0          # CPU: the plain version
    st = opt.state
    assert st["step"] == 2 and len(st["master"]) == len(params)
    at = 0
    for k in params:
        p = dict(m.named_parameters())[k]
        n = p.numel()

        def cut(x):
            return np.asarray(x[at:at + n], np.float32).reshape(p.shape)
        np.testing.assert_allclose(st["master"][k].numpy(), cut(jmaster),
                                   rtol=1e-6, atol=1e-7)
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(st["slots"][k][slot].numpy(),
                                       cut(jslots[slot]), rtol=1e-6,
                                       atol=1e-7)
        wp = cut(jp)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wp), 1e-30))) - 7)
        assert np.all(np.abs(p.detach().float().numpy() - wp) <= ulp), k
        at += n
    assert at == jmaster.shape[0]


def test_sdpa_route_is_chosen_by_its_arguments(monkeypatch):
    """No mask and no dropout in training -> the flash path (its plain
    version on the CPU); a mask, or dropout in training -> the dense form,
    counted; dropout in eval -> flash.  A kernel failure is not caught."""
    from paddle_tpu_torch.nn.functional import attention
    x = torch.randn(1, 4, 2, 8)
    calls = []
    real = attention._flash
    monkeypatch.setattr(attention, "_flash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator().manual_seed(0)
    F.scaled_dot_product_attention.dense_calls = 0
    F.scaled_dot_product_attention(x, x, x, is_causal=True)
    F.scaled_dot_product_attention(x, x, x, dropout_p=0.1, training=False)
    assert len(calls) == 2 and F.scaled_dot_product_attention.dense_calls == 0
    F.scaled_dot_product_attention(x, x, x, attn_mask=torch.ones(4, 4).bool())
    F.scaled_dot_product_attention(x, x, x, dropout_p=0.1, generator=g)
    assert len(calls) == 2 and F.scaled_dot_product_attention.dense_calls == 2

    def broken(*a, **k):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(attention, "_flash", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        F.scaled_dot_product_attention(x, x, x)


def test_dropout_statistics_and_generators():
    """The keep rate, the ``1 / (1 - p)`` scale, equal results for equal
    generator states (in ``F.dropout``, the layer and the attention
    dropout), ``axis``, ``downscale_in_infer``, ``p == 1`` and the
    refusal without a generator."""
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(1)
    state0 = g.get_state()
    y = F.dropout(x, 0.3, generator=g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert (y[kept] == torch.tensor(1.0) / 0.7).all()
    g.set_state(state0)
    assert torch.equal(F.dropout(x, 0.3, generator=g), y)
    layer = nn.Dropout(0.3, generator=g)
    g.set_state(state0)
    assert torch.equal(layer(x), y)
    assert torch.equal(layer.eval()(x), x)
    ya = F.dropout(x, 0.5, axis=0, generator=g)
    assert ((ya == 0).all(1) | (ya == 2).all(1)).all()
    yd = F.dropout(x, 0.3, mode="downscale_in_infer", generator=g)
    assert set(yd.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(
        F.dropout(x, 0.3, training=False, mode="downscale_in_infer"),
        x * 0.7)
    assert torch.equal(F.dropout(x, 1.0, generator=g), torch.zeros_like(x))
    with pytest.raises(ValueError, match="generator"):
        F.dropout(x, 0.3)
    q = torch.randn(2, 6, 2, 8)
    g.set_state(state0)
    a = F.scaled_dot_product_attention(q, q, q, dropout_p=0.2, generator=g)
    g.set_state(state0)
    b = F.scaled_dot_product_attention(q, q, q, dropout_p=0.2, generator=g)
    assert torch.equal(a, b)
    assert not torch.equal(a, F.scaled_dot_product_attention(q, q, q))


def test_layers_without_a_generator_use_the_global_one_and_refuse_dropout():
    """With no ``generator`` the layers draw their weights from torch's
    global generator (two layers built one after the other differ; the
    same global seed gives the same weights), and dropout in training
    raises; in eval, or at p = 0, no generator is needed."""
    torch.manual_seed(1)
    a = nn.TransformerEncoderLayer(D, H, FFN, device="cpu")
    b = nn.TransformerEncoderLayer(D, H, FFN, device="cpu")
    torch.manual_seed(1)
    c = nn.TransformerEncoderLayer(D, H, FFN, device="cpu")
    assert not torch.equal(a.linear1.weight, b.linear1.weight)
    assert torch.equal(a.linear1.weight, c.linear1.weight)
    assert a.self_attn.generator is None
    x = torch.randn(B, SS, D)
    with pytest.raises(ValueError, match="generator"):
        a(x)
    a.eval()(x)
    nn.TransformerEncoderLayer(D, H, FFN, dropout=0.0, device="cpu")(x)
    g = torch.Generator().manual_seed(2)
    d = nn.TransformerEncoderLayer(D, H, FFN, device="cpu", generator=g)
    state0 = g.get_state()
    y = d(x)
    g.set_state(state0)
    assert torch.equal(d(x), y)


def test_linear_takes_the_reference_positional_order():
    """``Linear(in, out, weight_attr, bias_attr)``: ``Linear(4, 8, None,
    False)`` has no bias; a ``weight_attr`` raises naming item 10."""
    lin = nn.Linear(4, 8, None, False, device="cpu")
    assert lin.bias is None and tuple(lin.weight.shape) == (4, 8)
    assert nn.Linear(4, 8, None, None, device="cpu").bias.shape == (8,)
    with pytest.raises(NotImplementedError, match="item 10"):
        nn.Linear(4, 8, object(), device="cpu")


def test_state_copy_raises_on_missing_extra_and_shape(mha):
    m = nn.MultiHeadAttention(D, H, device="cpu")
    arrays = {k: np.asarray(v) for k, v in state(mha[0])[0].items()}
    with pytest.raises(KeyError, match="missing"):
        layer_state_from_jax({k: v for k, v in arrays.items()
                              if k != "q_proj.bias"}, m)
    with pytest.raises(KeyError, match="unexpected"):
        layer_state_from_jax({**arrays, "x.weight": arrays["q_proj.bias"]},
                             m)
    with pytest.raises(ValueError, match="shape"):
        layer_state_from_jax({**arrays, "q_proj.bias": np.zeros(3)}, m)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        nn.Transformer(D, H, 1, 1, FFN)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        nn.Transformer.generate_square_subsequent_mask(4)
