"""Carry GPT, GPT-MoE and Llama weights from the JAX package into the
port.

The port keeps the reference's parameter names and layouts (``[in, out]``
Linear weights, ``[vocab, h]`` embeddings, the experts' ``stacked__*``
``[E, ...]`` tensors), so conversion is a key-for-key copy, checked
against the parameter table of the model's config.  The family is read
from the keys: ``gpt.`` (GPT), ``llama.`` (Llama) or a top-level
``wte.weight`` (GPT-MoE).  The JAX hybrid trainers' state (non-block
leaves and stacked blocks) unstacks into the same keys
(:func:`jax_trainer_arrays`), and :func:`hybrid_state_from_jax` lays
either form into the port trainer's rank blocks.  Any other layer (the
Transformer, a container of an embedding, a Transformer and a head) is
checked against the port module itself (:func:`layer_state_from_jax`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from .gpt import GPTConfig
from .gpt_moe import GPTMoEConfig
from .llama import LlamaConfig

__all__ = ["state_dict_from_jax", "layer_state_from_jax",
           "jax_trainer_arrays", "hybrid_state_from_jax"]


def _gpt_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter name of ``GPTForCausalLM(cfg)`` with its shape."""
    h, f = cfg.hidden_size, cfg.ffn_size
    out = {"gpt.wte.weight": (cfg.vocab_size, h),
           "gpt.wpe.weight": (cfg.max_seq_len, h)}
    for i in range(cfg.num_layers):
        p = f"gpt.h.{i}."
        for name, (fan_in, fan_out) in (("qkv", (h, 3 * h)),
                                        ("out_proj", (h, h)),
                                        ("fc_in", (h, f)),
                                        ("fc_out", (f, h))):
            out[p + name + ".weight"] = (fan_in, fan_out)
            if cfg.use_bias:
                out[p + name + ".bias"] = (fan_out,)
        for ln in ("ln_1", "ln_2"):
            out[p + ln + ".weight"] = (h,)
            out[p + ln + ".bias"] = (h,)
    out["gpt.ln_f.weight"] = (h,)
    out["gpt.ln_f.bias"] = (h,)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = (h, cfg.vocab_size)
    return out


def _gpt_moe_shapes(cfg: GPTMoEConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter name of ``GPTMoEForCausalLM(cfg)`` with its
    shape."""
    h, f, e = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    out = {"wte.weight": (cfg.vocab_size, h),
           "wpe.weight": (cfg.max_seq_len, h)}
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        for name, shape in (("ln_1.weight", (h,)), ("ln_1.bias", (h,)),
                            ("qkv.weight", (h, 3 * h)), ("qkv.bias", (3 * h,)),
                            ("out_proj.weight", (h, h)),
                            ("out_proj.bias", (h,)), ("ln_2.weight", (h,)),
                            ("ln_2.bias", (h,))):
            out[p + name] = shape
        if i % cfg.moe_every == cfg.moe_every - 1:
            out[p + "ffn.gate.gate_weight"] = (h, e)
            for name, shape in (("w0", (e, h, f)), ("b0", (e, f)),
                                ("w1", (e, f, h)), ("b1", (e, h))):
                out[p + "ffn.experts.stacked__" + name] = shape
        else:
            for name, shape in (("fc_in.weight", (h, f)), ("fc_in.bias", (f,)),
                                ("fc_out.weight", (f, h)),
                                ("fc_out.bias", (h,))):
                out[p + name] = shape
    out["ln_f.weight"] = (h,)
    out["ln_f.bias"] = (h,)
    return out


def _infer_gpt_moe(arrays: Mapping[str, np.ndarray]) -> GPTMoEConfig:
    for key in ("wte.weight", "wpe.weight"):
        if key not in arrays:
            raise KeyError(f"missing key in the JAX arrays: {key!r}")
    vocab, h = np.shape(arrays["wte.weight"])
    layers = _layers(arrays, r"h\.(\d+)\.")
    moe = sorted(int(m.group(1)) for k in arrays
                 if (m := re.match(r"h\.(\d+)\.ffn\.gate\.gate_weight$",
                                   k)))
    if not moe:
        raise KeyError("no MoE layer (h.{i}.ffn.gate.gate_weight) in the "
                       "JAX arrays")
    w0 = np.shape(arrays[f"h.{moe[0]}.ffn.experts.stacked__w0"])
    # the head count is not in the arrays and the table does not depend
    # on it
    return GPTMoEConfig(
        vocab_size=vocab, hidden_size=h, num_layers=layers, num_heads=1,
        max_seq_len=np.shape(arrays["wpe.weight"])[0], ffn_mult=w0[2] // h,
        num_experts=w0[0], moe_every=moe[0] + 1)


def _llama_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter name of ``LlamaForCausalLM(cfg)`` with its shape."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    out = {"llama.embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"llama.layers.{i}."
        out[p + "input_layernorm.weight"] = (h,)
        for name, shape in (("q_proj", (h, q)), ("k_proj", (h, kv)),
                            ("v_proj", (h, kv)), ("o_proj", (q, h))):
            out[p + "self_attn." + name + ".weight"] = shape
        out[p + "post_attention_layernorm.weight"] = (h,)
        for name, shape in (("gate_proj", (h, f)), ("up_proj", (h, f)),
                            ("down_proj", (f, h))):
            out[p + "mlp." + name + ".weight"] = shape
    out["llama.norm.weight"] = (h,)
    out["lm_head.weight"] = (h, cfg.vocab_size)
    return out


def _layers(arrays: Mapping[str, np.ndarray], pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in arrays
                   if (m := re.match(pattern, k)))


def _infer_llama(arrays: Mapping[str, np.ndarray]) -> LlamaConfig:
    for key in ("llama.embed_tokens.weight",
                "llama.layers.0.self_attn.k_proj.weight",
                "llama.layers.0.mlp.up_proj.weight"):
        if key not in arrays:
            raise KeyError(f"missing key in the JAX arrays: {key!r}")
    vocab, h = np.shape(arrays["llama.embed_tokens.weight"])
    kv = np.shape(arrays["llama.layers.0.self_attn.k_proj.weight"])[1]
    # the head count is not in the arrays, and the parameter table depends
    # only on the widths: any split of h and kv into heads gives the same
    d = math.gcd(h, kv)
    return LlamaConfig(
        vocab_size=vocab, hidden_size=h,
        intermediate_size=np.shape(
            arrays["llama.layers.0.mlp.up_proj.weight"])[1],
        num_layers=_layers(arrays, r"llama\.layers\.(\d+)\."),
        num_heads=h // d, num_kv_heads=kv // d)


def _infer_config(arrays: Mapping[str, np.ndarray]) -> GPTConfig:
    for key in ("gpt.wte.weight", "gpt.wpe.weight", "gpt.h.0.fc_in.weight"):
        if key not in arrays:
            raise KeyError(f"missing key in the JAX arrays: {key!r}")
    vocab, h = np.shape(arrays["gpt.wte.weight"])
    layers = _layers(arrays, r"gpt\.h\.(\d+)\.")
    return GPTConfig(
        vocab_size=vocab, hidden_size=h, num_layers=layers,
        max_seq_len=np.shape(arrays["gpt.wpe.weight"])[0],
        ffn_mult=np.shape(arrays["gpt.h.0.fc_in.weight"])[1] // h,
        use_bias="gpt.h.0.qkv.bias" in arrays,
        tie_embeddings="lm_head.weight" not in arrays)


def state_dict_from_jax(arrays: Mapping[str, np.ndarray],
                        device: Union[None, str, torch.device],
                        dtype: Union[None, str, torch.dtype],
                        cfg: Union[None, GPTConfig, GPTMoEConfig,
                                   LlamaConfig] = None
                        ) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` in ``dtype`` for the JAX GPT, GPT-MoE or
    Llama parameters ``arrays`` (``{k: np.asarray(v) for k, v in
    jax_model.state_dict().items()}``), ready for
    ``model.load_state_dict``.

    The family is the one ``cfg`` names or, when ``cfg`` is None, the one
    the keys name (any key under ``llama.``: Llama; a top-level
    ``wte.weight``: GPT-MoE; else GPT).  The keys
    and shapes are checked against the config's parameter table
    (inferred from the arrays when ``cfg`` is None): a missing or unexpected
    key raises ``KeyError`` and a shape mismatch ``ValueError``, each
    naming the key."""
    llama = isinstance(cfg, LlamaConfig) if cfg is not None else \
        any(k.startswith("llama.") for k in arrays)
    moe = isinstance(cfg, GPTMoEConfig) if cfg is not None else \
        "wte.weight" in arrays
    if moe:
        want = _gpt_moe_shapes(cfg if cfg is not None
                               else _infer_gpt_moe(arrays))
    elif llama:
        want = _llama_shapes(cfg if cfg is not None
                             else _infer_llama(arrays))
    else:
        want = _gpt_shapes(cfg if cfg is not None else _infer_config(arrays))
    for k in want:
        if k not in arrays:
            raise KeyError(f"missing key in the JAX arrays: {k!r}")
    for k in arrays:
        if k not in want:
            raise KeyError(f"unexpected key in the JAX arrays: {k!r}")
    for k, shape in want.items():
        got = tuple(np.shape(arrays[k]))
        if got != shape:
            raise ValueError(f"shape mismatch for {k!r}: JAX {got}, "
                             f"port {shape}")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    return {k: torch.as_tensor(np.array(arrays[k], dtype=np.float32)).to(
        device=device, dtype=dtype) for k in want}


def layer_state_from_jax(arrays: Mapping[str, np.ndarray],
                         module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX parameters of any ``paddle_tpu.nn.Layer`` (``{k:
    np.asarray(v)}`` of its state) as a state dict of ``module``, the port
    module of the same structure: a key-for-key copy, each tensor on the
    device and in the dtype of the module's own.  A key of the module
    missing from ``arrays`` or one ``arrays`` has beyond it raises
    ``KeyError``, a shape that differs ``ValueError``, each naming the
    key."""
    own = module.state_dict()
    for k in own:
        if k not in arrays:
            raise KeyError(f"missing key in the JAX arrays: {k!r}")
    for k in arrays:
        if k not in own:
            raise KeyError(f"unexpected key in the JAX arrays: {k!r}")
    out = {}
    for k, t in own.items():
        got = tuple(np.shape(arrays[k]))
        if got != tuple(t.shape):
            raise ValueError(f"shape mismatch for {k!r}: JAX {got}, port "
                             f"{tuple(t.shape)}")
        out[k] = torch.as_tensor(np.array(arrays[k], dtype=np.float32)).to(
            device=t.device, dtype=t.dtype)
    return out


def jax_trainer_arrays(pnb: Mapping[str, np.ndarray],
                       pblk: Mapping[str, np.ndarray],
                       n_stages: int = 1) -> Dict[str, np.ndarray]:
    """The JAX ``GPTHybridTrainer``'s (or ``GPTMoEHybridTrainer``'s)
    ``(pnb, pblk)`` as the model's per-layer arrays: ``pblk``'s stacked
    ``[L, ...]`` blocks, or under VPP its ``[S·V, K, ...]`` chunks in
    ``stack_interleaved`` order (row ``s·V + v`` holds chunk ``v·S + s``,
    layers ``[c·K, (c+1)·K)``), with ``S = n_stages``."""
    out = {k: np.asarray(v) for k, v in pnb.items()}
    pre = "h." if "wte.weight" in pnb else "gpt.h."
    interleaved = np.ndim(pblk["ln_1.weight"]) == 3
    for suffix, arr in pblk.items():
        a = np.asarray(arr)
        if not interleaved:
            for i in range(a.shape[0]):
                out[f"{pre}{i}.{suffix}"] = a[i]
            continue
        S, K = n_stages, a.shape[1]
        V = a.shape[0] // S
        order = [v * S + s for s in range(S) for v in range(V)]
        for row, c in enumerate(order):
            for k in range(K):
                out[f"{pre}{c * K + k}.{suffix}"] = a[row, k]
    return out


def hybrid_state_from_jax(params, trainer,
                          n_stages: Optional[int] = None
                          ) -> List[Dict[str, torch.Tensor]]:
    """Lay JAX GPT or GPT-MoE parameters into the port
    ``GPTHybridTrainer``'s (``GPTMoEHybridTrainer``'s) rank blocks, so
    both packages start the same step from the same weights.
    ``params`` is the JAX model's state (``{key: array}``) or the JAX
    trainer's ``(pnb, pblk)`` (:func:`jax_trainer_arrays`, with
    ``n_stages`` its pp degree, by default ``trainer``'s).  Keys and
    shapes are checked as in :func:`state_dict_from_jax`.  Returns each
    rank's blocks (``trainer.rank_state``); a serial trainer's model
    loads the weights and its state dict is the one entry."""
    if isinstance(params, tuple):
        params = jax_trainer_arrays(*params, n_stages=n_stages or trainer.S)
    trainer.load_state_dict(state_dict_from_jax(
        params, trainer.device, trainer.dtype, cfg=trainer.cfg))
    if trainer.grid is None:
        return [trainer.state_dict()]
    return [trainer.rank_state(r) for r in range(trainer.grid.size)]
