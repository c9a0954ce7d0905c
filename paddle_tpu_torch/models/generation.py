"""Autoregressive generation (counterpart of paddle_tpu/models/
generation.py: ``generate`` and its top-k / top-p filters).

The prompt is prefilled in one cached ``decode_step`` (causal within the
chunk), then one ``decode_step`` per new token.  PyTorch runs eagerly, so
the reference's single ``lax.scan`` becomes a Python loop over the same
functional cache.

Sampling draws from ONE ``torch.Generator`` seeded from ``seed``, in
token order: the first token, then one draw per step.  The serving
engine gives each request its own generator with the same discipline,
so a single-request engine run reproduces ``generate(seed=...)``.  A
``torch.Generator`` does not reproduce ``jax.random`` streams: across
the two packages only greedy tokens and the filter masks agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["generate"]


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _filter_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the probability-
    sorted vocab whose mass reaches ``p`` (the top token always stays).
    ``p`` is a float or a tensor broadcasting against the rows."""
    sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sorted_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    # token i is kept while the mass BEFORE it is < p
    before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = before < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, sorted_idx,
                                                 keep_sorted)
    return logits.masked_fill(~keep, float("-inf"))


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max trick,
    with noise from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int, do_sample: bool = False,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None,
             pad_token_id: Optional[int] = None, seed: int = 0,
             output_scores: bool = False, prompt_lens=None):
    """Generate ``max_new_tokens`` continuations of ``input_ids``
    ([batch, prompt_len]) and return the full sequences
    ``[batch, prompt_len + max_new_tokens]`` on the model's device.

    ``do_sample=False`` is greedy; sampling applies ``temperature`` then
    ``top_k`` (0 = off) then ``top_p`` (1.0 = off).  With
    ``eos_token_id`` set, rows that emitted it keep emitting
    ``pad_token_id`` (default: the eos id).  ``output_scores=True``
    returns ``(seq, scores)``, with ``scores`` the pre-sampling float32
    logits of every generated position ``[batch, max_new_tokens,
    vocab]``.  ``prompt_lens`` ([batch])
    admits ragged right-padded prompts, as in the reference: row r's
    prompt is ``input_ids[r, :prompt_lens[r]]`` and its new tokens land in
    the trailing ``max_new_tokens`` columns."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if do_sample and temperature <= 0:
        raise ValueError("temperature must be > 0 when sampling")
    device = model.device
    input_ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(device)
    b, s0 = input_ids.shape
    max_seq = model.cfg.max_seq_len
    if s0 + max_new_tokens > max_seq:
        raise ValueError(
            f"prompt_len {s0} + max_new_tokens {max_new_tokens} exceeds "
            f"the model's max_seq_len {max_seq} (position table size)")
    pad = eos_token_id if pad_token_id is None else pad_token_id
    lens = None
    if prompt_lens is not None:
        host = np.asarray(prompt_lens.cpu() if isinstance(
            prompt_lens, torch.Tensor) else prompt_lens)
        if host.shape != (b,):
            raise ValueError(f"prompt_lens must be [{b}], got {host.shape}")
        if host.min() < 1 or host.max() > s0:
            raise ValueError(f"prompt_lens entries must lie in [1, {s0}]")
        lens = torch.as_tensor(host, dtype=torch.int32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def pick(logits):
        logits = logits.float()
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k:
            logits = _filter_top_k(logits, top_k)
        if top_p < 1.0:
            logits = _filter_top_p(logits, top_p)
        return _categorical(logits, generator)

    caches = model.init_cache(b, s0 + max_new_tokens)
    logits, caches = model.decode_step(input_ids, caches, 0)
    if lens is None:
        last = logits[:, -1]
    else:
        # each row's last VALID prompt position carries its next-token
        # distribution; pad-tail logits are skipped
        last = logits[torch.arange(b, device=device), lens.long() - 1]
    scores = [last.float()] if output_scores else None
    tok = pick(last)
    tokens = [tok]
    finished = tok == eos_token_id if eos_token_id is not None \
        else torch.zeros(b, dtype=torch.bool, device=device)
    if lens is not None:
        # re-anchor the caches at each row's own length so decode writes
        # land at per-row offsets and the pad tail stays masked
        caches = [(c[0], c[1], lens) for c in caches]
    pos = s0 if lens is None else lens
    for _ in range(max_new_tokens - 1):
        logits, caches = model.decode_step(tok[:, None], caches, pos)
        if output_scores:
            scores.append(logits[:, 0].float())
        nxt = pick(logits[:, 0])
        if eos_token_id is not None:
            nxt = torch.where(finished, torch.as_tensor(pad, device=device),
                              nxt)
            finished = finished | (nxt == eos_token_id)
        tokens.append(nxt)
        tok, pos = nxt, pos + 1
    seq = torch.cat([input_ids, torch.stack(tokens, 1).to(input_ids.dtype)],
                    dim=1)
    return (seq, torch.stack(scores, 1)) if output_scores else seq
