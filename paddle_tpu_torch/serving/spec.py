"""Host-side n-gram draft tables for speculative decoding (a copy of
paddle_tpu/serving/spec.py; the port imports nothing of the JAX package).

The speculative path splits the work in two:

  * **draft** (this module, pure host): one :class:`NGramDraftTable`
    per in-flight request proposes up to ``spec_k`` next tokens from an
    order-2/3 suffix lookup over the request's OWN committed tokens
    (prompt + everything already emitted).  The table is seeded from
    the prompt at admission and updated at harvest time, after the
    step's single device readback.
  * **verify** (``EngineCore._verify_body``): ONE batched
    ``[num_slots, spec_k+1]`` forward over every slot's draft window at
    its own ``seq_pos``; the engine commits the longest verified prefix
    plus one bonus token.

Chained greedy lookup: ``propose`` walks the table token by token —
the trigram successor of the last two committed tokens when one was
recorded, the bigram successor of the last token otherwise — feeding
each prediction back in as context, so one table hit can draft a whole
``spec_k`` window.  Most-recent occurrence wins on conflict: recency
tracks the request's local phrasing better than frequency for the short
horizons involved.

Constrained decoding composes at the draft tier too: a proposal stops
at the first token outside the request's ``allowed_tokens`` set, since
the verify step's vocab mask would reject it anyway — under an
unsatisfiable mask the table simply stops proposing and the slot rides
the normal one-token path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["NGramDraftTable"]


class NGramDraftTable:
    """Order-2/3 suffix-lookup draft table over one request's tokens.

    Pure host state — a bigram map ``last -> next``, a trigram map
    ``(prev, last) -> next`` and the two-token context tail.  All
    methods are O(1) per token; the engine calls :meth:`observe` once
    per committed token and :meth:`propose` once per step.
    """

    __slots__ = ("_bi", "_tri", "_ctx")

    def __init__(self):
        self._bi: Dict[int, int] = {}
        self._tri: Dict[Tuple[int, int], int] = {}
        # (prev, last) committed-token context; None = not yet seen
        self._ctx: Tuple[Optional[int], Optional[int]] = (None, None)

    def __len__(self) -> int:
        return len(self._bi) + len(self._tri)

    def seed(self, tokens) -> None:
        """Record the prompt (or any committed token run) in order."""
        for t in tokens:
            self.observe(int(t))

    def observe(self, tok: int) -> None:
        """Record ONE committed token: the previous context now predicts
        it (most-recent occurrence wins), and the context advances."""
        tok = int(tok)
        prev, last = self._ctx
        if last is not None:
            self._bi[last] = tok
            if prev is not None:
                self._tri[(prev, last)] = tok
        self._ctx = (last, tok)

    def propose(self, k: int, allowed=None) -> List[int]:
        """Up to ``k`` draft tokens continuing the committed sequence —
        a chained greedy walk preferring the trigram successor over the
        bigram one, stopped at the first miss (or, with an ``allowed``
        token set, the first out-of-set prediction).  Returns [] when
        the table has no prediction: the slot then falls back to the
        normal single-token decode for this step."""
        prev, last = self._ctx
        out: List[int] = []
        while len(out) < k:
            nxt = self._tri.get((prev, last)) if prev is not None \
                else None
            if nxt is None and last is not None:
                nxt = self._bi.get(last)
            if nxt is None or (allowed is not None
                               and nxt not in allowed):
                break
            out.append(nxt)
            prev, last = last, nxt
        return out
