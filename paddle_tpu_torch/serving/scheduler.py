"""Request admission + FCFS queue + prefill/decode interleaving policy.

The port's own copy of paddle_tpu/serving/scheduler.py (pure host code;
``bucket_length`` and ``chunk_plan`` behave exactly as the reference's).
The scheduler is pure host-side control plane: it owns the waiting queue,
the slot -> request map, and the BUCKETING policy that keeps the compile
cache bounded.  Nothing here touches device arrays — the engine asks
"what should run this step" and the scheduler answers with host ints.

Bucketing: prefill runs at the prompt's length rounded UP to a power of
two (floor ``min_bucket``), so a mixed-length workload lowers at most
``O(log2(max_seq / min_bucket))`` distinct prefill programs instead of
one per length.
With chunked prefill (``chunk_plan``) the suffix instead runs as fixed
``prefill_chunk``-token pieces plus one bucketed tail, interleaved with
decode at step granularity.  Decode is always the single
``[num_slots, 1]`` program.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SamplingParams", "Request", "Scheduler", "bucket_length",
           "PRIORITIES"]

DEFAULT_MIN_BUCKET = 16

# request priority classes:
# "interactive" is the latency-sensitive default; "batch" is offline
# work the admission window may defer behind interactive arrivals and
# the fleet brownout sheds FIRST under sustained overload
PRIORITIES = ("interactive", "batch")


def bucket_length(n: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                  max_len: Optional[int] = None) -> int:
    """Smallest power-of-two >= ``n`` (floored at ``min_bucket``, capped
    at ``max_len``).  The cap may round DOWN below the pow2 — a prompt of
    0.9*max_seq still pads only to max_len, never past the cache."""
    if n < 1:
        raise ValueError("length must be >= 1")
    if max_len is not None and n > max_len:
        raise ValueError(f"length {n} exceeds max_len {max_len}")
    b = max(min_bucket, 1)
    while b < n:
        b *= 2
    if max_len is not None:
        b = min(b, max_len)
    return b


@dataclasses.dataclass
class SamplingParams:
    """Per-request decode policy.  ``do_sample=False`` is greedy (the
    temperature/top_k/top_p knobs are then inert); sampling applies
    temperature, then top-k (0 = off), then top-p (1.0 = off) — the same
    order and semantics as ``models.generation.generate``."""
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def validate(self) -> None:
        if self.do_sample and self.temperature <= 0:
            raise ValueError("temperature must be > 0 when sampling")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must lie in (0, 1]")


@dataclasses.dataclass
class Request:
    """One in-flight generation request (control-plane state; the KV
    context lives in the pool slot while the request is running)."""
    request_id: int
    prompt: np.ndarray                       # [prompt_len] int token ids
    max_new_tokens: int
    sampling: SamplingParams
    eos_token_id: Optional[int] = None
    stream: Optional[object] = None          # callable(request, token)
    # priority class ("interactive" | "batch"): interactive is the
    # latency-sensitive default; batch is deferrable offline work —
    # admission prefers interactive inside the bounded skip window and
    # a fleet brownout sheds batch first
    priority: str = "interactive"
    arrival_time: float = 0.0
    # robustness surface: deadlines
    # are seconds RELATIVE to submission, checked host-side per step
    deadline_s: Optional[float] = None       # submit -> finish budget
    ttft_deadline_s: Optional[float] = None  # submit -> first token
    # constrained decoding: the only token ids this request may emit,
    # applied as a per-slot vocab mask inside the decode step's sampling;
    # None = unconstrained
    allowed_tokens: Optional[np.ndarray] = None
    # engine-owned progress
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None      # "eos" | "length"
    # terminal disposition — every request ends with exactly one:
    # "finished" | "cancelled" | "deadline_exceeded" | "rejected" |
    # "failed" (None only while in flight); status_reason carries the
    # human-readable why ("eos", "ttft deadline 0.05s exceeded", ...)
    status: Optional[str] = None
    status_reason: Optional[str] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    admit_time: Optional[float] = None       # queue exit (telemetry)
    last_token_time: Optional[float] = None  # previous emit (TPOT)
    prefix_hit_tokens: int = 0               # prompt tokens served from
    prefill_chunks: int = 0                  # the radix cache / chunks run
    # a regeneration's plan start (the router's failover, hedge and
    # recovery): the first attempt's radix hit, below which this engine's
    # match is capped and from which its chunks are the first attempt's
    plan_start: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def deadline_violation(self, now: float) -> Optional[str]:
        """The deadline this request has blown at host time ``now``
        (perf_counter base), or None.  End-to-end is checked first —
        it subsumes TTFT once tokens flow."""
        if self.deadline_s is not None \
                and now - self.arrival_time > self.deadline_s:
            return (f"end-to-end deadline {self.deadline_s}s exceeded "
                    f"({len(self.tokens)} tokens generated)")
        if self.first_token_time is None \
                and self.ttft_deadline_s is not None \
                and now - self.arrival_time > self.ttft_deadline_s:
            return f"TTFT deadline {self.ttft_deadline_s}s exceeded"
        return None


class Scheduler:
    """FCFS admission over a fixed slot budget, with a BOUNDED
    head-of-line escape hatch.

    ``admit()`` pops waiting requests in arrival order while free slots
    (and the optional per-step prefill token budget) remain — the engine
    prefills each admitted request and then runs ONE decode step over all
    occupied slots, so prefill and decode interleave at step granularity.

    Head-of-line fix: when the head request's prefill cost (its UNCACHED
    suffix bucket — the ``cost`` callable, prefix-cache aware) exceeds
    the remaining token budget but a later queued request fits, the later
    one is admitted instead of idling free slots.  The skip is bounded
    two ways: only the first ``skip_window`` queue positions are eligible
    to jump, and after ``max_head_skips`` total jumps over the same head
    the window collapses to the head alone — admission then waits for the
    budget the head needs, so no request starves."""

    def __init__(self, num_slots: int, max_seq: int,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_prefills_per_step: Optional[int] = None,
                 skip_window: int = 4, max_head_skips: int = 16):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.min_bucket = min_bucket
        # None = admit as many as slots allow each step; a small cap
        # trades TTFT of queued requests against decode stalls of the
        # already-running ones (prefill blocks the shared step loop)
        self.max_prefills_per_step = max_prefills_per_step
        self.skip_window = skip_window
        self.max_head_skips = max_head_skips
        self._head_skips = 0
        # lifetime jump count (never reset by a head admission) — the
        # engine turns per-step deltas into head_of_line_skip events
        self.total_head_skips = 0
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._ids = itertools.count()

    # -------------------------------------------------------- submission
    def submit(self, req: Request) -> Request:
        req.sampling.validate()
        if req.priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, "
                f"got {req.priority!r}")
        if req.prompt_len < 1:
            raise ValueError("prompt must hold at least one token")
        if req.prompt_len + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt_len {req.prompt_len} + max_new_tokens "
                f"{req.max_new_tokens} exceeds the pool max_seq "
                f"{self.max_seq}")
        if req.arrival_time == 0.0:
            req.arrival_time = time.perf_counter()
        self.waiting.append(req)
        return req

    def next_request_id(self) -> int:
        return next(self._ids)

    def start_ids(self, start: int) -> None:
        """Advance the request-id counter so ids begin at ``start``: an
        engine reopening a durable journal must never reuse an id the
        journal already holds (the ledger would alias two requests).
        Only legal before any id was handed out."""
        self._ids = itertools.count(start)

    # --------------------------------------------------------- admission
    def bucket(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, self.min_bucket, self.max_seq)

    def chunk_plan(self, start: int, prompt_len: int,
                   prefill_chunk: Optional[int]) -> List[Tuple[int, int, int]]:
        """Split the uncached suffix ``[start, prompt_len)`` into prefill
        chunks: ``(offset, width, valid)`` triples where ``width`` is the
        compiled program's token width and ``valid <= width`` the real
        tokens in the chunk.

        ``prefill_chunk=None`` -> ONE chunk at the suffix's pow2 bucket
        (the pre-chunking behavior).  Otherwise every chunk except the
        last runs at exactly ``prefill_chunk`` tokens and the tail runs
        at its own pow2 bucket (capped at the chunk size), so the
        compiled-program set stays {chunk} + O(log2(prefill_chunk /
        min_bucket)) regardless of prompt lengths — and the engine can
        interleave one chunk per step with the all-slots decode program
        instead of stalling every stream behind a whole-prompt prefill."""
        out: List[Tuple[int, int, int]] = []
        pos = start
        while pos < prompt_len:
            rem = prompt_len - pos
            if prefill_chunk is not None and rem > prefill_chunk:
                w = v = prefill_chunk
            else:
                w = bucket_length(rem, self.min_bucket, self.max_seq - pos)
                if prefill_chunk is not None:
                    w = min(w, prefill_chunk)
                v = rem
            out.append((pos, w, v))
            pos += v
        return out

    def admit(self, free_slots: int, token_budget: Optional[int] = None,
              cost=None) -> List[Tuple[Request, int]]:
        """Pop up to ``free_slots`` (and the per-step prefill cap)
        waiting requests, returning ``(request, prefill_cost)`` pairs.
        Slot indices are assigned by the caller (the pool owns the free
        list).

        ``cost(req)`` is the prefill work the request needs THIS step in
        tokens (the engine passes its prefix-cache-aware suffix bucket,
        capped at one chunk); default: the full-prompt pow2 bucket.
        ``token_budget`` caps the summed cost per call (None = unbounded
        -> pure FCFS).  When the head doesn't fit the remaining budget, a
        later request within ``skip_window`` may jump it — see the class
        docstring for the no-starvation bound."""
        cap = free_slots if self.max_prefills_per_step is None else \
            min(free_slots, self.max_prefills_per_step)
        if cost is None:
            cost = lambda r: self.bucket(r.prompt_len)
        if token_budget is not None and token_budget < 1:
            # a budget the loop gate can never open would silently starve
            # every request (the over-budget head escape sits INSIDE the
            # gate) — reject loudly instead
            raise ValueError(
                f"token_budget must be >= 1, got {token_budget}")
        budget = float("inf") if token_budget is None else int(token_budget)
        out: List[Tuple[Request, int]] = []
        while self.waiting and len(out) < cap and budget > 0:
            window = 1 if self._head_skips >= self.max_head_skips \
                else 1 + self.skip_window
            # priority-aware pick inside the SAME bounded window: the
            # first budget-fitting interactive request wins; a batch
            # request is admitted only when no interactive one fits.
            # The window/head-skip bounds are unchanged, so the
            # no-starvation guarantee holds for batch work too — once
            # max_head_skips jumps collapse the window to the head,
            # even a batch head admits (a batch request can be
            # deferred, never starved)
            pick = batch_pick = None
            for j, req in enumerate(
                    itertools.islice(self.waiting, window)):
                c = cost(req)
                if c <= budget:
                    if req.priority != "batch":
                        pick, pick_cost = j, c
                        break
                    if batch_pick is None:
                        batch_pick = (j, c)
            if pick is None and batch_pick is not None:
                pick, pick_cost = batch_pick
            if pick is None:
                head_cost = cost(self.waiting[0])
                if not out and token_budget is not None \
                        and head_cost > token_budget:
                    # the head exceeds even a FULL step budget, so
                    # deferring it can never end: the budget is a stall
                    # bound, not a correctness bound — admit it anyway
                    # (one over-budget step) instead of idling forever
                    pick, pick_cost = 0, head_cost
                else:
                    break
            if pick == 0:
                self._head_skips = 0
            else:
                self._head_skips += 1
                self.total_head_skips += 1
            req = self.waiting[pick]
            del self.waiting[pick]
            budget -= pick_cost
            out.append((req, pick_cost))
        return out

    def remove_waiting(self, request_id: int) -> Optional[Request]:
        """Pull one request out of the waiting queue by id (cancellation
        / deadline expiry of a not-yet-admitted request); returns it, or
        None when it is not queued."""
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                return req
        return None

    def expired_waiting(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline has
        already passed at ``now`` — a request that can no longer meet
        its SLO must not consume a slot and a prefill first."""
        out = [r for r in self.waiting
               if r.deadline_violation(now) is not None]
        for r in out:
            self.waiting.remove(r)
        return out

    def requeue_front(self, reqs: List[Request]) -> None:
        """Push admitted-but-not-started requests back onto the HEAD of
        the waiting queue, preserving their relative order — the engine
        uses this when admission fails partway through a batch so no
        popped request is ever lost."""
        for req in reversed(reqs):
            self.waiting.appendleft(req)

    def place(self, req: Request, slot: int) -> None:
        if slot in self.running:
            raise ValueError(f"slot {slot} already occupied")
        self.running[slot] = req

    def release(self, slot: int) -> Request:
        return self.running.pop(slot)

    # ------------------------------------------------------------- state
    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
