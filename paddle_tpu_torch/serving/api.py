"""Public serving surface: ``ServingEngine.submit()/step()/stream()``
(counterpart of paddle_tpu/serving/api.py).

The facade over ``engine.EngineCore``: request construction, streaming
token callbacks, the synchronous ``serve_batch()`` convenience, and the
metrics dict.  The engine runs on its model's device.  Typical use::

    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.serving import ServingEngine, SamplingParams

    eng = ServingEngine(GPTForCausalLM(gpt_small()), num_slots=8)
    h = eng.submit([12, 7, 99], max_new_tokens=32,
                   sampling=SamplingParams(do_sample=True, top_p=0.9),
                   eos_token_id=0)
    for tok in eng.stream(h):          # steps the engine as it yields
        ...
    out = eng.result(h)                # RequestOutput
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from .engine import EngineCore
from .errors import RequestRejected
from .health import FaultToleranceConfig
from .metrics import ServingMetrics
from .scheduler import PRIORITIES, Request, SamplingParams

__all__ = ["ServingEngine", "RequestOutput", "Request", "SamplingParams"]


@dataclasses.dataclass
class RequestOutput:
    """Completed (or in-flight) view of one request."""
    request_id: int
    prompt: np.ndarray
    tokens: List[int]
    finished: bool
    finish_reason: Optional[str]      # "eos" | "length" | None
    ttft_s: Optional[float]           # submit -> first token
    prefix_hit_tokens: int = 0        # prompt tokens served from cache
    # terminal disposition: one of "finished" | "cancelled" |
    # "deadline_exceeded" | "rejected" | "failed" once done (None in
    # flight); status_reason carries the why
    status: Optional[str] = None
    status_reason: Optional[str] = None

    @property
    def sequence(self) -> np.ndarray:
        """prompt + generated tokens, the ``generate()``-shaped result."""
        return np.concatenate(
            [np.asarray(self.prompt, np.int64),
             np.asarray(self.tokens, np.int64)])


class ServingEngine:
    """Continuous-batching serving over a causal LM exposing ``cfg``,
    ``device``, ``dtype``, ``init_cache`` and ``decode_step`` (and
    ``fused_decode_step`` for ``fused_decode``): ``GPTForCausalLM`` or
    ``LlamaForCausalLM``, on the model's device.

    ``num_slots`` fixes the decode batch; ``max_seq`` the per-slot KV
    budget (default: the model's max_seq_len).  Prefix reuse
    (``enable_prefix_cache``, default on): prompts sharing a block-aligned
    prefix with earlier traffic skip its recompute.  ``prefill_chunk``
    splits long suffixes into fixed-width chunks interleaved with decode
    (one chunk per step).  ``max_prefill_tokens_per_step`` caps admission
    prefill work per step; ``max_queue`` bounds the waiting queue.
    ``fused_decode`` opts the decode step into the fused decode-block
    kernels (kernels/decode_block.py) where the model supports them and
    they are legal at this engine's shape; ``decode_path`` /
    ``decode_fallback_reason`` say what was resolved.  The parameters
    after ``prefix_blocks`` are keyword-only.  ``record_events=True`` runs
    each step inside a ``profiler.RecordEvent("serving.step")`` and merges
    the tracer's request lanes into every ``profiler`` chrome export
    until :meth:`close`.

    ``fault_tolerance=FaultToleranceConfig(...)`` turns ``step()`` into
    the watchdog boundary (serving/health.py): step retries with
    backoff, the degradation ladder, the quarantine rebuild of the
    device plane and the circuit breaker; ``health`` and
    ``degraded_subsystems`` report its state.  ``faults=FaultInjector()``
    (serving/faults.py) arms named injection points for chaos tests.

    ``tensor_parallel > 1`` shards the engine over a 1-D mesh of
    ``devices`` (default: the first ``tensor_parallel`` CUDA devices; it
    raises when fewer are visible).  Shards may share a card
    (``devices=["cuda:0"] * 2``) or run on the CPU (``["cpu"] * 2``).  The
    model's weights are re-laid over the mesh in place (it then serves
    only through tensor-parallel engines on that mesh).
    ``collective_fusion`` (default on) lets the decode step take the ring
    programs: ``tp_fused_block`` (the sharded decode-block kernels, with
    ``fused_decode``) or ``tp_fused`` (the composed ring); otherwise, or
    when they are not legal, it runs ``unfused``.

    ``spec_k > 0`` arms speculative decoding: per-request n-gram drafts
    (``serving/spec.py``) checked by ONE batched ``[num_slots,
    spec_k+1]`` verify step (one CUDA graph per engine on a card), with
    matched sampling on each request's own generator.  The token streams
    equal ``spec_k=0``'s exactly where the verify logits are bit-identical
    to the decode step's (f32 on the CPU); in bf16 on a card they agree
    within a bound, and a near-tie may pick another token.  ``spec_on`` /
    ``spec_fallback_reason`` say what was resolved.

    ``journal=Journal.open(dir)`` (serving/journal.py) records every
    accepted request (``submit``, with its sampling spec and seed), the
    delivered marks once a step (``progress``) and each request's end
    (``terminal``, exactly once); the engine's ids start past those a
    reopened journal holds.  ``aot_store=AOTStore.open(dir)``
    (serving/aot.py) is attached at construction and after each
    quarantine's rebuild: the kernel libraries of every leg installed and,
    on a card, every graph captured before any request; ``aot_status``
    says how that went.

    ``role`` (``"unified"``, ``"prefill"`` or ``"decode"``) is the fleet
    role a :class:`~paddle_tpu_torch.serving.router.Router` routes by.
    """

    def __init__(self, model, num_slots: int = 8,
                 max_seq: Optional[int] = None, min_bucket: int = 16,
                 max_prefills_per_step: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 block_len: int = 16,
                 prefix_blocks: Optional[int] = None, *,
                 record_events: bool = False,
                 registry=None, tracer=None,
                 fused_decode: bool = False,
                 fault_tolerance: Optional[FaultToleranceConfig] = None,
                 faults=None,
                 max_queue: Optional[int] = None,
                 tensor_parallel: int = 1,
                 collective_fusion: bool = True,
                 devices=None,
                 role: str = "unified",
                 journal=None,
                 aot_store=None,
                 spec_k: int = 0):
        if role not in ("prefill", "decode", "unified"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'unified', "
                f"got {role!r}")
        # the fleet role (serving/router.py reads it when its roles= is
        # omitted); the engine itself behaves the same in every role
        self.role = role
        self.core = EngineCore(
            model, num_slots=num_slots, max_seq=max_seq,
            min_bucket=min_bucket,
            max_prefills_per_step=max_prefills_per_step,
            prefill_chunk=prefill_chunk,
            max_prefill_tokens_per_step=max_prefill_tokens_per_step,
            enable_prefix_cache=enable_prefix_cache,
            block_len=block_len, prefix_blocks=prefix_blocks,
            metrics=ServingMetrics(record_events=record_events,
                                   registry=registry, tracer=tracer),
            max_queue=max_queue, fused_decode=fused_decode,
            tensor_parallel=tensor_parallel,
            collective_fusion=collective_fusion, devices=devices,
            spec_k=spec_k, fault_tolerance=fault_tolerance, faults=faults,
            journal=journal, aot_store=aot_store)
        if journal is not None:
            journal.bind_metrics(self.core.metrics.registry)
            if journal.state:
                # a reopened journal already holds request ids: this
                # engine's start past them, or the ledger would alias a
                # new request with a dead run's
                self.core.scheduler.start_ids(max(journal.state) + 1)
        self._requests = {}

    # -------------------------------------------------------- submission
    def submit(self, prompt, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               stream: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               priority: str = "interactive",
               allowed_tokens: Optional[Sequence[int]] = None, *,
               plan_start: Optional[int] = None) -> int:
        """Queue one request; returns its id (admission happens inside a
        later ``step()``).

        ``stream`` is called as ``stream(request, token)`` the moment
        each token is harvested.  Everything knowable at submit time is
        validated here (``ValueError``); backpressure raises
        :class:`RequestRejected` with a retry-after hint.
        ``deadline_s``/``ttft_deadline_s`` are seconds relative to this
        call, checked every step.  ``allowed_tokens`` constrains decoding
        to a token set through a per-slot vocab mask.

        ``plan_start`` is for the fleet router's regenerations (failover,
        hedge, recovery): the first attempt's radix hit.  The match is
        capped there, rows below it this engine lacks prefill first, and
        the rows from it on run in the first attempt's chunks, so a 16-bit
        prefill regenerates the first attempt's tokens."""
        if self.core.closed:
            raise RuntimeError("engine is closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError(
                "prompt is empty — at least one token is required")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        max_seq = self.core.pool.max_seq
        if prompt.size + max_new_tokens > max_seq:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} exceeds the pool max_seq {max_seq} — "
                f"the request could never be placed; truncate the "
                f"prompt or lower max_new_tokens")
        for name, d in (("deadline_s", deadline_s),
                        ("ttft_deadline_s", ttft_deadline_s)):
            if d is not None and d < 0:
                raise ValueError(f"{name} must be >= 0, got {d}")
        sampling = sampling or SamplingParams()
        sampling.validate()
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        if allowed_tokens is not None:
            allowed_tokens = np.unique(
                np.asarray(allowed_tokens, np.int64).reshape(-1))
            if allowed_tokens.size < 1:
                raise ValueError(
                    "allowed_tokens is empty — an unsatisfiable "
                    "constraint can never emit a token; pass None for "
                    "unconstrained decoding")
            vocab = int(self.core.model.cfg.vocab_size)
            lo, hi = int(allowed_tokens[0]), int(allowed_tokens[-1])
            if lo < 0 or hi >= vocab:
                raise ValueError(
                    f"allowed_tokens must lie in [0, {vocab}) — got "
                    f"range [{lo}, {hi}]")
        if plan_start is not None:
            self.core.check_plan_start(plan_start, prompt.size)
        sched = self.core.scheduler
        req = Request(request_id=sched.next_request_id(),
                      prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling,
                      eos_token_id=eos_token_id, stream=stream,
                      priority=priority,
                      deadline_s=deadline_s,
                      ttft_deadline_s=ttft_deadline_s,
                      allowed_tokens=allowed_tokens,
                      plan_start=plan_start)
        try:
            self.core.check_admission(req)
        except RequestRejected as e:
            e.output = RequestOutput(
                request_id=req.request_id, prompt=req.prompt, tokens=[],
                finished=True, finish_reason=None, ttft_s=None,
                status="rejected", status_reason=e.reason)
            raise
        sched.submit(req)
        self._requests[req.request_id] = req
        self.core.metrics.on_submit()
        if self.core.journal is not None:
            # journaled only after acceptance: a rejected submission raised
            # above and owes the ledger nothing
            self.core.journal.append_submit(
                req.request_id, req.prompt, max_new_tokens,
                sampling=dataclasses.asdict(sampling),
                eos_token_id=eos_token_id, deadline_s=deadline_s,
                ttft_deadline_s=ttft_deadline_s, priority=priority)
        return req.request_id

    def cancel(self, request_id: int) -> RequestOutput:
        """Unwind one request in any state, freeing its slot, staging
        rows and radix pin at once; returns the terminal view
        (idempotent)."""
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(
                f"unknown request_id {request_id} — never submitted to "
                f"this engine, or already purged")
        if not req.finished:
            self.core.cancel(request_id)
        return self.result(request_id)

    # -------------------------------------------------------- execution
    def step(self) -> int:
        """One engine iteration (admit -> prefill -> decode ->
        harvest/evict); returns the number of requests still in flight."""
        return self.core.step()

    def stream(self, request_id: int) -> Iterator[int]:
        """Yield ``request_id``'s tokens as they are generated, stepping
        the engine whenever the request has no unseen tokens yet."""
        req = self._requests[request_id]
        seen = 0
        while True:
            while seen < len(req.tokens):
                yield req.tokens[seen]
                seen += 1
            if req.finished:
                return
            self.core.step()

    def run_until_complete(self, max_steps: Optional[int] = None,
                           stall_steps: Optional[int] = 64) -> int:
        return self.core.run_until_complete(max_steps,
                                            stall_steps=stall_steps)

    # ----------------------------------------------------------- results
    def result(self, request_id: int) -> RequestOutput:
        req = self._requests[request_id]
        ttft = None
        if req.first_token_time is not None:
            ttft = req.first_token_time - req.arrival_time
        return RequestOutput(request_id=req.request_id, prompt=req.prompt,
                             tokens=list(req.tokens), finished=req.finished,
                             finish_reason=req.finish_reason, ttft_s=ttft,
                             prefix_hit_tokens=req.prefix_hit_tokens,
                             status=req.status,
                             status_reason=req.status_reason)

    def purge(self, request_id: int) -> RequestOutput:
        """``result()`` + drop the engine's reference to the request
        (cancelling it first if it is still in flight).  Long-running
        servers consume results this way."""
        req = self._requests[request_id]
        if not req.finished:
            self.core.cancel(request_id, reason="purged while in flight")
        out = self.result(request_id)
        del self._requests[request_id]
        return out

    def serve_batch(self, prompts: Sequence, max_new_tokens: int = 16,
                    sampling: Optional[SamplingParams] = None,
                    eos_token_id: Optional[int] = None,
                    max_steps: Optional[int] = None) -> List[RequestOutput]:
        """Submit every prompt, run to completion, return the (purged)
        outputs in submission order.  A shared ``sampling`` spec is
        copied per request with the seed offset by the prompt index."""
        ids = [self.submit(p, max_new_tokens=max_new_tokens,
                           sampling=dataclasses.replace(
                               sampling, seed=sampling.seed + i)
                           if sampling is not None else None,
                           eos_token_id=eos_token_id)
               for i, p in enumerate(prompts)]
        self.run_until_complete(max_steps)
        return [self.purge(i) for i in ids]

    def prefix_probe(self, prompt) -> int:
        """Longest radix-cached prefix of ``prompt`` in tokens, WITHOUT
        admitting or pinning anything (0 when the cache is off or
        cold)."""
        return self.core.prefix_probe(prompt)

    # ----------------------------------------------------------- metrics
    @property
    def metrics(self) -> ServingMetrics:
        return self.core.metrics

    @property
    def registry(self):
        """The engine's ``obs.MetricsRegistry``."""
        return self.core.metrics.registry

    @property
    def tracer(self):
        """The engine's ``obs.Tracer`` (request-lifecycle spans and the
        event log)."""
        return self.core.metrics.tracer

    @property
    def decode_path(self) -> str:
        """``"fused"`` (the decode-block kernel pair) or ``"unfused"``
        (``model.decode_step``) at tp 1; ``"tp_fused_block"`` (the sharded
        decode-block kernels), ``"tp_fused"`` (the composed ring) or
        ``"unfused"`` (the Megatron body) at tp > 1: which decode step
        this engine runs, resolved once at construction."""
        return self.core.decode_path

    @property
    def decode_fallback_reason(self) -> Optional[str]:
        """Why ``fused_decode=True`` fell back from the fused decode-block
        path (None when it is active or the flag is off)."""
        return self.core.decode_fallback_reason

    @property
    def decode_graph_reason(self) -> Optional[str]:
        """Why this engine's decode step is not captured as one CUDA graph
        (None when it is: every decode step after the first replays it):
        ``"cpu"`` for a CPU engine, or the reason a mesh cannot be captured
        (its shards span several CUDA devices)."""
        return self.core.decode_graph_reason

    @property
    def prefill_graph_reason(self) -> Optional[str]:
        """Why this engine's prefill chunks are not captured as CUDA graphs,
        one per chunk width (None when they are: every later chunk of a
        width replays its graph); the same rule as
        ``decode_graph_reason``."""
        return self.core.prefill_graph_reason

    @property
    def tensor_parallel(self) -> int:
        """The engine's tensor-parallel mesh degree (1 = one device)."""
        return self.core.tensor_parallel

    @property
    def tp_fusion_reason(self) -> Optional[str]:
        """Why a tp > 1 engine fell back from the ring decode programs
        (``tp_fused_block`` / ``tp_fused``) to the composed ``unfused``
        path (None when a ring program is active or the engine has one
        shard)."""
        return self.core.tp_fusion_reason

    @property
    def spec_k(self) -> int:
        """The requested speculative draft length (0 = speculation off);
        ``spec_on`` / ``spec_fallback_reason`` report what the engine
        resolved."""
        return self.core.spec_k

    @property
    def spec_on(self) -> bool:
        """Is speculative decoding active: requested (``spec_k > 0``),
        resolved viable at construction, and not bypassed since."""
        return self.core.spec_on and not self.core.spec_bypass

    @property
    def spec_fallback_reason(self) -> Optional[str]:
        """Why speculation is off (None while it is on)."""
        return self.core.spec_fallback_reason

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        """Accepted / drafted over the current metrics window (None before
        the first speculative step)."""
        return self.core.metrics.spec_acceptance_rate

    @property
    def aot_status(self) -> Optional[str]:
        """How the attached AOT store went: ``"warm"`` (every leg
        attached: its libraries installed and, on a card, its graph
        captured), ``"partial"`` / ``"empty"`` (some / no leg; the rest
        capture at first use), ``"skew"`` (the store was built for another
        configuration: nothing attached), None without a store."""
        return self.core.aot_status

    @property
    def health(self):
        """The engine's :class:`~paddle_tpu_torch.serving.health.
        EngineHealth` state machine (``.state`` is ``healthy | degraded |
        quarantined | circuit_open``)."""
        return self.core.health

    @property
    def degraded_subsystems(self):
        """The optional subsystems the degradation ladder has disabled (a
        subset of ``("prefix_cache", "chunked_prefill", "fused_decode",
        "spec_verify")``; empty = full service)."""
        return self.core.ladder.disabled_subsystems

    def metrics_dict(self) -> dict:
        out = self.core.metrics.snapshot()
        if self.core.prefix_cache is not None:
            # lifetime radix-cache state; survives metrics.reset()
            out["prefix_cache"] = self.core.prefix_cache.stats()
        out["slot_churn"] = {"allocs": self.core.pool.alloc_count,
                             "frees": self.core.pool.free_count}
        return out

    def close(self) -> None:
        """Release the engine's device memory (KV slabs, staging lane,
        graphs) and detach its telemetry from the profiler's export
        sources (``record_events``); results already produced stay
        readable, new work is refused."""
        self.core.close()
        self.core.metrics.close()
