"""Continuous-batching engine core: the fixed-shape step loop
(counterpart of paddle_tpu/serving/engine.py).

``tensor_parallel > 1`` shards the whole device plane over a 1-D mesh
(serving/tp.py): the model's weights Megatron-style, the KV slot and
block slabs and the staging lane on the kv-head axis.  Prefill chunks
run the per-shard Megatron body; the decode step takes the sharded
decode-block kernels (``tp_fused_block``), the composed ring
(``tp_fused``) or the Megatron body (``unfused``).

Device work per step:

  * ``prefill`` — one ``model.decode_step`` per CHUNK: ``[1, width]``
    tokens appended into the engine's ONE ``[1, max_seq]`` staging lane
    at the chunk's offset; the last VALID token's logits seed sampling.
    Only the head of the prefill queue runs chunks, and it runs to
    completion before the next request starts, so one lane serves every
    request (the reference allocates and donates rows per request).
    Width comes from the scheduler's chunk plan: without
    ``prefill_chunk``, one pow2-bucketed chunk covers the whole uncached
    suffix; with it, long suffixes run as fixed-width pieces, one chunk
    per step, interleaved with decode.  Padding rows of a chunk write
    their K/V past ``valid`` in the staging lane and their queries mask
    by the padded width — exactly as in the reference;
  * ``block copy`` — the radix prefix cache's gather (matched prefix
    blocks, pinned at admission, into the lane when the request heads
    the prefill queue; a request with no hit starts from a zeroed lane)
    and scatter (freshly computed blocks out of the slot after prefill).
    A cache-hit request prefills ONLY its suffix;
  * ``decode`` — ONE ``[num_slots, 1]`` step over the whole pool with
    per-slot positions.  Free and mid-prefill slots ride along as
    no-ops: their rows decode garbage nothing reads, every row's
    position advances by one, and a free row's write lands clamped at
    its row end (models/kv_cache.py) until the next adopt overwrites the
    row wholesale;
  * ``verify`` (speculative decoding, ``spec_k > 0``) — in place of a
    decode step when some slot's n-gram table (serving/spec.py) proposes
    a draft: ONE ``[num_slots, spec_k+1]`` forward over every slot's
    window (its last token, then its draft) at its own position, into an
    f32 ``[num_slots, spec_k+1, vocab]`` logits buffer.  Matched sampling
    then draws each window position as sequential decode would, accepts
    the longest draft prefix the draws reproduce, and advances each row
    by its accepted length + 1.

The compiled-program plane: the reference compiles ONE decode program,
one prefill program per chunk width (``warm_buckets``) and, with
``spec_k``, ONE verify program.  On a single CUDA device the engine
captures its decode step as one CUDA graph at its first decode step, its
prefill chunk as one CUDA graph per width at the first chunk of that
width and its verify step as one CUDA graph at its first verify step,
and replays them after.  Each captured body reads and writes only
buffers whose addresses never change: decode the KV slabs,
``pool.seq_pos`` advanced in place, the last-token vector and a
``[num_slots, vocab]`` f32 logits buffer; prefill the staging lane, a
``[1, max_width]`` ids buffer, ``[1]`` offset and valid-count tensors
(filled from pinned host memory before each replay) and an f32
``[vocab]`` last-logits buffer; verify the slabs (the window's rows;
``seq_pos`` is read, not advanced), the last-token vector, a
``[num_slots, spec_k+1]`` drafts-and-lengths buffer (filled from pinned
host memory) and the f32 window logits.  Every graph keeps its temporaries in
the engine's one graph memory pool; none holds a live output there, and
the graphs run one at a time, so they share it in any order.  Sampling
and the radix copies stay eager, so each request keeps its own
``torch.Generator``.  ``capture_counts`` (the reference's
``trace_counts``, same keys) counts captures, each reported as a
``compile`` event and in ``serving.compiles``.  CPU engines and meshes
over several CUDA devices run the same bodies eagerly;
``decode_graph_reason`` / ``prefill_graph_reason`` say why.

Host plane: ONE device->host readback per step phase — the decode
harvest reads the sampled token vector once, and a step that completes
prefills reads their batched first tokens once.  Admission, radix
matching, eviction, eos/length bookkeeping and metrics run on host ints
the engine already holds.

Sampling: greedy rows take the argmax; sampling rows apply
``temperature -> top_k -> top_p`` and draw from the request's OWN
``torch.Generator`` (seeded from ``SamplingParams.seed``) in token order,
the discipline of ``models.generation.generate`` — so a single-request
engine run reproduces the port's ``generate(seed=...)``, sampling
included.  A verify step draws every window position in order and
snapshots each generator after each draw; once the accepted lengths are
read back it restores the state after draw ``accepted + 1``, the draws
sequential decode would have made, so speculative and sequential runs
emit the same seeded tokens.  A ``torch.Generator`` does not reproduce
``jax.random`` streams, so seeded tokens differ from the JAX engine's by
design.

Fault tolerance (``fault_tolerance=FaultToleranceConfig(...)``,
serving/health.py): ``step()`` becomes the watchdog boundary.  A step
that raises is attributed and never propagates: a fault of an optional
subsystem (the prefix cache, chunked prefill, the fused decode path,
speculation) counts toward the degradation ladder, which disables it at
its threshold; any other fault costs one backed-off retry, and a spent
retry budget quarantines the engine: in-flight requests fail, the device
plane is rebuilt, queued requests are served on the new one.  A prefill
fault fails only its request; a radix-cache fault degrades that request
to a miss.  Too many quarantines open the circuit: everything queued
fails and ``submit`` rejects with ``circuit_open``.  The rebuild frees
before it allocates: the graphs and their pool, then the slabs, the
block slab, the staging lane and the I/O buffers, then the new plane,
whose graphs are captured again at first use (``capture_counts`` keeps
counting).  ``faults=FaultInjector()`` (serving/faults.py) arms named
injection points in the engine, the pools and the prefix cache.  Without
a config the engine raises as before.

Durability (``journal=Journal.open(dir)``, serving/journal.py): the
engine writes one batched ``progress`` record of the delivered marks at
the end of each step and exactly one ``terminal`` record a request, in
``_finalize`` (the ``submit`` record is the facade's, after acceptance).
The journal is host code; nothing it does touches the device.

The AOT store (``aot_store=AOTStore.open(dir)``, serving/aot.py): the
engine attaches it at construction and again at the end of each
quarantine's rebuild, before any request.  A store whose fingerprint
matches installs the kernel libraries of every leg (so a host with no
``nvcc`` builds nothing) and, where the engine captures graphs (one
card), captures every leg's graph there and then: each committed prefill width, the decode step and, with
speculation, the verify step, each from an eager run of its body on the
plane's own buffers, after which the plane's state is put back as a
fresh plane has it.  Attach captures count in ``aot.loads`` /
``aot.load_s``, not in ``capture_counts``: with a warm store no capture
lands on a request.  A skewed store, an absent leg or a leg whose read
fails leaves that leg to capture at first use, with an ``aot_miss`` /
``aot_fallback`` event; a failed install or capture raises.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..kernels.decode_block import resolve_fused_decode
from ..models.generation import _categorical, _filter_top_p
from ..models.gpt import check_weights_held
from ..profiler import RecordEvent
from .aot import (AOTStoreError, aot_fingerprint, engine_aot_context,
                  engine_legs)
from .errors import EngineStalledError, RequestRejected
from .health import DegradationLadder, EngineHealth, FaultToleranceConfig
from .kv_pool import BlockPool, KVPool
from .metrics import ServingMetrics
from .prefix_cache import MatchResult, PrefixCache
from .scheduler import Request, Scheduler
from .spec import NGramDraftTable
from .tp import (build_serving_mesh, build_tp_decode_program,
                 build_tp_forward, build_tp_verify_program, init_staging,
                 shard_model_params, tp_decode_supported)

__all__ = ["EngineCore", "sample_rows", "finite_or_sentinel",
           "NONFINITE_SENTINEL"]

# one side stream per CUDA device captures and replays every engine's
# decode graph.  The kernels keep their workspaces per (device, stream), so
# the engines of one device share one set, and the graphs, each joined to
# the current stream on both sides, never run beside other work
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


# token-readback encoding of the per-row logits health check: a row whose
# logits hold a non-finite value reads back as this instead of a token id
# (ids are >= 0), so detection rides the step's existing readback
NONFINITE_SENTINEL = -1


def finite_or_sentinel(logits: torch.Tensor,
                       toks: torch.Tensor) -> torch.Tensor:
    """``toks[r]`` where ``logits[r]`` is all-finite, else
    :data:`NONFINITE_SENTINEL`."""
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, toks, torch.full_like(toks, NONFINITE_SENTINEL))


def _filter_top_k_rows(logits: torch.Tensor, top_k) -> torch.Tensor:
    """Per-row top-k: keep each row's ``top_k[r]`` highest logits
    (``top_k[r] == 0`` keeps the whole row).  Rank masking — the stable
    argsort of the stable descending argsort — resolves ties by vocab
    order, as the reference does."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    k = torch.as_tensor(np.asarray(top_k), dtype=torch.long,
                        device=logits.device)[:, None]
    keep = (rank < k) | (k <= 0)
    return logits.masked_fill(~keep, float("-inf"))


def sample_rows(generators: Sequence[Optional[torch.Generator]],
                logits: torch.Tensor, do_sample, temperature, top_k, top_p,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row token selection over ``logits [rows, vocab]`` (f32).

    ``do_sample``, ``temperature``, ``top_k`` and ``top_p`` are per-row
    HOST values (sequences or numpy arrays).  Greedy rows take the argmax;
    sampling rows apply ``temperature -> top_k -> top_p`` (the pipeline of
    ``generate``) and draw from their own ``generators[r]``, so one
    request's randomness never depends on its slot neighbours.  ``mask
    [rows, vocab] bool`` (constrained decoding) bans False columns before
    everything."""
    logits = logits.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    out = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(np.asarray(do_sample, bool))
    if rows.size:
        dev = logits.device
        idx = torch.as_tensor(rows, device=dev)
        temp = torch.as_tensor(np.asarray(temperature, np.float32)[rows],
                               device=dev).clamp_min(1e-6)
        scaled = logits[idx] / temp[:, None]
        filtered = _filter_top_k_rows(scaled, np.asarray(top_k)[rows])
        p = torch.as_tensor(np.asarray(top_p, np.float32)[rows],
                            device=dev)[:, None]
        # rows with top_p == 1.0 skip the nucleus filter exactly
        filtered = torch.where(p >= 1.0, filtered,
                               _filter_top_p(filtered, p))
        for j, r in enumerate(rows):
            out[r] = _categorical(filtered[j:j + 1], generators[r])[0]
    return out


class _Slot:
    """Host mirror of one occupied pool slot."""

    __slots__ = ("req", "pos", "match", "draft", "allowed")

    def __init__(self, req: Request, prompt_len: int,
                 match: Optional[MatchResult] = None,
                 draft: Optional[NGramDraftTable] = None,
                 allowed: Optional[frozenset] = None):
        self.req = req
        self.pos = prompt_len       # cache length == next write offset
        self.match = match          # pinned radix-cache path, if any
        self.draft = draft          # the request's n-gram table (spec)
        self.allowed = allowed      # allowed token ids (constrained)


class _Prefill:
    """A request mid-prefill: its slot is allocated, its radix match
    pinned, and the scheduler's chunk plan drives one decode_step append
    per chunk into the engine's staging lane once it heads the queue."""

    __slots__ = ("req", "slot", "plan", "next_chunk", "match")

    def __init__(self, req: Request, slot: int, plan,
                 match: Optional[MatchResult]):
        self.req = req
        self.slot = slot
        self.plan = plan            # [(offset, width, valid), ...]
        self.next_chunk = 0
        self.match = match

    @property
    def done(self) -> bool:
        return self.next_chunk >= len(self.plan)


class EngineCore:
    """Owns the pool, the radix prefix cache, the per-slot device state
    and the step loop, on the model's device.  The public request surface
    lives in ``serving.api.ServingEngine``."""

    def __init__(self, model, num_slots: int = 8,
                 max_seq: Optional[int] = None,
                 min_bucket: int = 16,
                 max_prefills_per_step: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 block_len: int = 16,
                 prefix_blocks: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None,
                 fused_decode: bool = False,
                 tensor_parallel: int = 1,
                 collective_fusion: bool = True,
                 devices=None,
                 spec_k: int = 0,
                 fault_tolerance: Optional[FaultToleranceConfig] = None,
                 faults=None,
                 journal=None,
                 aot_store=None):
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if prefill_chunk is not None and prefill_chunk < min_bucket:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= min_bucket "
                f"{min_bucket}")
        if max_prefill_tokens_per_step is not None \
                and max_prefill_tokens_per_step < 1:
            raise ValueError("max_prefill_tokens_per_step must be >= 1")
        if enable_prefix_cache and block_len < 1:
            raise ValueError("block_len must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self.metrics = metrics or ServingMetrics()
        # the watchdog (serving/health.py) engages only with an explicit
        # config; the injector (serving/faults.py) reaches the pools and
        # the prefix cache through _build_device_plane
        self.faults = faults
        self.fault_tolerant = fault_tolerance is not None
        self.ft = fault_tolerance if fault_tolerance is not None \
            else FaultToleranceConfig()
        self.health = EngineHealth(self.ft)
        self.ladder = DegradationLadder(self.ft.ladder_threshold)
        self.prefix_bypass = False              # ladder: cache disabled
        self._fault_phase: Optional[str] = None  # watchdog attribution
        self.max_queue = max_queue if max_queue is not None \
            else self.ft.max_queue
        # the durable request journal (serving/journal.py) and the
        # delivered marks it last recorded per live request
        self.journal = journal
        self._journal_hwm: Dict[int, int] = {}
        # the AOT store (serving/aot.py): attached at the end of
        # construction and of each rebuild; aot_status says how that went
        # ("warm" | "partial" | "empty" | "skew", None without a store)
        self.aot_store = aot_store
        self.aot_status: Optional[str] = None
        self._aot_context = None
        # speculative decoding: spec_k > 0 arms per-slot n-gram drafts
        # (serving/spec.py) checked by ONE [num_slots, spec_k+1] verify
        # step; spec_on / spec_fallback_reason resolve with the decode
        # path, and spec_bypass is the run-time kill switch the
        # degradation ladder's spec_verify rung sets
        self.spec_k = spec_k
        self.spec_on = False
        self.spec_fallback_reason: Optional[str] = None
        self.spec_bypass = False
        # monotone work marker: tokens emitted, admissions, prefill
        # chunks and terminal dispositions all bump it — the
        # run_until_complete stall detector watches it flatline
        self.progress_counter = 0
        self._deadlines_possible = False        # skip the per-step scan
        self._step_index = 0
        self._step_in_flight = 0
        self.closed = False
        # the compiled-program plane: captures per step program (the
        # reference's trace_counts) and the host seconds they took, the
        # baseline _record_events diffs against, the decode steps,
        # prefill chunks and verify steps whose body ran eagerly (every
        # one where the graph reason is set, else each capture's
        # warm-up), the graphs (one decode, one prefill per chunk width,
        # one verify), each width's capture seconds, and the memory pool
        # every graph of the engine shares
        self.capture_counts = {"prefill": 0, "decode": 0, "verify": 0}
        self.capture_seconds = dict.fromkeys(self.capture_counts, 0.0)
        self._compile_seen = dict(self.capture_counts)
        self.eager_decode_steps = 0
        self.eager_prefill_chunks = 0
        self.eager_verify_steps = 0
        self._decode_graph = None
        self._verify_graph = None
        self._prefill_graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        self.prefill_capture_seconds: Dict[int, float] = {}
        self._graph_pool = None
        # ---- tensor-parallel serving (serving/tp.py): tp > 1 shards the
        # whole device plane over a 1-D mesh of `devices` (the first tp
        # CUDA devices by default).  Every construction check runs BEFORE
        # shard_model_params re-lays the caller's model in place
        if tensor_parallel < 1:
            raise ValueError(
                f"tensor_parallel must be >= 1, got {tensor_parallel}")
        self.tensor_parallel = tensor_parallel
        self.collective_fusion = collective_fusion
        self.mesh = None
        self.tp_weights = None
        self.tp_fusion_reason: Optional[str] = None
        self._forward = model.decode_step
        if tensor_parallel == 1:
            check_weights_held(model, "ServingEngine(tensor_parallel=1)")
        else:
            cfg = model.cfg
            kv_heads = getattr(cfg, "kv_heads", None) or cfg.num_heads
            if kv_heads % tensor_parallel:
                raise ValueError(
                    f"kv_heads {kv_heads} must divide evenly over "
                    f"tensor_parallel {tensor_parallel} (the KV slot "
                    f"slabs partition on the kv-head axis)")
            if not hasattr(model, "tp_decode_weights"):
                raise ValueError(
                    f"tensor_parallel={tensor_parallel}: the model has no "
                    f"tp_decode_weights (every tensor-parallel program "
                    f"runs on its sharded bundle)")
            ok, why = model.tp_decode_supported(tensor_parallel)
            if not ok:
                raise ValueError(
                    f"tensor_parallel={tensor_parallel}: {why} (every "
                    f"tensor-parallel program runs on the sharded bundle)")
            self.mesh = build_serving_mesh(tensor_parallel, devices)
            self.tp_weights = shard_model_params(model, self.mesh)
            self.device = self.mesh.devices[0]
            self._forward = build_tp_forward(self.tp_weights)
        self.metrics.set_tp_degree(tensor_parallel)
        # the device plane's construction arguments, kept so that a
        # quarantine builds it again the same way
        self._max_seq_arg = max_seq
        self._enable_prefix_cache = enable_prefix_cache
        self._block_len_arg = block_len
        self._prefix_blocks_arg = prefix_blocks
        self._build_device_plane()
        self.scheduler = Scheduler(num_slots, self.pool.max_seq,
                                   min_bucket=min_bucket,
                                   max_prefills_per_step=max_prefills_per_step)
        # the committed prefill widths, pinned once (the reference's
        # :426): every chunk plan's width lies in it, and the prefill
        # graphs are drawn from it
        self._warm_buckets = frozenset(self.warm_buckets())
        self._build_prefill_buffers()
        # fused decode-block path (kernels/decode_block.py,
        # kernels/decode_block_tp.py): opt-in, resolved once here from
        # static legality (shapes, dtype, shared memory plan) and reported
        # once as the decode_block event
        self.fused_decode = fused_decode
        self.decode_path, self.decode_fallback_reason = \
            self._resolve_decode_path()
        self._tp_program = None
        if self.decode_path in ("tp_fused", "tp_fused_block"):
            self._tp_program = build_tp_decode_program(
                self.tp_weights,
                pallas_block=self.decode_path == "tp_fused_block",
                batch=self.num_slots, max_seq=self.pool.max_seq)
        self._tp_verify_program = None
        if self.spec_on:
            self._build_verify_buffers()
            if self.decode_path in ("tp_fused", "tp_fused_block"):
                self._tp_verify_program = build_tp_verify_program(
                    self.tp_weights, width=self.spec_k + 1)
        self.metrics.on_decode_block(
            active=self.decode_path in ("fused", "tp_fused_block"),
            reason=self.decode_fallback_reason, step=self._step_index,
            tp=tensor_parallel)
        # one rule for both planes: why nothing is captured (None: it is)
        self.decode_graph_reason = self.prefill_graph_reason = \
            self._resolve_decode_graph()
        if aot_store is not None:
            # the engine as constructed: a rebuild attaches against it
            self._aot_context = engine_aot_context(self)
            self._attach_aot()

    def _build_device_plane(self) -> None:
        """Allocate everything that lives on the device or mirrors it: the
        KV pools, the prefix cache, the staging lane and the per-slot row
        state (at construction, and again at each quarantine).  Once the
        ladder has bypassed the prefix cache no block slab is built:
        nothing would read or write it again."""
        model, num_slots = self.model, self.num_slots
        self.pool = KVPool.create(model, num_slots, self._max_seq_arg,
                                  mesh=self.mesh)
        self.pool.faults = self.faults
        self.prefix_cache: Optional[PrefixCache] = None
        self.block_pool: Optional[BlockPool] = None
        if self._enable_prefix_cache and not self.prefix_bypass:
            # block_len must tile the slot row: round DOWN to a pow2, then
            # halve until it divides max_seq
            block_len = 1 << (self._block_len_arg.bit_length() - 1)
            while block_len > 1 and self.pool.max_seq % block_len:
                block_len //= 2
            # default pool size: as many blocks as the slot pool has rows
            # of context — a second slab the size of the first
            nb = self._prefix_blocks_arg \
                if self._prefix_blocks_arg is not None else \
                num_slots * (self.pool.max_seq // block_len)
            self.block_pool = BlockPool.create(model, nb, block_len,
                                               self.pool.max_seq,
                                               mesh=self.mesh)
            self.block_pool.faults = self.faults
            self.prefix_cache = PrefixCache(self.block_pool)
            self.prefix_cache.faults = self.faults
            self.prefix_cache.on_event = functools.partial(
                self.metrics.tracer.event, lane=self.metrics.engine_lane)
        self._slots: Dict[int, _Slot] = {}
        self._prefills: List[_Prefill] = []      # FCFS, mid-prefill
        # the ONE staging lane every prefill appends into: per layer
        # [1, max_seq, kv_heads, head_dim] k and v (per-shard lists under
        # a mesh), copied into the request's slot at adopt
        if self.mesh is not None:
            self._lane_ks, self._lane_vs = init_staging(self.tp_weights,
                                                        self.pool.max_seq)
        else:
            caches = model.init_cache(1, self.pool.max_seq)
            self._lane_ks = [c[0] for c in caches]
            self._lane_vs = [c[1] for c in caches]
        # per-slot device row state (fixed [num_slots] shapes)
        self._last_tok = torch.zeros((num_slots,), dtype=torch.int32,
                                     device=self.device)
        # the decode step's logits, written in place every step (the
        # captured graph's output)
        self._logits = torch.zeros((num_slots, int(model.cfg.vocab_size)),
                                   dtype=torch.float32, device=self.device)
        self._gens: List[Optional[torch.Generator]] = [None] * num_slots
        # per-slot sampling params: host mirrors (sample_rows reads them
        # on the host; only sampling rows touch the device)
        self._do_sample = np.zeros((num_slots,), bool)
        self._temperature = np.ones((num_slots,), np.float32)
        self._top_k = np.zeros((num_slots,), np.int32)
        self._top_p = np.ones((num_slots,), np.float32)
        # per-slot allowed-token mask (constrained decoding): host rows,
        # uploaded when dirtied; None on the device while every row is
        # unconstrained
        self._mask_host = np.ones(
            (num_slots, int(model.cfg.vocab_size)), bool)
        self._mask_dev: Optional[torch.Tensor] = None
        self._mask_dirty = False

    def _build_prefill_buffers(self) -> None:
        """The prefill body's fixed inputs and output: ONE int64 device
        buffer holding the chunk's ``[1]`` offset, its ``[1]`` valid
        count and ``[1, max_width]`` token ids (so one host->device copy
        fills all three), and the f32 ``[vocab]`` logits of the last
        valid token."""
        width = max(self._warm_buckets)
        self._prefill_io = torch.zeros((2 + width,), dtype=torch.int64,
                                       device=self.device)
        self._prefill_off = self._prefill_io[0:1]
        self._prefill_valid = self._prefill_io[1:2]
        self._prefill_ids = self._prefill_io[2:].view(1, width)
        self._prefill_logits = torch.zeros(
            (int(self.model.cfg.vocab_size),), dtype=torch.float32,
            device=self.device)

    def _build_verify_buffers(self) -> None:
        """The verify body's fixed inputs and output: an int64 ``[num_slots,
        spec_k+1]`` buffer of each slot's draft (zero-padded) and, in the
        last column, its length (one host->device copy fills it); the
        ``[num_slots, spec_k+1]`` window ids the body assembles from the
        last-token vector and the drafts; the f32 ``[num_slots,
        spec_k+1, vocab]`` window logits."""
        width = self.spec_k + 1
        self._verify_io = torch.zeros((self.num_slots, width),
                                      dtype=torch.int64, device=self.device)
        self._verify_ids = torch.zeros_like(self._verify_io)
        self._verify_logits = torch.zeros(
            (self.num_slots, width, int(self.model.cfg.vocab_size)),
            dtype=torch.float32, device=self.device)

    def warm_buckets(self) -> Tuple[int, ...]:
        """The committed prefill chunk-width set (the reference's
        ``warm_buckets``, same enumeration): every width
        ``Scheduler.chunk_plan`` can emit for this configuration, over
        every reachable plan start (0, any block-aligned radix-cache
        match, and each chunk-stride position past those), for both the
        chunked rung and the chunking-disabled one of the reference's
        degradation ladder.  The engine pins it at construction; its
        prefill graphs are drawn from it, at most one per width."""
        max_seq = self.pool.max_seq
        mb = max(self.scheduler.min_bucket, 1)
        chunk = self.prefill_chunk
        starts = {0}
        if self.block_pool is not None:
            starts.update(range(0, max_seq, self.block_pool.block_len))
        positions = set(starts)
        if chunk is not None:
            for s in starts:
                positions.update(range(s, max_seq, chunk))
        widths = set()
        for pos in positions:
            cap = max_seq - pos
            if cap < 1:
                continue
            # bucket_length values are {mb * 2^k} capped at the row
            # remainder: the ladder once per start
            b = mb
            while True:
                widths.add(min(b, cap))
                if chunk is not None:
                    widths.add(min(b, cap, chunk))
                if b >= cap:
                    break
                b *= 2
        if chunk is not None:
            widths.add(chunk)
        return tuple(sorted(widths))

    def close(self) -> None:
        """Drop the engine's graphs and device buffers (KV slabs, staging
        lane, row state) so their memory can be reused; the engine serves
        nothing afterwards."""
        self._drop_graphs(prefill=True)
        self._prefills = []
        self._release_device_plane()
        self.closed = True

    def _drop_graphs(self, prefill: bool) -> None:
        """Forget the decode and verify graphs, and with ``prefill`` the
        prefill graphs and the memory pool they all share, once no replay
        is left in flight on the card; each is captured again at its next
        use."""
        if self.decode_graph_reason is None:
            torch.cuda.synchronize(self.device)
        self._decode_graph = None
        self._verify_graph = None
        if prefill:
            self._prefill_graphs = {}
            self._graph_pool = None

    def _release_device_plane(self) -> None:
        """Drop every device buffer of the plane: the slot slabs, the block
        slab, the staging lane, the logits, the mask and the prefill and
        verify I/O buffers (the graphs that read them are dropped first)."""
        self._lane_ks = self._lane_vs = []
        self.pool.ks = self.pool.vs = []
        if self.block_pool is not None:
            self.block_pool.bks = self.block_pool.bvs = []
        self._logits = self._mask_dev = None
        self._prefill_io = self._prefill_off = self._prefill_valid = None
        self._prefill_ids = self._prefill_logits = None
        self._verify_io = self._verify_ids = self._verify_logits = None

    def _rebuild_device_plane(self) -> None:
        """The quarantine's rebuild, releasing before it allocates: at
        full width one plane (slot slabs, block slab, lane) is about as
        large as the weights, and two of them with the weights need more
        than the card holds.  The graphs and their pool go first, then the
        old plane; then the new plane and the I/O buffers, whose graphs
        are captured again at first use, or at once when an AOT store is
        attached.  The scheduler, the queue, the metrics, the health state
        and ``capture_counts`` stay."""
        self._drop_graphs(prefill=True)
        self._release_device_plane()
        self._build_device_plane()
        self._build_prefill_buffers()
        if self.spec_on:
            self._build_verify_buffers()
        if self.aot_store is not None:
            self._attach_aot()

    def _lane(self, req: Request) -> int:
        return self.metrics.request_lane(req.request_id)

    # ----------------------------------------------------------- prefill
    def _prefill_cost(self, req: Request) -> int:
        """Tokens of prefill work admitting ``req`` costs THIS step: the
        width of its first chunk, after the radix-cache match shrinks the
        suffix."""
        matched = self.prefix_cache.match_length(self._match_span(req)) \
            if self._cache_active else 0
        return self._plan(req, matched)[0][1]

    def _match_span(self, req: Request):
        """The prompt rows the radix match may cover: all of them, or up
        to a regeneration's plan start."""
        if req.plan_start is None:
            return req.prompt
        return req.prompt[:req.plan_start + 1]

    def _plan(self, req: Request, matched: int):
        """The chunk plan of ``req`` after a radix match of ``matched``
        rows.  A regeneration whose match stops short of its plan start
        first prefills ``[matched, start)``, then runs ``[start,
        prompt_len)`` in the first attempt's chunks."""
        start = req.plan_start
        if start is None or matched >= start:
            return self.scheduler.chunk_plan(matched, req.prompt_len,
                                             self.prefill_chunk)
        return (self.scheduler.chunk_plan(matched, start, self.prefill_chunk)
                + self.scheduler.chunk_plan(start, req.prompt_len,
                                            self.prefill_chunk))

    def check_plan_start(self, start: int, prompt_len: int) -> None:
        """A regeneration's plan start must lie in the prompt, on a radix
        block boundary (it is a radix hit): else its chunks could leave
        the committed width set."""
        block = self.block_pool.block_len if self.block_pool is not None \
            else None
        if not 0 <= start < prompt_len or (start and (
                block is None or start % block)):
            raise ValueError(
                f"plan_start {start} must be 0 or a multiple of this "
                f"engine's radix block length ({block}) below the prompt "
                f"length {prompt_len}")

    @property
    def _cache_active(self) -> bool:
        """The prefix cache exists and the ladder has not bypassed it."""
        return self.prefix_cache is not None and not self.prefix_bypass

    def prefix_probe(self, prompt) -> int:
        """Longest radix-cached prefix of ``prompt`` in tokens, without
        admitting, pinning, or touching the device (0 when the cache is
        off, bypassed by the degradation ladder, or cold)."""
        if not self._cache_active:
            return 0
        return self.prefix_cache.match_length(prompt)

    # ------------------------------------------------ fleet KV handoff
    # The disaggregated fleet (serving/router.py, serving/handoff.py)
    # moves a finished prompt's radix blocks from a prefill replica to a
    # decode replica through these halves.  Both are eager copies on the
    # current stream, like the radix cache's own: the handoff captures no
    # graph on either engine.

    def export_prompt_kv(self, prompt,
                         hit_tokens: int = 0) -> Optional[MatchResult]:
        """Prefill-side half: pin the cached block path of ``prompt``'s
        rows before the last prefill chunk this engine ran it with (the
        chunk plan from its radix hit ``hit_tokens``), so the transfer
        window cannot lose it to LRU eviction.  The decode replica then
        runs that last chunk again at the same offset and width, and the
        first token it regenerates is this engine's bit for bit: given
        every full block, it would run only the rows past them, at
        another width, and a 16-bit product of another shape can round
        another way and pick another first token than the one the client
        already has.  (Exact when ``prefill_chunk`` is a multiple of the
        block length; without chunking only ``hit_tokens`` move.)  Returns
        the pinned :class:`MatchResult` (``tokens == 0`` when nothing
        moves), or None when the cache is off or bypassed.  Hand it back
        to :meth:`release_export` on every path."""
        if not self._cache_active:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        start = self.scheduler.chunk_plan(hit_tokens, prompt.size,
                                          self.prefill_chunk)[-1][0]
        return self.prefix_cache.match(prompt[:start + 1], count_stats=False)

    def export_gather(self, match: MatchResult):
        """The pinned blocks' gather, for the destination to run:
        ``gather(ks, vs)`` copies them into the first ``match.tokens``
        positions of the given per-layer slot rows (``KVPool.slot_rows``
        of the destination's transient slot).  Nothing is copied or
        allocated until then: the port gathers straight into the
        destination's slot, where the reference fills fresh
        ``[1, max_seq]`` staging rows per transfer."""
        return functools.partial(self.block_pool.gather_blocks_into,
                                 list(match.blocks))

    def release_export(self, match: Optional[MatchResult]) -> None:
        """Unpin an export (idempotent).  After a quarantine without a
        prefix cache the pinned nodes belong to a discarded tree, and the
        release is a no-op."""
        if match is not None and self.prefix_cache is not None:
            self.prefix_cache.release(match)

    def adopt_prompt_kv(self, prompt, gather, tokens: int,
                        faults=None) -> int:
        """Decode-side half: land ``tokens`` transferred prompt tokens in
        THIS engine's radix cache.  ``gather`` (the source's
        :meth:`export_gather`) writes them into a transient pool slot,
        the scatter's source, which is freed on every path.  Returns the
        number of new blocks written (0: cache off or bypassed, or all
        of them cached here already).  Raises when no slot is free (the
        router defers on ``pool.free_slots``).  ``faults`` is the
        router's injector: ``handoff_scatter`` fires after the slot
        claim, before any block lands."""
        if not self._cache_active or tokens < self.block_pool.block_len:
            return 0
        if tokens > self.pool.max_seq:
            raise ValueError(
                f"{tokens} transferred tokens exceed this replica's max_seq "
                f"{self.pool.max_seq}")
        slot = self.pool.alloc()
        try:
            if faults is not None:
                faults.fire("handoff_scatter")
            gather(*self.pool.slot_rows(slot))
            return self.prefix_cache.insert(np.asarray(prompt)[:tokens],
                                            self.pool, slot)
        finally:
            self.pool.free(slot)

    def _contained_cache_fault(self, match: Optional[MatchResult],
                               exc: Exception) -> None:
        """A prefix-cache operation raised under the watchdog: unpin what
        was matched and count the fault toward the ladder (which bypasses
        the cache at its threshold); the caller goes on as a miss."""
        if match is not None:
            self.prefix_cache.release(match)
        self._subsystem_fault("prefix_cache", exc)

    def _begin_prefill(self, req: Request) -> None:
        """Claim a slot, match + pin the longest cached prefix, and queue
        the suffix's chunk plan.  No device work runs here: the pinned
        blocks are gathered into the staging lane when the request heads
        the prefill queue (``_load_lane``).  The slot and the pinned
        radix path go back to their pools if anything between claim and
        placement raises."""
        t_admit = time.perf_counter()
        slot = self.pool.alloc()
        match = None
        try:
            matched = 0
            t_match0 = t_match1 = t_admit
            if self._cache_active:
                t_match0 = time.perf_counter()
                try:
                    match = self.prefix_cache.match(self._match_span(req))
                    matched = match.tokens
                except Exception as e:
                    if not self.fault_tolerant:
                        raise
                    self._contained_cache_fault(match, e)
                    match, matched = None, 0
                t_match1 = time.perf_counter()
            plan = self._plan(req, matched)
            self.scheduler.place(req, slot)
            # only after placement: a failed admission is requeued and
            # retried.  The hit counters move when the gather lands
            # (_load_lane), where a contained gather fault still turns
            # the hit into a miss
            req.prefix_hit_tokens = matched
            req.admit_time = t_admit
            self.metrics.on_queue_wait(t_admit - req.arrival_time)
            tracer = self.metrics.tracer
            if tracer.enabled:
                lane = self._lane(req)
                tracer.set_lane_name(lane, f"request {req.request_id}")
                tracer.add_span("queued", lane, req.arrival_time, t_admit,
                                prompt_len=req.prompt_len)
                if self._cache_active:
                    tracer.add_span("prefix_match", lane, t_match0,
                                    t_match1, hit_tokens=matched)
            self._prefills.append(_Prefill(req, slot, plan, match))
            self.progress_counter += 1          # admission = progress
        except BaseException:
            if match is not None:
                self.prefix_cache.release(match)
            self.pool.free(slot)
            raise

    def _load_lane(self, st: _Prefill) -> None:
        """``st`` now heads the prefill queue: seed the staging lane with
        its pinned radix match (one in-place gather that overwrites every
        row), or zero it on a miss, so no row of an earlier request is
        left where this one's queries could read it.

        Under the watchdog a gather that raises degrades the request to a
        miss here, as the reference's admission-time gather does: the pin
        is released, the fault counted toward the ladder, the lane zeroed
        and the suffix planned again from token 0, with no hit counted."""
        t0 = time.perf_counter()
        hit = st.match is not None and st.match.tokens > 0
        if hit:
            try:
                self.prefix_cache.load_staging(st.match, self._lane_ks,
                                               self._lane_vs)
            except Exception as e:
                if not self.fault_tolerant:
                    raise
                self._contained_cache_fault(st.match, e)
                st.match, hit = None, False
                st.req.prefix_hit_tokens = 0
                st.plan = self._plan(st.req, 0)
            else:
                self.metrics.on_prefix_hit(st.match.tokens)
        if not hit:
            for row in (*self._lane_ks, *self._lane_vs):
                for shard in (row if isinstance(row, list) else [row]):
                    shard.zero_()
        t1 = time.perf_counter()
        self.metrics.on_gather(t1 - t0)
        self.metrics.tracer.add_span("gather", self._lane(st.req), t0, t1,
                                     hit=hit)

    def _run_chunk(self, st: _Prefill) -> None:
        """Run one prefill chunk of ``st`` (queued on the device; no
        readback): the host fills the offset, valid count and ids in one
        copy from pinned memory, then the body runs through its width's
        graph on a card, eagerly elsewhere."""
        if st.next_chunk == 0:
            self._load_lane(st)
        off, width, valid = st.plan[st.next_chunk]
        if width not in self._warm_buckets:
            # with a store attached the committed-width contract is the
            # store's: loud as a store error
            raise (AOTStoreError if self.aot_store is not None
                   else RuntimeError)(
                f"prefill width {width} is outside the committed bucket "
                f"set {sorted(self._warm_buckets)}: warm_buckets() and "
                f"chunk_plan disagree")
        t0 = time.perf_counter()
        host = torch.zeros((2 + width,), dtype=torch.int64,
                           pin_memory=self._prefill_io.is_cuda)
        buf = host.numpy()
        buf[0], buf[1] = off, valid
        buf[2:2 + valid] = st.req.prompt[off:off + valid]
        # pinned memory: the copy is queued, not waited for; the host
        # allocator keeps the block until the copy has run
        self._prefill_io[:2 + width].copy_(host, non_blocking=True)
        if self.prefill_graph_reason is None:
            self._prefill_graph_chunk(width)
        else:
            self._prefill_body(width)
            self.eager_prefill_chunks += 1
        t1 = time.perf_counter()
        st.next_chunk += 1
        st.req.prefill_chunks += 1
        self.progress_counter += 1              # chunk ran = progress
        self.metrics.on_prefill_chunk(valid, seconds=t1 - t0)
        self.metrics.tracer.add_span(
            "prefill_chunk", self._lane(st.req), t0, t1,
            chunk=st.next_chunk - 1, width=width, tokens=valid)

    def _prefill_body(self, width: int) -> None:
        """ONE prefill chunk of ``width`` tokens on fixed buffers: the ids
        at the offset the ``[1]`` tensor holds, appended into the staging
        lane in place; the logits over the whole chunk, then the row at
        ``valid - 1`` picked on the device into the f32 last-logits
        buffer (the reference's form: the LM head runs on every row).
        This is what each width's prefill graph captures."""
        off = self._prefill_off
        caches = [(k, v, off) for k, v in zip(self._lane_ks, self._lane_vs)]
        logits, _ = self._forward(self._prefill_ids[:, :width], caches, off)
        self._prefill_logits.copy_(
            logits[0].index_select(0, self._prefill_valid - 1)[0])

    def _prefill_graph_chunk(self, width: int) -> None:
        """The prefill body through its width's CUDA graph: the first
        chunk of each width runs the body eagerly and captures it, later
        ones replay the graph."""
        graph, seconds = self._graphed(
            self._prefill_graphs.get(width),
            functools.partial(self._prefill_body, width), "prefill",
            f"the width-{width} prefill chunk")
        self._prefill_graphs[width] = graph
        if seconds is not None:
            self.eager_prefill_chunks += 1
            self.prefill_capture_seconds[width] = seconds

    def _complete_prefill(self, st: _Prefill):
        """Final chunk done: sample the first token from the request's own
        generator and adopt the staging lane into the pool slot.  Returns
        ``(st, first_token)``; the caller batches the readbacks
        (``_flush_staged``) and only then publishes the prompt blocks to
        the radix cache, so KV whose prefill produced non-finite logits
        is never cached."""
        req, slot, s = st.req, st.slot, st.req.sampling
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s.seed)
        mask = allowed = None
        if req.allowed_tokens is not None:
            # the host set gates draft proposals
            allowed = frozenset(int(t) for t in req.allowed_tokens)
            self._mask_host[slot] = False
            self._mask_host[slot, np.asarray(req.allowed_tokens,
                                             np.int64)] = True
            self._mask_dirty = True
            mask = torch.as_tensor(self._mask_host[slot][None]).to(
                self.device)
        # queued before the next chunk overwrites the lane or the logits
        last = self._prefill_logits[None]
        first = sample_rows([gen], last, [s.do_sample], [s.temperature],
                            [s.top_k], [s.top_p], mask=mask)
        first = finite_or_sentinel(last, first)
        draft = None
        if self.spec_on:
            draft = NGramDraftTable()
            draft.seed(req.prompt)
        self.pool.adopt(slot, list(zip(self._lane_ks, self._lane_vs)),
                        req.prompt_len)
        self._slots[slot] = _Slot(req, req.prompt_len, match=st.match,
                                  draft=draft, allowed=allowed)
        self._last_tok[slot] = first[0]
        self._gens[slot] = gen
        self._do_sample[slot] = s.do_sample
        self._temperature[slot] = s.temperature
        self._top_k[slot] = s.top_k
        self._top_p[slot] = s.top_p
        self.metrics.on_prefill(req.prompt_len - req.prefix_hit_tokens)
        return st, first

    def _advance_one(self, st: _Prefill, staged: List) -> None:
        """Advance one mid-prefill request — to completion without
        chunking, by exactly one chunk with it — appending the completed
        ``(st, first_token)`` to ``staged``.  Under the watchdog a prefill
        fault fails only this request (its lane content is lost, the
        engine's state is not): a chunked request's fault counts toward
        the ``chunked_prefill`` rung, any other as a ``prefill`` fault."""
        try:
            if self.prefill_chunk is None:
                while not st.done:
                    self._run_chunk(st)
            else:
                self._run_chunk(st)
            if st.done:
                self._prefills.remove(st)
                staged.append(self._complete_prefill(st))
        except Exception as e:
            if not self.fault_tolerant:
                raise
            self._abort_prefill(st, "failed", f"prefill fault: {e!r}")
            if self.prefill_chunk is not None:
                self._subsystem_fault("chunked_prefill", e)
            else:
                self.metrics.on_fault("prefill", repr(e),
                                      step=self._step_in_flight)

    def _advance_prefills(self) -> int:
        """Run this step's prefill work: without chunking every pending
        prefill completes; with ``prefill_chunk`` exactly ONE chunk runs
        per step.  Completed requests' first tokens come back in ONE
        batched readback.  Returns tokens emitted."""
        staged: List[Tuple[_Prefill, torch.Tensor]] = []
        try:
            if self.prefill_chunk is None:
                while self._prefills:
                    self._advance_one(self._prefills[0], staged)
            elif self._prefills:
                self._advance_one(self._prefills[0], staged)
        finally:
            # tokens already staged must be emitted even if a later
            # prefill raised
            emitted = self._flush_staged(staged)
        return emitted

    def _flush_staged(self, staged) -> int:
        """THE batched first-token readback for this step's completed
        prefills, then per request: non-finite containment (fail the
        request, skip the radix insert), the deferred prefix-cache
        insert, and the first-token emit."""
        if not staged:
            return 0
        toks = torch.cat([f for _, f in staged]).cpu().numpy()
        emitted = 0
        flush_exc = None
        for (st, _), tok in zip(staged, toks):
            tok = int(tok)
            if tok == NONFINITE_SENTINEL:
                self.metrics.on_fault(
                    "nan_logits", "non-finite logits at prefill "
                    "completion", step=self._step_in_flight)
                self._finalize(st.req, "failed",
                               "non-finite logits at prefill completion")
                continue   # slot reclaimed by _evict_finished this step
            if self._cache_active:
                try:
                    self.prefix_cache.insert(st.req.prompt, self.pool,
                                             st.slot)
                except Exception as e:
                    if not self.fault_tolerant:
                        raise
                    # the insert is an optimization: count the fault (the
                    # ladder may bypass the cache) and keep the request
                    self._subsystem_fault("prefix_cache", e)
            # a raise for one request must not drop the others' first
            # tokens: finish the loop, then re-raise the first error
            # (under the watchdog the request's failure contains it)
            try:
                self._emit(st.slot, tok, first_token=True)
            except Exception as e:
                self.metrics.on_fault("harvest", repr(e),
                                      step=self._step_in_flight)
                self._finalize(st.req, "failed",
                               f"token emit failed: {e!r}")
                if flush_exc is None:
                    flush_exc = e
                continue
            emitted += 1
        if flush_exc is not None and not self.fault_tolerant:
            raise flush_exc
        return emitted

    # ------------------------------------------------------------ decode
    def _resolve_decode_path(self) -> Tuple[str, Optional[str]]:
        """The decode implementation for THIS engine's shapes: with
        ``fused_decode`` the fused decode-block kernels when the model
        supports them and ``resolve_fused_decode`` finds them legal at
        (num_slots, max_seq), else the unfused ``decode_step`` with the
        refusal's reason.  Under tensor parallelism the chain is
        ``tp_fused_block`` (the sharded kernels: the flag opts in,
        ``collective_fusion`` is on — its rings are the fused collectives —
        and ``resolve_fused_decode(tp=...)`` passes), else ``tp_fused``
        (the composed ring, when ``collective_fusion`` is on and
        ``tp_decode_supported`` holds; its refusal lands in
        ``tp_fusion_reason``), else ``unfused`` (the Megatron body); every
        rung keeps serving.  Returns ``(path, fallback_reason)``; the
        reason is None when a fused-block path engages or the flag is
        off.

        The speculative leg resolves here too, statically: ``spec_on`` /
        ``spec_fallback_reason`` say why speculation is armed or not for
        this engine shape (the per-step row-end gate of
        ``_propose_drafts`` and ``spec_bypass`` are the only run-time
        fallbacks)."""
        if self.spec_k == 0:
            self.spec_on = False
            self.spec_fallback_reason = \
                "spec_k=0 (speculation not requested)"
        elif self.pool.max_seq <= self.spec_k + 1:
            self.spec_on = False
            self.spec_fallback_reason = (
                f"max_seq {self.pool.max_seq} leaves no room for a "
                f"spec_k={self.spec_k} verify window")
        else:
            self.spec_on = True
            self.spec_fallback_reason = None
        if self.tensor_parallel > 1:
            reason = None
            if self.fused_decode:
                ok, reason = resolve_fused_decode(
                    self.model, batch=self.num_slots,
                    kv_len=self.pool.max_seq, tp=self.tensor_parallel)
                if ok and not self.collective_fusion:
                    ok, reason = False, ("collective_fusion disabled "
                                         "(the sharded block's "
                                         "entry/exit rings are fused "
                                         "collectives)")
                if ok:
                    return "tp_fused_block", None
            ok, tp_reason = tp_decode_supported(
                self.model, self.tensor_parallel, self.num_slots) \
                if self.collective_fusion \
                else (False, "collective_fusion disabled")
            self.tp_fusion_reason = None if ok else tp_reason
            return ("tp_fused" if ok else "unfused"), reason
        if not self.fused_decode:
            return "unfused", None
        ok, reason = resolve_fused_decode(self.model, batch=self.num_slots,
                                          kv_len=self.pool.max_seq)
        return ("fused", None) if ok else ("unfused", reason)

    def _resolve_decode_graph(self) -> Optional[str]:
        """Why the decode step is NOT captured as a CUDA graph (None when
        it is): ``"cpu"`` off the card, or a mesh whose shards span
        several CUDA devices (one graph captures one device's streams)."""
        devices = self.mesh.devices if self.mesh is not None \
            else [torch.device(self.device)]
        off_card = [d.type for d in devices if d.type != "cuda"]
        if off_card:
            return off_card[0]
        cards = sorted({str(d) for d in devices})
        if len(cards) > 1:
            return (f"the tensor-parallel mesh spans {len(cards)} CUDA "
                    f"devices {cards} (one CUDA graph captures one "
                    f"device's streams)")
        return None

    def _decode_body(self) -> None:
        """ONE fixed-shape decode step over every slot, reading and
        writing only buffers whose addresses never change: the slabs
        (appended in place), ``pool.seq_pos`` (advanced by one in place),
        ``_last_tok`` and the logits buffer.  This is what the decode graph
        captures."""
        pool = self.pool
        if self._tp_program is not None:
            logits = self._tp_program(pool.ks, pool.vs, pool.seq_pos,
                                      self._last_tok)[0]
        else:
            caches = [(k, v, pool.seq_pos) for k, v in zip(pool.ks, pool.vs)]
            step_fn = self.model.fused_decode_step \
                if self.decode_path == "fused" else self._forward
            logits, _ = step_fn(self._last_tok[:, None], caches,
                                pool.seq_pos)
            pool.seq_pos.add_(1)
        self._logits.copy_(logits[:, 0])

    def _graphed(self, graph, body, program: str, what: str,
                 count: bool = True):
        """``body`` through ``graph`` on the device's capture stream,
        joined to the current stream on both sides (the host's input
        copies, ``pool.adopt`` and sampling run there).  With no graph yet
        the body runs eagerly — that IS this call's work, and it sizes the
        kernels' per-stream workspaces — and is then captured into a new
        graph from the engine's memory pool, counted in
        ``capture_counts[program]`` (not with ``count=False``: an AOT
        attach).  Returns ``(graph, capture seconds or None after a
        replay)``.  A failure raises, naming ``what`` and
        the engine step: nothing serves eagerly instead."""
        stream = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        verb = "replay" if graph is not None else "capture"
        try:
            with torch.cuda.stream(stream):
                if graph is not None:
                    graph.replay()
                    return graph, None
                body()
                # capture_begin / capture_end rather than torch.cuda.graph,
                # whose device sync, gc.collect and empty_cache would land
                # on the requests in flight
                t0 = time.perf_counter()
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self._graph_pool)
                try:
                    body()
                finally:
                    graph.capture_end()
                seconds = time.perf_counter() - t0
            if count:
                self.capture_counts[program] += 1
                self.capture_seconds[program] += seconds
            return graph, seconds
        except Exception as e:
            raise RuntimeError(
                f"engine step {self._step_in_flight}: CUDA graph {verb} of "
                f"{what} on {self.device} failed: {e}") from e
        finally:
            current.wait_stream(stream)

    def _decode_graph_step(self) -> None:
        """The decode body through this engine's CUDA graph: captured at
        the first decode step (whose body runs eagerly first), replayed
        at every later one.  A capture that raises leaves no graph, and
        ``pool.seq_pos`` where the step found it (its eager run had
        advanced it), so the watchdog's retry decodes the same step
        again and captures anew."""
        pos = self.pool.seq_pos.clone() if self._decode_graph is None \
            else None
        try:
            self._decode_graph, seconds = self._graphed(
                self._decode_graph, self._decode_body, "decode",
                f"the {self.decode_path!r} decode step")
        except Exception:
            if pos is not None:
                self.pool.seq_pos.copy_(pos)
            raise
        if seconds is not None:
            self.eager_decode_steps += 1

    def _sync_mask(self) -> None:
        """Upload the constrained-decoding mask if a row changed (None on
        the device while every row is unconstrained)."""
        if self._mask_dirty:
            self._mask_dev = None if self._mask_host.all() else \
                torch.as_tensor(self._mask_host).to(self.device)
            self._mask_dirty = False

    def _decode_dispatch(self) -> torch.Tensor:
        """ONE fixed-shape decode step over every slot — the body (its
        graph on a card), then eager sampling; returns the sampled token
        vector STILL ON THE DEVICE — the caller performs the step's single
        readback."""
        self._sync_mask()
        if self.decode_graph_reason is None:
            self._decode_graph_step()
        else:
            self._decode_body()
            self.eager_decode_steps += 1
        lg = self._logits
        nxt = sample_rows(self._gens, lg, self._do_sample,
                          self._temperature, self._top_k, self._top_p,
                          mask=self._mask_dev)
        # a poisoned row reads back as the sentinel through the step's
        # existing single readback
        self._last_tok.copy_(finite_or_sentinel(lg, nxt))
        return self._last_tok

    # ----------------------------------------- speculative decode (spec)
    def _verify_body(self) -> None:
        """ONE fixed-shape verify step over every slot, reading and
        writing only buffers whose addresses never change: the window ids
        (``_last_tok``, then the drafts of ``_verify_io``) run through the
        engine's forward at width ``spec_k+1`` at each slot's
        ``pool.seq_pos``, appending the window's K/V rows into the slabs,
        into the f32 window logits.  ``seq_pos`` is not advanced: the
        acceptance tail advances it by each slot's accepted length + 1,
        which also hides the rejected rows until the next append
        overwrites them.  This is what the verify graph captures.

        The forward is ``self._forward`` (``model.decode_step`` at tp=1,
        fused engines too, since the fused block takes one token a slot;
        the Megatron body on a tensor-parallel ``unfused`` engine), or
        the ring verify program on ``tp_fused`` / ``tp_fused_block``."""
        pool = self.pool
        ids = self._verify_ids
        ids[:, 0].copy_(self._last_tok)
        ids[:, 1:].copy_(self._verify_io[:, :-1])
        if self._tp_verify_program is not None:
            logits = self._tp_verify_program(pool.ks, pool.vs, pool.seq_pos,
                                             ids)
        else:
            caches = [(k, v, pool.seq_pos) for k, v in zip(pool.ks, pool.vs)]
            logits, _ = self._forward(ids, caches, pool.seq_pos)
        self._verify_logits.copy_(logits)

    def _verify_tail(self):
        """Matched-sampling acceptance over the window logits (eager, after
        the body): for t = 0..spec_k every row selects a token from
        position t exactly as the t-th sequential decode step would
        (``sample_rows`` with the constrained mask, its own generator for
        a sampling row, then ``finite_or_sentinel``), and each sampling
        row's generator state is snapshot after each draw.  A row accepts
        the longest draft prefix those tokens reproduce (a cumulative
        product of the matches below its draft length; a sentinel never
        matches a draft), advances ``seq_pos`` by accepted + 1 and keeps
        ``committed[accepted]`` as its last token, all on the device.
        Returns the packed ``[num_slots, spec_k+2]`` commit rows (the
        window's tokens, then the accepted length) STILL ON THE DEVICE,
        and the snapshots ``(rows, states)`` for ``_restore_generators``."""
        k = self.spec_k
        lg = self._verify_logits
        rows = np.flatnonzero(self._do_sample)
        cols, states = [], []
        for t in range(k + 1):
            tok = sample_rows(self._gens, lg[:, t], self._do_sample,
                              self._temperature, self._top_k, self._top_p,
                              mask=self._mask_dev)
            cols.append(finite_or_sentinel(lg[:, t], tok))
            states.append([self._gens[r].get_state() for r in rows])
        committed = torch.stack(cols, dim=1)
        drafts, lens = self._verify_io[:, :k], self._verify_io[:, k]
        valid = torch.arange(k, device=lens.device)[None, :] < lens[:, None]
        match = (committed[:, :k] == drafts) & valid
        accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
        self.pool.seq_pos.add_((accepted + 1).to(self.pool.seq_pos.dtype))
        self._last_tok.copy_(committed.gather(1, accepted[:, None])[:, 0])
        packed = torch.cat([committed, accepted[:, None]], dim=1)
        return packed, (rows, states)

    def _restore_generators(self, snapshots, accepted: np.ndarray) -> None:
        """After the readback: each sampling row's generator goes back to
        its state after draw ``accepted + 1`` of the window, the draws
        sequential decode would have made for the tokens it commits."""
        rows, states = snapshots
        for i, r in enumerate(rows):
            self._gens[r].set_state(states[int(accepted[r])][i])

    def _verify_graph_step(self) -> None:
        """The verify body through this engine's CUDA graph: captured at
        the first verify step (whose body runs eagerly first), replayed at
        every later one."""
        self._verify_graph, seconds = self._graphed(
            self._verify_graph, self._verify_body, "verify",
            f"the {self.decode_path!r} engine's verify step")
        if seconds is not None:
            self.eager_verify_steps += 1

    def _verify_dispatch(self, drafts: np.ndarray, draft_len: np.ndarray):
        """ONE fixed-shape verify step over every slot: the drafts and
        their lengths in one copy from pinned memory, the body (its graph
        on a card), then the eager acceptance tail.  Returns the packed
        commit rows STILL ON THE DEVICE (the caller performs the step's
        single readback) and the generator snapshots."""
        self._sync_mask()
        k = self.spec_k
        host = torch.zeros((self.num_slots, k + 1), dtype=torch.int64,
                           pin_memory=self._verify_io.is_cuda)
        buf = host.numpy()
        buf[:, :k], buf[:, k] = drafts, draft_len
        self._verify_io.copy_(host, non_blocking=True)
        if self.decode_graph_reason is None:
            self._verify_graph_step()
        else:
            self._verify_body()
            self.eager_verify_steps += 1
        return self._verify_tail()

    def _propose_drafts(self):
        """Host draft phase: ask every active slot's n-gram table for up
        to ``spec_k`` tokens.  Returns ``(drafts [num_slots, spec_k],
        draft_len [num_slots], total_drafted)``, or None when this step
        runs the normal decode instead: speculation off or bypassed,
        nothing proposed anywhere, or ANY occupied slot within
        ``spec_k+1`` rows of its row end (``append_kv`` clamps a window's
        start at ``max_seq - width``, which would overwrite that row's
        valid KV; such a slot is about to reach max_seq anyway)."""
        if not self.spec_on or self.spec_bypass or not self._slots:
            return None
        k = self.spec_k
        limit = self.pool.max_seq - k - 1
        drafts = np.zeros((self.num_slots, k), np.int64)
        lens = np.zeros((self.num_slots,), np.int64)
        total = 0
        for slot, st in self._slots.items():
            if st.pos > limit:
                return None
            if st.draft is None or st.req.finished:
                continue
            toks = st.draft.propose(k, allowed=st.allowed)
            if toks:
                drafts[slot, :len(toks)] = toks
                lens[slot] = len(toks)
                total += len(toks)
        if total == 0:
            return None
        return drafts, lens, total

    # ---------------------------------------------------------- AOT store
    def _attach_aot(self) -> None:
        """Attach the AOT store: every leg of the plane (serving/aot.py)
        through :meth:`_attach_leg`, then the plane's state put back as a
        fresh plane has it.  A fingerprint that differs attaches nothing
        (``aot_status == "skew"``, one ``aot_miss``): every leg captures at
        first use.  A width set that differs under a matching fingerprint
        raises: the build and the engine disagree on ``warm_buckets()``."""
        store = self.aot_store
        t0 = time.perf_counter()
        self.aot_status = None
        fp = aot_fingerprint(self._aot_context)
        if fp != store.fingerprint:
            self.aot_status = "skew"
            self.metrics.on_aot_miss(
                "store", f"fingerprint skew: engine {fp[:12]}, store "
                         f"{store.fingerprint[:12]}")
            return
        committed = tuple(sorted(self._warm_buckets))
        if tuple(store.widths) != committed:
            raise AOTStoreError(
                f"committed width drift under a matching fingerprint: "
                f"store built for widths {list(store.widths)}, the engine "
                f"commits {list(committed)}: the build and the engine disagree "
                f"on warm_buckets()")
        legs = engine_legs(self)
        loads = sum(self._attach_leg(leg) for leg in legs)
        if self.decode_graph_reason is None:
            self._reset_plane_state()
        self.aot_status = "warm" if loads == len(legs) else \
            ("partial" if loads else "empty")
        if loads:
            self.metrics.on_aot_load(loads, time.perf_counter() - t0,
                                     build_s=store.build_seconds)

    def _attach_leg(self, leg: str) -> bool:
        """Attach ONE leg: read it (CRC-checked), install its libraries,
        and where the engine captures graphs capture its graph.  Returns
        False, with an ``aot_miss`` / ``aot_fallback`` event, when the leg
        is absent or its read fails: it then captures at first use.  An
        install or a capture that fails raises."""
        store = self.aot_store
        if not store.has(leg):
            self.metrics.on_aot_miss(leg, "not in store")
            return False
        try:
            if self.faults is not None:
                self.faults.fire("aot_load")
            _, libs = store.read_leg(leg)
        except Exception as e:
            self.metrics.on_aot_fallback(leg, repr(e))
            return False
        for lib, (payload, crc) in libs.items():
            _build.install(lib, payload, crc)
        if self.decode_graph_reason is None:
            self._run_leg(leg, capture=True)
        return True

    def _run_leg(self, leg: str, capture: bool) -> None:
        """Run ``leg``'s body now, off the request path, eagerly on the
        plane's own buffers (a prefill chunk of one valid token at offset
        0), and with ``capture`` then capture it into the engine's graph
        pool.  Not counted in ``capture_counts``."""
        kind, _, key = leg.partition(":")
        if kind == "prefill":
            width = int(key[1:])
            self._prefill_io.zero_()
            self._prefill_valid.fill_(1)
            body = functools.partial(self._prefill_body, width)
            what = f"the width-{width} prefill chunk"
        elif kind == "decode":
            body, what = self._decode_body, \
                f"the {self.decode_path!r} decode step"
        elif kind == "verify":
            self._verify_io.zero_()
            body, what = self._verify_body, \
                f"the {self.decode_path!r} engine's verify step"
        else:
            raise AOTStoreError(f"unknown leg {leg!r}")
        if not capture:
            body()
            return
        graph, _ = self._graphed(None, body, kind, what, count=False)
        if kind == "prefill":
            self._prefill_graphs[width] = graph
        elif kind == "decode":
            self._decode_graph = graph
        else:
            self._verify_graph = graph

    def _reset_plane_state(self) -> None:
        """Put back what the legs' eager runs changed, as a fresh plane
        has it: ``seq_pos``, the last-token vector, the staging lane, the
        I/O buffers and the logits.  The slab rows the decode and verify
        bodies wrote lie at each slot's position 0 onwards, which a slot
        writes again before it reads (``adopt`` copies a whole row)."""
        self.pool.seq_pos.zero_()
        self._last_tok.zero_()
        for row in (*self._lane_ks, *self._lane_vs):
            for shard in (row if isinstance(row, list) else [row]):
                shard.zero_()
        for name in ("_logits", "_prefill_io", "_prefill_logits",
                     "_verify_io", "_verify_ids", "_verify_logits"):
            buf = getattr(self, name, None)
            if buf is not None:
                buf.zero_()

    # -------------------------------------------------------- step loop
    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit (radix match + staging), advance
        prefill chunks, one decode step over all active slots, harvest
        tokens / evict finished.  Returns the number of requests still in
        flight (prefilling + running + queued).

        With ``fault_tolerance`` this is the watchdog boundary: a step
        that raises is attributed (an optional subsystem -> the
        degradation ladder; the core -> a backed-off retry, then a
        quarantine) and does not propagate; a rebuild that raises does.
        With the circuit open a step does nothing.  A closed engine
        raises, and is never retried."""
        if self.closed:
            raise RuntimeError("engine is closed")
        if not self.fault_tolerant:
            return self._step_body()
        if self.health.circuit_open:
            return self.scheduler.active + self.scheduler.queue_depth
        try:
            out = self._step_body()
        except Exception as e:
            return self._on_step_fault(e)
        self.health.on_step_ok()
        self._publish_health()
        return out

    def _step_body(self) -> int:
        """The raw step.  Its phase breakdown lands as ``step.*`` spans and
        per-phase histograms; the per-slot token readback is the step's
        only device sync.  The injection points of the decode region fire
        after the draft phase and before any dispatch, so a retried step
        finds nothing mutated and every generator where sequential decode
        left it."""
        t0 = time.perf_counter()
        tracer = self.metrics.tracer
        step_i = self._step_index
        self._step_index += 1
        self._step_in_flight = step_i
        self._fault_phase = None
        skips_before = self.scheduler.total_head_skips
        new_tokens = 0
        phases = []
        faults = self.faults
        if faults is not None:
            armed = faults.check("slow_step")
            if armed is not None:
                self.metrics.on_fault(
                    "slow_step", f"injected {armed.seconds}s stall",
                    step=step_i)
                time.sleep(armed.seconds)
        ann = None
        if self.metrics.record_events:
            # a host range around the step; it launches no device work,
            # so a graph captured inside the step holds nothing of it
            ann = RecordEvent("serving.step")
            ann.begin()
        sp = tracer.begin_span("serving.step",
                               lane=self.metrics.engine_lane, step=step_i)
        try:
            if self._deadlines_possible:
                self._expire_deadlines(time.perf_counter())
            admitted = self.scheduler.admit(
                self.pool.free_slots,
                token_budget=self.max_prefill_tokens_per_step,
                cost=self._prefill_cost)
            for i, (req, _) in enumerate(admitted):
                try:
                    self._begin_prefill(req)
                except BaseException:
                    # admission failure must not LOSE requests: the
                    # failing one and the rest of the popped batch go
                    # back to the queue head
                    self.scheduler.requeue_front(
                        [r for r, _ in admitted[i:]])
                    raise
            t_admit = time.perf_counter()
            new_tokens = self._advance_prefills()
            t_prefill = time.perf_counter()
            phases = [("admission", t0, t_admit),
                      ("prefill", t_admit, t_prefill)]
            if self._slots:
                if faults is not None \
                        and faults.check("nan_logits") is not None:
                    self._poison_slot(min(self._slots), step_i)
                # the speculative draft phase (host): None -> a decode
                # step, else ONE verify step commits up to spec_k+1
                # tokens a slot
                spec = self._propose_drafts()
                # a decode fault is not one slot's: the watchdog
                # attributes it to the decode path (a ladder rung when
                # fused or speculating, a retry otherwise)
                if spec is not None:
                    self._fault_phase = "spec_verify"
                else:
                    self._fault_phase = "fused_decode" \
                        if self.decode_path in ("fused", "tp_fused_block") \
                        else "decode"
                if faults is not None:
                    faults.fire("step")
                    if spec is not None:
                        faults.fire("spec_verify")
                if spec is not None:
                    drafts, draft_len, drafted = spec
                    nxt, snapshots = self._verify_dispatch(drafts, draft_len)
                else:
                    nxt = self._decode_dispatch()
                t_decode = time.perf_counter()
                toks = nxt.cpu().numpy()   # THE per-step device readback
                t_readback = time.perf_counter()
                self._fault_phase = None
                if spec is not None:
                    self._restore_generators(snapshots,
                                             toks[:, self.spec_k + 1])
                # every slot's device state already advanced: a raise for
                # one slot (a stream callback) must not drop the later
                # slots' tokens — finish the loop, then re-raise
                harvest_exc = None
                accepted_total = 0
                for slot in sorted(self._slots):
                    st = self._slots.get(slot)
                    if st is None:
                        continue   # reentrantly cancelled mid-loop
                    try:
                        if spec is None:
                            new_tokens += self._harvest(slot,
                                                        int(toks[slot]))
                        else:
                            a = int(toks[slot, self.spec_k + 1])
                            accepted_total += a
                            new_tokens += self._harvest_window(
                                slot, toks[slot, :a + 1])
                    except Exception as e:
                        self.metrics.on_fault("harvest", repr(e),
                                              step=step_i)
                        self._finalize(st.req, "failed",
                                       f"token emit failed: {e!r}")
                        if harvest_exc is None:
                            harvest_exc = e
                if spec is not None:
                    self.metrics.on_spec(int(drafted), accepted_total)
                phases += [("decode_dispatch", t_prefill, t_decode),
                           ("readback", t_decode, t_readback)]
                if self.decode_path in ("fused", "tp_fused_block"):
                    self.metrics.on_decode_block_step(t_decode - t_prefill)
                if self.tensor_parallel > 1:
                    self.metrics.on_collective(t_readback - t_prefill)
                # under the watchdog the failed request already contains
                # it: a retry would re-run a step every slot has advanced
                if harvest_exc is not None and not self.fault_tolerant:
                    raise harvest_exc
            self._evict_finished()
            if self.journal is not None:
                self._journal_progress()
        finally:
            tracer.end_span(sp)
            if ann is not None:
                ann.end()
        self._record_events(step_i, skips_before)
        self.metrics.record_step(
            active_slots=len(self._slots), num_slots=self.num_slots,
            queue_depth=self.scheduler.queue_depth,
            new_tokens=new_tokens,
            step_seconds=time.perf_counter() - t0,
            step_index=step_i, phases=phases)
        return self.scheduler.active + self.scheduler.queue_depth

    def _journal_progress(self) -> None:
        """This step's delivered marks as ONE journal record, from host
        ints the harvest already holds.  It runs after eviction, so a
        request that finished this step is covered by its terminal record
        instead."""
        updates = {}
        for st in self._slots.values():
            rid, n = st.req.request_id, len(st.req.tokens)
            if n and self._journal_hwm.get(rid) != n:
                updates[rid] = self._journal_hwm[rid] = n
        self.journal.append_progress(updates)

    def _record_events(self, step_i: int, skips_before: int) -> None:
        """This step's discrete happenings as event-log entries:
        capture-counter deltas = program compiles (``serving.compiles``
        and a ``compile`` event), the scheduler's skip-counter delta =
        head-of-line jumps."""
        tracer = self.metrics.tracer
        for prog, n in self.capture_counts.items():
            seen = self._compile_seen.get(prog, 0)
            if n > seen:
                self.metrics.on_compile(prog, n - seen)
                tracer.event("compile", lane=self.metrics.engine_lane,
                             program=prog, count=n - seen, step=step_i,
                             seconds=self.capture_seconds[prog])
        self._compile_seen = dict(self.capture_counts)
        skips = self.scheduler.total_head_skips
        if skips > skips_before:
            tracer.event("head_of_line_skip", lane=self.metrics.engine_lane,
                         count=skips - skips_before, step=step_i)

    def _poison_slot(self, slot: int, step_i: int) -> None:
        """Chaos only: write NaN over position 0 of ``slot``'s layer-0 K
        row, in place (shard 0 under a mesh), so every graph keeps its
        addresses and the next decode or verify replay reads the poison.
        Attention spreads it into that row's logits, the non-finite check
        turns them into the sentinel, and the harvest fails exactly that
        request; the next ``adopt`` rewrites the row."""
        k0 = self.pool.ks[0]
        (k0[0] if isinstance(k0, list) else k0)[slot, 0].fill_(float("nan"))
        self.metrics.on_fault("nan_logits",
                              f"injected NaN into slot {slot} KV",
                              step=step_i)

    # ------------------------------------------------ watchdog / recovery
    def _publish_health(self) -> None:
        self.health.degraded = self.ladder.level > 0
        self.metrics.on_health_state(self.health.state,
                                     self.health.state_code,
                                     step=self._step_in_flight)

    def _on_step_fault(self, exc: Exception) -> int:
        """A step raised under the watchdog.  A fault of the speculative
        or the fused decode path feeds the ladder (plain decode is always
        there); any other costs one retry from the backoff budget, and a
        spent budget quarantines.  The step's own handlers already
        unwound its state (admission requeues its batch, prefill faults
        fail their request), so a retry is just the next step after the
        backoff sleep."""
        step_i = self._step_in_flight
        phase = self._fault_phase or "step"
        if phase == "spec_verify" and self.spec_on \
                and not self.spec_bypass:
            self._subsystem_fault("spec_verify", exc)
        elif phase == "fused_decode" \
                and self.decode_path in ("fused", "tp_fused_block"):
            self._subsystem_fault("fused_decode", exc)
        else:
            self.metrics.on_fault(phase, repr(exc), step=step_i)
            backoff = self.health.record_step_fault(repr(exc))
            if backoff is None:
                self._quarantine(f"{phase} fault: {exc!r}")
            else:
                self.metrics.on_retry(self.health.consecutive_faults,
                                      backoff, step=step_i)
                if backoff > 0:
                    time.sleep(backoff)
        self._publish_health()
        return self.scheduler.active + self.scheduler.queue_depth

    def _subsystem_fault(self, subsystem: str, exc: Exception) -> None:
        """Count one fault against an optional subsystem; at the ladder's
        threshold the subsystem is disabled (the fault site already
        contained the failure)."""
        self.metrics.on_fault(subsystem, repr(exc),
                              step=self._step_in_flight)
        if self.ladder.record_fault(subsystem):
            self._disable_subsystem(subsystem, repr(exc))

    def _disable_subsystem(self, subsystem: str, reason: str) -> None:
        """Apply one rung of the degradation ladder, for the engine's
        lifetime.  The rungs that change the step program drop its graphs
        (captured again at the next step): the decode path and, with it,
        the verify graph."""
        if subsystem == "prefix_cache":
            # matches and inserts stop; live pins release as their
            # requests finish
            self.prefix_bypass = True
        elif subsystem == "chunked_prefill":
            # whole-bucket prefill; every width it plans is already in
            # warm_buckets() and fits the prefill buffers
            self.prefill_chunk = None
        elif subsystem == "fused_decode":
            if self.tensor_parallel > 1:
                # the sharded-block rung falls to the composed ring when it
                # is legal, the Megatron body otherwise: the resolve order
                ok, tp_reason = tp_decode_supported(
                    self.model, self.tensor_parallel, self.num_slots) \
                    if self.collective_fusion \
                    else (False, "collective_fusion disabled")
                self.decode_path = "tp_fused" if ok else "unfused"
                self.tp_fusion_reason = None if ok else tp_reason
                self._tp_program = build_tp_decode_program(
                    self.tp_weights, pallas_block=False,
                    batch=self.num_slots, max_seq=self.pool.max_seq) \
                    if ok else None
                if not ok:
                    # the ring verify program serves both ring rungs
                    self._tp_verify_program = None
            else:
                self.decode_path = "unfused"
            self.decode_fallback_reason = f"degraded: {reason}"
            self._drop_graphs(prefill=False)
        elif subsystem == "spec_verify":
            # one committed token a step; the draft tables stay on their
            # slots (host state nothing reads)
            self.spec_bypass = True
            self.spec_fallback_reason = f"degraded: {reason}"
            self.metrics.on_spec_disable(reason)
        else:
            raise ValueError(f"unknown subsystem {subsystem!r}")
        self.health.degraded = True
        self.metrics.on_degrade(subsystem, self.ladder.level, reason)

    def _quarantine(self, reason: str) -> None:
        """The retry budget is spent: fail the in-flight requests (their
        device state is suspect), rebuild the device plane, keep the
        queued requests for the new one.  The rebuild raises through
        ``step()``: a sticky CUDA error is not recoverable in-process."""
        step_i = self._step_in_flight
        q = self.health.enter_quarantine(reason)
        try:
            self.metrics.on_quarantine("enter", reason, step=step_i)
            now = time.perf_counter()
            for st in list(self._prefills):
                self._abort_prefill(st, "failed", f"quarantine: {reason}")
            for slot in list(self._slots):
                req = self._slots[slot].req
                if not req.finished:
                    self._finalize(req, "failed", f"quarantine: {reason}",
                                   now=now)
                elif req.status is None:
                    # finished normally (eos / length) this very step and
                    # not yet evicted: settle it as finished
                    self._finalize(req, "finished", req.finish_reason,
                                   now=now)
                self._release_slot(slot, now)
            self._rebuild_device_plane()
            if self.health.circuit_open:
                self._open_circuit(reason)
        finally:
            seconds = self.health.leave_quarantine(q)
            self.metrics.on_quarantine("leave", reason, step=step_i,
                                       seconds=seconds)

    def _open_circuit(self, reason: str) -> None:
        """Too many quarantines inside the breaker's window: stop
        flapping.  Everything queued fails, ``submit`` rejects with
        ``circuit_open`` and ``step`` does nothing; an operator replaces
        the engine."""
        self.metrics.tracer.event("circuit_open",
                                  lane=self.metrics.engine_lane,
                                  reason=reason[:200],
                                  step=self._step_in_flight)
        while self.scheduler.waiting:
            req = self.scheduler.waiting.popleft()
            self._finalize(req, "failed", f"circuit open: {reason}")

    def _emit(self, slot: int, tok: int, first_token: bool = False) -> None:
        st = self._slots[slot]
        req = st.req
        req.tokens.append(tok)
        if st.draft is not None:
            # the n-gram table learns every COMMITTED token, after the
            # step's readback
            st.draft.observe(tok)
        self.progress_counter += 1              # token out = progress
        now = time.perf_counter()
        if first_token:
            req.first_token_time = now
            self.metrics.on_first_token(req.arrival_time, now=now)
            tracer = self.metrics.tracer
            if tracer.enabled:
                lane = self._lane(req)
                tracer.add_span("prefill", lane,
                                req.admit_time or req.arrival_time, now,
                                chunks=req.prefill_chunks,
                                hit_tokens=req.prefix_hit_tokens)
                tracer.event("first_token", lane=lane, t=now)
        elif req.last_token_time is not None:
            self.metrics.on_output_token(now - req.last_token_time)
        req.last_token_time = now
        if req.stream is not None:
            try:
                req.stream(req, tok)
            except Exception as e:
                # the client's sink broke, not the engine: under the
                # watchdog fail exactly this request (its token is
                # recorded); a retry would re-run a step every other slot
                # has already advanced
                if not self.fault_tolerant:
                    raise
                self.metrics.on_fault("stream", repr(e),
                                      step=self._step_in_flight)
                self._finalize(req, "failed",
                               f"stream callback raised: {e!r}")
                return
        eos = req.eos_token_id
        if eos is not None and tok == eos:
            req.finished, req.finish_reason = True, "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finished, req.finish_reason = True, "length"

    def _harvest(self, slot: int, tok: int) -> int:
        st = self._slots.get(slot)
        if st is None:
            return 0  # reentrantly cancelled by a callback mid-harvest
        if st.req.finished:
            return 0  # finished at admit (eos/length on the first token)
        if tok == NONFINITE_SENTINEL:
            # fail exactly the implicated request; the slot is reclaimed
            # by _evict_finished this same step
            self.metrics.on_fault("nan_logits",
                                  f"non-finite logits in decode "
                                  f"(slot {slot})",
                                  step=self._step_in_flight)
            self._finalize(st.req, "failed", "non-finite logits in decode")
            return 0
        st.pos += 1
        self._emit(slot, tok)
        return 1

    def _harvest_window(self, slot: int, toks) -> int:
        """Commit one slot's verify window — its accepted draft prefix
        plus the bonus token — through the same per-token path as
        sequential decode (:meth:`_harvest`), in order.  The loop stops
        where the sequential engine would have stopped stepping: eos /
        length, the non-finite sentinel, a reentrant cancel.  A truncated
        tail is dropped: the slot is evicted this same step, so its device
        state (advanced by the whole accepted length) is never read
        again."""
        emitted = 0
        for tok in toks:
            st = self._slots.get(slot)
            if st is None or st.req.finished:
                break
            got = self._harvest(slot, int(tok))
            if got == 0:
                break              # the sentinel failed the request
            emitted += got
        return emitted

    # --------------------------------------------- terminal dispositions
    def _finalize(self, req: Request, status: str, reason: str,
                  now: Optional[float] = None) -> None:
        """Stamp one request's TERMINAL disposition — exactly once per
        request.  Does NOT touch slots/pins: the call site owns whatever
        unwinding its state demands."""
        if req.finished and req.status is not None:
            return                        # already terminal (idempotent)
        if now is None:
            now = time.perf_counter()
        req.finished = True
        req.status = status
        req.status_reason = reason
        req.finish_time = now
        self.progress_counter += 1        # a disposition is progress
        if status == "finished":
            self.metrics.on_finish()
        else:
            self.metrics.on_terminal(status, reason, req.request_id,
                                     now=now)
        if self.journal is not None:
            # exactly ONE terminal record a request: the guard above makes
            # this the only stamping path
            self._journal_hwm.pop(req.request_id, None)
            self.journal.append_terminal(req.request_id, status, reason,
                                         delivered=len(req.tokens))
        tracer = self.metrics.tracer
        if tracer.enabled:
            lane = self._lane(req)
            if req.first_token_time is not None:
                tracer.add_span("decode", lane, req.first_token_time, now,
                                tokens=len(req.tokens))
            tracer.add_span("request", lane, req.arrival_time, now,
                            tokens=len(req.tokens),
                            finish_reason=req.finish_reason or req.status)

    def _clear_row(self, slot: int) -> None:
        self._gens[slot] = None
        self._do_sample[slot] = False
        if not self._mask_host[slot].all():
            self._mask_host[slot] = True      # constrained row retires
            self._mask_dirty = True

    def _release_slot(self, slot: int, now: float) -> Request:
        """Return one occupied slot's resources — scheduler entry, radix
        pin, pool slot, sampling row — in one place."""
        req = self.scheduler.release(slot)
        st = self._slots.pop(slot)
        if st.match is not None:
            self.prefix_cache.release(st.match)
        self.pool.free(slot)
        self._clear_row(slot)
        tracer = self.metrics.tracer
        if tracer.enabled:
            tracer.event("slot_release", lane=self.metrics.engine_lane,
                         t=now, slot=slot, request=req.request_id,
                         reason=req.status_reason or req.finish_reason)
        return req

    def _abort_prefill(self, st: _Prefill, status: str,
                       reason: str) -> None:
        """Unwind one MID-PREFILL request (cancel / deadline): drop it
        from the prefill queue, return its slot and radix pin, stamp the
        terminal status.  The staging lane stays: the next head reloads
        it before its first chunk."""
        if st in self._prefills:
            self._prefills.remove(st)
        self._slots.pop(st.slot, None)
        if st.match is not None:
            self.prefix_cache.release(st.match)
        self.scheduler.release(st.slot)
        self.pool.free(st.slot)
        self._clear_row(st.slot)
        self._finalize(st.req, status, reason)

    def cancel(self, request_id: int, status: str = "cancelled",
               reason: str = "cancelled by client") -> bool:
        """Unwind one request in ANY state — queued, mid-prefill, or
        decoding — freeing its slot and radix pin at once.
        Returns True when it was found in flight (False: unknown or
        already terminal)."""
        req = self.scheduler.remove_waiting(request_id)
        if req is not None:
            self._finalize(req, status, reason)
            return True
        for st in list(self._prefills):
            if st.req.request_id == request_id:
                self._abort_prefill(st, status, reason)
                return True
        for slot, sl in list(self._slots.items()):
            if sl.req.request_id == request_id and not sl.req.finished:
                now = time.perf_counter()
                self._finalize(sl.req, status, reason, now=now)
                self._release_slot(slot, now)
                return True
        return False

    def _expire_deadlines(self, now: float) -> None:
        """Per-step deadline sweep (armed once any request carried a
        deadline): queued requests past their budget never take a slot;
        in-flight ones unwind like a cancel, status
        ``deadline_exceeded``."""
        for req in self.scheduler.expired_waiting(now):
            self._finalize(req, "deadline_exceeded",
                           req.deadline_violation(now) or
                           "deadline exceeded", now=now)
        for st in list(self._prefills):
            v = st.req.deadline_violation(now)
            if v is not None:
                self._abort_prefill(st, "deadline_exceeded", v)
        for slot, sl in list(self._slots.items()):
            if sl.req.finished:
                continue
            v = sl.req.deadline_violation(now)
            if v is not None:
                self._finalize(sl.req, "deadline_exceeded", v, now=now)
                self._release_slot(slot, now)

    # ------------------------------------------------ submit-time gates
    def check_admission(self, req: Request) -> None:
        """Submit-time backpressure: fail fast once the circuit is open,
        bounded queue (``max_queue``), and SLO-aware rejection when the
        projected TTFT already exceeds the request's deadline.  Raises
        :class:`RequestRejected` with a live-metrics retry hint."""
        if self.fault_tolerant and self.health.circuit_open:
            self._reject(req, "circuit_open", None)
        if self.max_queue is not None \
                and self.scheduler.queue_depth >= self.max_queue:
            excess = self.scheduler.queue_depth - self.max_queue + 1
            self._reject(req, "queue_full",
                         self.metrics.retry_after_hint(excess))
        if req.ttft_deadline_s is not None:
            projected = self.metrics.projected_ttft_s(
                self.scheduler.queue_depth)
            if projected is not None and projected > req.ttft_deadline_s:
                self._reject(req, "slo_unattainable",
                             self.metrics.retry_after_hint())
        if req.deadline_s is not None or req.ttft_deadline_s is not None:
            self._deadlines_possible = True

    def _reject(self, req: Request, reason: str,
                retry_after_s: Optional[float]) -> None:
        req.finished = True
        req.status = "rejected"
        req.status_reason = reason
        req.finish_time = time.perf_counter()
        self.metrics.on_terminal("rejected", reason, req.request_id)
        raise RequestRejected(reason, retry_after_s)

    def _evict_finished(self) -> None:
        for slot in [s for s, st in self._slots.items() if st.req.finished]:
            now = time.perf_counter()
            req = self._release_slot(slot, now)
            if req.status is None:
                # normal completion (eos/length); abnormal statuses were
                # settled at their _finalize site
                self._finalize(req, "finished", req.finish_reason, now=now)

    # ----------------------------------------------------- conveniences
    def stall_snapshot(self) -> Dict[str, object]:
        """Host-state diagnostic attached to
        :class:`~paddle_tpu_torch.serving.errors.EngineStalledError`."""
        return {
            "queue_depth": self.scheduler.queue_depth,
            "active": self.scheduler.active,
            "mid_prefill": len(self._prefills),
            "free_slots": self.pool.free_slots,
            "free_blocks": None if self.block_pool is None
            else self.block_pool.free_blocks,
            "seq_pos": self.pool.seq_pos.cpu().tolist(),
            "health": self.health.state,
            "degraded_subsystems": list(self.ladder.disabled_subsystems),
            "progress_counter": self.progress_counter,
            "steps": self._step_index,
            "speculation": self.spec_on and not self.spec_bypass,
        }

    def run_until_complete(self, max_steps: Optional[int] = None,
                           stall_steps: Optional[int] = 64) -> int:
        """Step until queue and slots drain; returns steps taken.
        ``stall_steps`` consecutive steps without progress while work is
        queued raise :class:`EngineStalledError` (None disables)."""
        steps = 0
        stalled = 0
        last_progress = self.progress_counter
        while self.scheduler.has_work():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"serving did not drain within {max_steps} steps")
            self.step()
            steps += 1
            if self.progress_counter != last_progress:
                last_progress = self.progress_counter
                stalled = 0
            else:
                stalled += 1
                if stall_steps is not None and stalled >= stall_steps \
                        and self.scheduler.has_work():
                    raise EngineStalledError(stalled,
                                             self.stall_snapshot())
        return steps
