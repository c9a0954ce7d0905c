"""Durable request journal: the crash-consistency layer of serving (the
port's own copy of paddle_tpu/serving/journal.py; host code only, and
byte-compatible with it: a journal written by either package opens in
the other to the same ``ledger()`` and ``replay()``).

Everything else in ``serving/`` is fault-tolerant *within* a live
process (retries, the degradation ladder, the quarantine rebuild), but a
process crash (an OOM kill, a host preemption) loses every queued and
in-flight request, because nothing persists.  The :class:`Journal` is
the write-ahead log that closes the gap: an append-only, CRC-framed,
segment-rotated record of every request's lifecycle, durable enough that
a fresh process can serve again what the dead one had accepted and not
settled (``replay()``).

Record kinds (one JSON payload per CRC frame):

  * ``submit``   -- everything needed to run the request again from
    zero: prompt token ids, ``max_new_tokens``, the full sampling spec
    INCLUDING the seed (each request draws from its own seeded
    generator, so a replayed request gives the same tokens, greedy or
    sampled), eos token, deadlines, and the submit WALL-CLOCK time
    (``time.time()``: the only clock that survives a process death);
  * ``progress`` -- the delivered high-water marks of every request that
    advanced this step, batched into ONE record; a replay drops the
    positions at or below the journaled mark, so a client sees each
    recorded position at most once;
  * ``terminal`` -- the request's final status + reason (+ final
    delivered mark).  Exactly one terminal record per submit, across
    process incarnations, is the ledger's conservation invariant.

Framing: every record is ``<u32 payload_len> <u32 crc32(payload)>
<payload>`` appended to the active segment file ``wal-%08d.seg``.  On
open the journal scans all segments in order, folds the replay state,
and TRUNCATES a torn tail (a crash mid-write leaves a half-frame;
everything before it is intact).  A torn frame in a NON-final segment is
real corruption (sealed segments were fsynced whole) and raises.

Durability:

  * ``submit`` and ``terminal`` records force an fsync: an accepted
    request is never silently forgotten, a settled one never comes back;
  * ``progress`` records batch: fsync every ``fsync_batch`` appends (a
    crash may lose the tail of the delivered marks; a replay then
    delivers those positions again, with the same tokens);
  * segment rotation (``segment_bytes``) seals the active segment
    (flush + fsync + close) and begins a fresh one;
  * ``compact()`` deletes sealed segments whose every request is
    terminal, so the journal's size follows the live requests, not the
    history.

Fault containment: the ``journal_write`` / ``journal_fsync`` injection
points (serving/faults.py) drive the chaos tests.  A failed append is
queued and retried on the next append or flush (the serving loop never
fails a request because its journal write did); a failed fsync leaves
the bytes in the OS cache and the next fsync covers them.
``journal_replay`` fires during the open scan: a single fault retries
the scan from scratch (it has no side effects), a persistent one raises
:class:`JournalError` with nothing half-recovered.

No cost when off: every caller guards with ``if journal is None``, and
the journal holds no device tensor.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["Journal", "JournalError", "RECORD_KINDS"]

RECORD_KINDS = ("submit", "progress", "terminal")

_HEADER = struct.Struct("<II")          # payload_len, crc32(payload)
# corruption guard: a torn header can decode to any u32 — refuse to
# allocate absurd buffers for a length no sane record reaches
_MAX_PAYLOAD = 64 * 1024 * 1024
_SEGMENT_FMT = "wal-{:08d}.seg"


class JournalError(RuntimeError):
    """Raised on unrecoverable journal state: corruption inside a
    SEALED segment, or a replay that keeps failing after retries."""


class _Ledger:
    """Folded per-request journal state (the replay input AND the
    conservation ledger)."""

    __slots__ = ("submits", "terminals", "delivered", "status", "reason",
                 "record", "plan_start")

    def __init__(self):
        self.submits = 0
        self.terminals = 0
        self.delivered = 0
        self.status: Optional[str] = None
        self.reason: Optional[str] = None
        self.record: Optional[dict] = None   # the submit payload
        self.plan_start: Optional[int] = None  # the router's, see below

    @property
    def terminal(self) -> bool:
        return self.terminals > 0


class Journal:
    """Append-only CRC-framed request WAL over a directory of rotated
    segment files (see module docstring).  Pair ``Journal.open`` with
    ``close``: a journal left open holds an OS file handle and an
    unflushed tail.

    ``fsync=False`` turns the durability off (unit tests on tmpfs);
    ``faults`` arms the ``journal_*`` chaos points — None in
    production."""

    def __init__(self, path: str, *, segment_bytes: int = 1 << 20,
                 fsync_batch: int = 8, fsync: bool = True,
                 faults=None, replay_retries: int = 1):
        if segment_bytes < 4096:
            raise ValueError("segment_bytes must be >= 4096")
        if fsync_batch < 1:
            raise ValueError("fsync_batch must be >= 1")
        self.path = path
        self.segment_bytes = segment_bytes
        self.fsync_batch = fsync_batch
        self.fsync = fsync
        self.faults = faults
        self.replay_retries = replay_retries
        # plain-int stats (metrics bind lazily via bind_metrics)
        self.records_appended = 0
        self.bytes_appended = 0
        self.fsyncs = 0
        self.write_failures = 0
        self.fsync_failures = 0
        self.segments_sealed = 0
        self.compacted_segments = 0
        self.truncated_bytes = 0
        self.replay_retries_used = 0
        self._metrics = None
        # (frame, record-ids, force-sync) triples whose write raised
        # (journal_write chaos / real IO error): retried before every
        # later append and on flush — the serving loop never loses a
        # record to a transient write fault, and a pended
        # submit/terminal keeps its forced-fsync durability class when
        # it finally lands
        self._pending: List[Tuple[bytes, set, bool]] = []
        self._unsynced = 0
        self._closed = False
        self.state: Dict[int, _Ledger] = {}
        # per-segment id set: a sealed segment is compactable once every
        # request recorded in it is terminal
        self._segment_ids: Dict[str, set] = {}
        os.makedirs(path, exist_ok=True)
        self._segments = sorted(
            f for f in os.listdir(path)
            if f.startswith("wal-") and f.endswith(".seg"))
        self._replay_scan()
        if self._segments:
            active = self._segments[-1]
            self._fh = open(os.path.join(path, active), "ab", buffering=0)
        else:
            self._segments = [_SEGMENT_FMT.format(1)]
            self._segment_ids[self._segments[-1]] = set()
            self._fh = open(os.path.join(path, self._segments[-1]), "ab", buffering=0)

    # ------------------------------------------------------------ open
    @classmethod
    def open(cls, path: str, **kw) -> "Journal":
        """Open (creating if missing) the journal at ``path``: scan all
        segments, fold the replay state, truncate any torn tail, and
        position for append.  Balance with :meth:`close` on every
        path."""
        return cls(path, **kw)

    def _replay_scan(self) -> None:
        """Fold every on-disk record into ``self.state``, with the
        ``journal_replay`` chaos point firing per record.  The scan has
        no side effects until it finishes, so a replay fault retries
        from scratch; persistent failure raises with nothing
        half-folded."""
        last_exc: Optional[Exception] = None
        for attempt in range(self.replay_retries + 1):
            if attempt:
                self.replay_retries_used += 1
            try:
                state: Dict[int, _Ledger] = {}
                seg_ids: Dict[str, set] = {}
                for i, seg in enumerate(self._segments):
                    ids = seg_ids.setdefault(seg, set())
                    final = i == len(self._segments) - 1
                    for rec in self._scan_segment(seg, truncate=final):
                        if self.faults is not None:
                            self.faults.fire("journal_replay")
                        self._fold(rec, state, ids)
                self.state = state
                self._segment_ids = seg_ids
                return
            except JournalError:
                raise
            except Exception as e:
                last_exc = e
        raise JournalError(
            f"journal replay failed after {self.replay_retries + 1} "
            f"attempts: {last_exc!r}") from last_exc

    def _scan_segment(self, seg: str, truncate: bool) -> Iterator[dict]:
        """Yield every intact record of one segment file.  A torn tail
        (short header, short payload, or CRC mismatch at the END of the
        file) is truncated away when ``truncate`` (the active segment —
        a crash mid-append is expected); the same damage in a sealed
        segment is corruption and raises."""
        full = os.path.join(self.path, seg)
        if not os.path.exists(full):
            return
        with open(full, "rb") as fh:
            data = fh.read()
        off, n = 0, len(data)
        good = 0
        while off < n:
            if off + _HEADER.size > n:
                break                               # torn header
            length, crc = _HEADER.unpack_from(data, off)
            if length > _MAX_PAYLOAD:
                break                               # garbage length
            end = off + _HEADER.size + length
            if end > n:
                break                               # torn payload
            payload = data[off + _HEADER.size:end]
            if zlib.crc32(payload) != crc:
                break                               # torn/corrupt frame
            try:
                rec = json.loads(payload)
            except ValueError:
                break                               # CRC ok, body not
            off = end
            good = off
            yield rec
        if good < n:
            if not truncate:
                raise JournalError(
                    f"corrupt frame at byte {good} of sealed segment "
                    f"{seg} — sealed segments were fsynced whole; this "
                    f"is real damage, not a torn tail")
            self.truncated_bytes += n - good
            with open(full, "ab", buffering=0) as fh:
                fh.truncate(good)

    @staticmethod
    def _fold(rec: dict, state: Dict[int, _Ledger],
              ids: Optional[set] = None) -> None:
        kind = rec.get("kind")
        if kind == "progress":
            for rid, hwm in rec.get("delivered", {}).items():
                led = state.setdefault(int(rid), _Ledger())
                led.delivered = max(led.delivered, int(hwm))
                if ids is not None:
                    ids.add(int(rid))
            for rid, start in rec.get("plan_start", {}).items():
                state.setdefault(int(rid), _Ledger()).plan_start = int(start)
            return
        rid = int(rec["id"])
        led = state.setdefault(rid, _Ledger())
        if ids is not None:
            ids.add(rid)
        if kind == "submit":
            led.submits += 1
            led.record = rec
        elif kind == "terminal":
            led.terminals += 1
            led.status = rec.get("status")
            led.reason = rec.get("reason")
            if rec.get("delivered") is not None:
                led.delivered = max(led.delivered, int(rec["delivered"]))

    # ---------------------------------------------------------- append
    def append_submit(self, request_id: int, prompt, max_new_tokens: int,
                      sampling: Optional[dict] = None,
                      eos_token_id: Optional[int] = None,
                      deadline_s: Optional[float] = None,
                      ttft_deadline_s: Optional[float] = None,
                      wall_time: Optional[float] = None,
                      priority: str = "interactive") -> None:
        """Journal one accepted submission (forces a sync: an accepted
        request must survive the very next crash).  ``sampling`` is the
        plain-dict sampling spec INCLUDING the seed; ``wall_time``
        defaults to ``time.time()`` — the downtime clock recovery
        charges deadlines against."""
        self._append({
            "kind": "submit", "id": int(request_id),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "sampling": sampling,
            "eos_token_id": None if eos_token_id is None
            else int(eos_token_id),
            "deadline_s": None if deadline_s is None
            else float(deadline_s),
            "ttft_deadline_s": None if ttft_deadline_s is None
            else float(ttft_deadline_s),
            "wall_time": time.time() if wall_time is None
            else float(wall_time),
            # priority class survives the crash so a recovered batch
            # request is still sheddable (old journals lack the key —
            # readers default it to "interactive")
            "priority": str(priority),
        }, sync=True)

    def append_progress(self, delivered: Dict[int, int],
                        plan_starts: Optional[Dict[int, int]] = None
                        ) -> None:
        """Journal this step's delivered high-water marks — ONE record
        for the whole batch, synced only at the ``fsync_batch``
        cadence.  ``plan_starts`` carries a fleet request's chunk-plan
        start with its first delivered mark, so a recovery regenerates
        it in the same chunks."""
        if not delivered:
            return
        rec = {"kind": "progress",
               "delivered": {str(k): int(v) for k, v in delivered.items()}}
        if plan_starts:
            rec["plan_start"] = {str(k): int(v)
                                 for k, v in plan_starts.items()}
        self._append(rec, sync=False)

    def append_terminal(self, request_id: int, status: str, reason: str,
                        delivered: Optional[int] = None) -> None:
        """Journal one terminal disposition (forces a sync: a settled
        request must never be replayed by the next incarnation)."""
        self._append({"kind": "terminal", "id": int(request_id),
                      "status": status, "reason": str(reason)[:500],
                      "delivered": delivered}, sync=True)

    def _append(self, rec: dict, sync: bool) -> None:
        if self._closed:
            raise JournalError("journal is closed")
        payload = json.dumps(rec, separators=(",", ":")).encode()
        frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        # the folded state advances even when the physical write defers
        # to the pending queue — the bytes WILL land (retried every
        # later append/flush), and the live process must see its own
        # writes immediately.  Segment attribution happens inside
        # _write, AFTER any rotation, so compact() can never delete a
        # sealed segment that physically holds a live record.
        rec_ids: set = set()
        self._fold(rec, self.state, rec_ids)
        # a retried submit/terminal frame that lands NOW still owes its
        # forced fsync — durability class travels with the frame
        force = self._retry_pending()
        try:
            self._write(frame, rec_ids)
        except Exception:
            self.write_failures += 1
            if self._metrics is not None:
                self._metrics["write_failures"].inc()
            self._pending.append((frame, rec_ids, sync))
            if force:
                self._sync()
            return
        self._unsynced += 1
        if sync or force or self._unsynced >= self.fsync_batch:
            self._sync()

    def _write(self, frame: bytes, rec_ids: set) -> None:
        if self.faults is not None:
            self.faults.fire("journal_write")
        if self._fh.tell() + len(frame) > self.segment_bytes \
                and self._fh.tell() > 0:
            self.seal_segment()
            self.begin_segment()
        self._fh.write(frame)
        # attributed to the segment the frame actually LANDED in —
        # rotation above may have changed the active segment
        self._segment_ids[self._segments[-1]].update(rec_ids)
        self.records_appended += 1
        self.bytes_appended += len(frame)
        if self._metrics is not None:
            self._metrics["records"].inc()
            self._metrics["bytes"].inc(len(frame))

    def _retry_pending(self) -> bool:
        """Drain the pending-write queue; returns True when any landed
        frame carried the forced-fsync class (the caller must sync)."""
        force = False
        while self._pending:
            frame, rec_ids, sync = self._pending[0]
            try:
                self._write(frame, rec_ids)
            except Exception:
                return force            # still failing; keep the queue
            self._pending.pop(0)
            self._unsynced += 1
            force |= sync
        return force

    def _sync(self) -> None:
        """Flush python buffers and fsync the active segment.  A failed
        fsync is counted and retried implicitly: the bytes stay in the
        OS cache and the NEXT sync covers them (fsync is cumulative)."""
        try:
            self._fh.flush()
            if self.faults is not None:
                self.faults.fire("journal_fsync")
            if self.fsync:
                os.fsync(self._fh.fileno())
            self.fsyncs += 1
            self._unsynced = 0
            if self._metrics is not None:
                self._metrics["fsyncs"].inc()
        except Exception:
            self.fsync_failures += 1
            if self._metrics is not None:
                self._metrics["fsync_failures"].inc()

    def flush(self) -> None:
        """Drain the pending-write queue and fsync whatever is
        buffered (no-op on a closed/crashed journal — there is nothing
        left to make durable)."""
        if self._closed:
            return
        self._retry_pending()
        if self._unsynced or self._pending:
            self._sync()

    # -------------------------------------------------------- segments
    @property
    def segments(self) -> Tuple[str, ...]:
        return tuple(self._segments)

    def begin_segment(self) -> str:
        """Open a fresh active segment (the rotation's second half).
        Balance with :meth:`seal_segment` (a begun segment left
        unsealed at rotation time would interleave two active tails)."""
        seq = int(self._segments[-1][4:-4]) + 1 if self._segments else 1
        name = _SEGMENT_FMT.format(seq)
        self._segments.append(name)
        self._segment_ids[name] = set()
        self._fh = open(os.path.join(self.path, name), "ab", buffering=0)
        if self._metrics is not None:
            self._metrics["segments"].set(len(self._segments))
        return name

    def seal_segment(self) -> None:
        """Close the active segment durably (flush + fsync + close):
        sealed segments are immutable — a torn frame found in one later
        is corruption, not a crash artifact."""
        try:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self.fsyncs += 1
        except Exception:
            self.fsync_failures += 1
        self._fh.close()
        self._unsynced = 0
        self.segments_sealed += 1

    def compact(self) -> int:
        """Delete every SEALED segment whose recorded requests are all
        terminal — replay would skip every one of their records, so the
        bytes are dead weight.  Returns the number of segments
        removed."""
        removed = 0
        for seg in self._segments[:-1]:         # never the active one
            ids = self._segment_ids.get(seg, set())
            if all(self.state.get(i) is not None
                   and self.state[i].terminal for i in ids):
                try:
                    os.unlink(os.path.join(self.path, seg))
                except FileNotFoundError:
                    pass
                self._segments.remove(seg)
                self._segment_ids.pop(seg, None)
                removed += 1
        self.compacted_segments += removed
        if self._metrics is not None and removed:
            self._metrics["compacted"].inc(removed)
            self._metrics["segments"].set(len(self._segments))
        return removed

    # --------------------------------------------------------- reading
    def records(self) -> Iterator[dict]:
        """Re-read every record from disk in order (a FRESH scan — the
        audit view, not the folded state)."""
        for i, seg in enumerate(self._segments):
            yield from self._scan_segment(
                seg, truncate=i == len(self._segments) - 1)

    def replay(self) -> Dict[int, dict]:
        """The recovery input: every NON-terminal submit's journaled
        view — ``{id: {"record": <submit payload>, "delivered": hwm}}``,
        with ``"plan_start"`` where the router journaled one
        (requests with a terminal record are done; progress-only ids —
        their submit record failed to land — cannot be replayed and are
        skipped)."""
        out: Dict[int, dict] = {}
        for rid, led in self.state.items():
            if led.terminal or led.record is None:
                continue
            out[rid] = {"record": dict(led.record),
                        "delivered": led.delivered}
            if led.plan_start is not None:
                # a fleet request's chunk-plan start (the router's)
                out[rid]["plan_start"] = led.plan_start
        return out

    def ledger(self) -> Dict[int, Dict[str, object]]:
        """The conservation ledger: per-request submit/terminal record counts, the delivered
        high-water mark, and the terminal status."""
        return {rid: {"submits": led.submits,
                      "terminals": led.terminals,
                      "delivered": led.delivered,
                      "status": led.status}
                for rid, led in self.state.items()}

    def position(self) -> Dict[str, object]:
        """Where the journal is: the stall / crash diagnostic."""
        return {
            "path": self.path,
            "segment": self._segments[-1] if self._segments else None,
            "segments": len(self._segments),
            "records": self.records_appended,
            "pending_writes": len(self._pending),
            "unsynced": self._unsynced,
            "write_failures": self.write_failures,
            "fsync_failures": self.fsync_failures,
            "live_requests": sum(1 for led in self.state.values()
                                 if not led.terminal),
        }

    # ------------------------------------------------------- lifecycle
    def bind_metrics(self, registry) -> None:
        """Bind the ``journal.*`` instruments into an
        ``obs.MetricsRegistry`` (get-or-create: a shared registry
        aggregates)."""
        c, g = registry.counter, registry.gauge
        self._metrics = {
            "records": c("journal.records",
                         "journal records appended (all kinds)"),
            "bytes": c("journal.bytes", "journal bytes appended"),
            "fsyncs": c("journal.fsyncs", "journal fsync calls issued"),
            "write_failures": c("journal.write_failures",
                                "journal appends that failed and were "
                                "queued for retry"),
            "fsync_failures": c("journal.fsync_failures",
                                "journal fsyncs that failed (bytes stay "
                                "in OS cache; next sync covers them)"),
            "compacted": c("journal.compacted_segments",
                           "fully-terminal sealed segments deleted"),
            "segments": g("journal.segments",
                          "journal segment files currently on disk"),
        }
        self._metrics["segments"].set(len(self._segments))

    def crash(self) -> None:
        """Chaos/test helper: die WITHOUT flushing — pending and
        buffered-but-unsynced writes are dropped on the floor exactly as
        a SIGKILL would drop them.  The on-disk state is whatever the
        durability matrix already guaranteed.  After this the journal
        object is closed; reopen the path to recover."""
        self._pending.clear()
        self._closed = True
        try:
            self._fh.close()
        except Exception:
            pass

    def close(self) -> None:
        """Flush + fsync + close (idempotent)."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        self._fh.close()
