"""Profiler: a host event tree plus ``torch.profiler`` as the device trace
(counterpart of paddle_tpu/profiler/profiler.py).

Reference symbols kept 1:1: ``Profiler(targets, scheduler,
on_trace_ready, timer_only)``, ``ProfilerState`` (CLOSED / READY / RECORD
/ RECORD_AND_RETURN), ``make_scheduler``, ``RecordEvent``,
``export_chrome_tracing``, ``summary()``, and the trace sources other
layers merge into every chrome export (the serving tracer's request
lanes).

The device side is ``torch.profiler`` (CPU activity, and CUDA activity
for a GPU target) where the reference starts ``jax.profiler``; each record
window writes its trace to ``trace_dir`` as the reference's does, and the
chrome export merges its events (kernels, runtime calls, the
``RecordEvent`` ranges) after the host events.  Those keep the
profiler's own clock and process id, so they sit on rows of their own.

Unlike the reference, nothing falls back quietly: a GPU target on a host
with no CUDA device raises (use ``targets=[ProfilerTarget.CPU]``), and a
``torch.profiler`` start that fails raises.  ``timer_only=True`` records
host events only, as in the reference.
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "export_protobuf", "RecordEvent",
           "load_profiler_result", "register_trace_source",
           "unregister_trace_source"]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class _HostEvent:
    __slots__ = ("name", "start_us", "end_us", "tid")

    def __init__(self, name, start_us, end_us, tid):
        self.name = name
        self.start_us = start_us
        self.end_us = end_us
        self.tid = tid


class _HostTracer:
    """Collects ``RecordEvent`` intervals (reference: C++ HostTracer)."""

    def __init__(self):
        self.events: List[_HostEvent] = []
        self._lock = threading.Lock()
        self.enabled = False

    def add(self, ev: _HostEvent):
        if self.enabled:
            with self._lock:
                self.events.append(ev)

    def clear(self):
        with self._lock:
            self.events = []


_tracer = _HostTracer()

# chrome-event providers merged into every export: each is a zero-argument
# callable returning catapult event dicts (the obs tracer registers its
# chrome_events, so request lanes render beside the host phases)
_trace_sources: List[Callable[[], List[dict]]] = []


def register_trace_source(source: Callable[[], List[dict]]) -> None:
    """Merge ``source()``'s chrome events into every later export
    (registering the same callable twice is a no-op; pair it with
    :func:`unregister_trace_source`)."""
    if source not in _trace_sources:
        _trace_sources.append(source)


def unregister_trace_source(source: Callable[[], List[dict]]) -> None:
    try:
        _trace_sources.remove(source)
    except ValueError:
        pass


class RecordEvent:
    """A named host range (reference: ``paddle.profiler.RecordEvent``),
    forwarded to ``torch.profiler.record_function`` so the device trace
    carries the same name around the kernels launched inside it."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._start = None
        self._range = None

    def begin(self):
        self._start = time.perf_counter_ns() // 1000
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def end(self):
        if self._start is None:
            return
        end = time.perf_counter_ns() // 1000
        _tracer.add(_HostEvent(self.name, self._start, end,
                               threading.get_ident()))
        self._range.__exit__(None, None, None)
        self._range = None
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """step number -> state, the cycle ``[skip_first][closed][ready]
    [record ... (the last RECORD_AND_RETURN)]`` repeated ``repeat`` times
    (0: forever)."""
    cycle = closed + ready + record

    def fn(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return fn


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """``on_trace_ready`` callback writing each window's merged chrome
    trace to ``dir_name/<worker>_step<N>.json``."""
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_step{prof.step_num}.json")
        prof._export_chrome(path)
        prof.last_export = path
    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """The reference's alias: the device trace is already written under
    ``trace_dir``; the merged events go as chrome JSON."""
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)


def _activities(targets: Sequence[ProfilerTarget]) -> list:
    from torch.profiler import ProfilerActivity
    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ProfilerTarget.GPU asks for a CUDA trace and no CUDA "
                    "device is available; pass targets=[ProfilerTarget.CPU] "
                    "to profile the host only")
            acts.append(ProfilerActivity.CUDA)
        else:
            raise ValueError(f"{t} has no tracer in the port (targets are "
                             f"ProfilerTarget.CPU and ProfilerTarget.GPU)")
    return list(dict.fromkeys(acts))


class Profiler:
    """Reference: ``paddle.profiler.Profiler``.

    ``targets`` (default: the CPU, and the GPU when a CUDA device is
    present, as the reference's default of every available target)
    picks the ``torch.profiler`` activities; ``scheduler`` is a
    ``make_scheduler`` callable, a ``(start, end)`` step range, or None
    (record every step); ``timer_only=True`` records host events only.
    """

    def __init__(self, *, targets: Optional[Sequence[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, trace_dir: Optional[str] = None,
                 record_shapes: bool = False, profile_memory: bool = False,
                 with_flops: bool = False):
        if scheduler is None:
            self._scheduler = _default_scheduler
        elif callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0,
                                             record=hi - lo, repeat=1)
        else:
            raise ValueError(f"bad scheduler {scheduler!r}")
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        self.targets = list(targets)
        self._acts = _activities(self.targets)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_dir = trace_dir or "profiler_log"
        self._prof_kw = dict(record_shapes=record_shapes,
                             profile_memory=profile_memory,
                             with_flops=with_flops)
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._device_prof = None
        self._averages = None
        self.device_trace: Optional[str] = None
        self.last_export: Optional[str] = None
        self._device_events: Optional[List[dict]] = None

    # ------------------------------------------------------- state machine
    def _transition(self, new_state: ProfilerState):
        old = self.current_state
        if new_state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            if old in (ProfilerState.CLOSED, ProfilerState.READY):
                self._start_record()
        if old in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN) and \
                new_state in (ProfilerState.CLOSED, ProfilerState.READY):
            self._stop_record()
        self.current_state = new_state

    def _start_record(self):
        _tracer.clear()
        self._device_events = None
        self.device_trace = None
        if not self.timer_only:
            if ProfilerTarget.GPU in self.targets \
                    and not torch.profiler.kineto_available():
                raise RuntimeError("torch.profiler has no Kineto tracer in "
                                   "this build: the GPU trace cannot start")
            prof = torch.profiler.profile(activities=self._acts,
                                          **self._prof_kw)
            prof.start()
            self._device_prof = prof
        _tracer.enabled = True

    def _stop_record(self):
        _tracer.enabled = False
        prof, self._device_prof = self._device_prof, None
        if prof is None:
            return
        if ProfilerTarget.GPU in self.targets:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"device_{os.getpid()}_step"
                                            f"{self.step_num}.json")
        prof.export_chrome_trace(path)
        self.device_trace = path
        self._averages = prof.key_averages()

    # ---------------------------------------------------------- public API
    def start(self):
        self._transition(self._scheduler(self.step_num))

    def stop(self):
        was_recording = self.current_state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        self._transition(ProfilerState.CLOSED)
        if was_recording and self.on_trace_ready:
            self.on_trace_ready(self)

    def step(self):
        prev = self.current_state
        self.step_num += 1
        new = self._scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN and self.on_trace_ready:
            # the closing edge of a record window hands the trace out
            if new not in (ProfilerState.RECORD,
                           ProfilerState.RECORD_AND_RETURN):
                self._transition(new)
                self.on_trace_ready(self)
                return
        self._transition(new)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- results
    def events(self) -> List[_HostEvent]:
        return list(_tracer.events)

    def device_events(self) -> List[dict]:
        """The last record window's ``torch.profiler`` chrome events
        (empty under ``timer_only``)."""
        if self._device_events is None:
            if self.device_trace is None:
                self._device_events = []
            else:
                with open(self.device_trace) as f:
                    self._device_events = json.load(f).get("traceEvents", [])
        return self._device_events

    def _export_chrome(self, path: str):
        trace = [{
            "name": e.name, "ph": "X", "ts": e.start_us,
            "dur": max(e.end_us - e.start_us, 1), "pid": os.getpid(),
            "tid": e.tid % 100000, "cat": "host",
        } for e in _tracer.events]
        for source in list(_trace_sources):
            # a broken provider must not lose the rest of the trace; its
            # failure is written into the trace instead
            try:
                trace.extend(source())
            except Exception as e:
                trace.append({"name": "trace_source_error", "ph": "i",
                              "s": "g", "ts": time.perf_counter() * 1e6,
                              "pid": os.getpid(), "tid": 0, "cat": "error",
                              "args": {"error": repr(e)}})
        trace.extend(self.device_events())
        with open(path, "w") as f:
            json.dump({"traceEvents": trace}, f)

    def export(self, path: str, format: str = "json"):
        self._export_chrome(path)

    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms",
                device_rows: int = 15) -> str:
        """The host events by name, then (when a GPU trace was taken) the
        ``device_rows`` kernels and copies with the most device time."""
        agg: Dict[str, List[float]] = {}
        for e in _tracer.events:
            agg.setdefault(e.name, []).append((e.end_us - e.start_us) / 1e3)
        hdr = f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg':>10}" \
              f"{'Max':>10}{'Min':>10}"
        lines = [hdr, "-" * len(hdr)]
        for name, ds in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
            lines.append(f"{name[:39]:<40}{len(ds):>8}{sum(ds):>12.3f}"
                         f"{sum(ds) / len(ds):>10.3f}{max(ds):>10.3f}"
                         f"{min(ds):>10.3f}")
        if ProfilerTarget.GPU in self.targets and self.device_trace:
            dev = _device_totals(self._averages, exclude=set(agg))
            lines += ["", f"{'Device (kernels and copies)':<70}{'Calls':>8}"
                          f"{'Total(ms)':>12}", "-" * 90]
            for name, (n, ms) in sorted(dev.items(),
                                        key=lambda kv: -kv[1][1]
                                        )[:device_rows]:
                lines.append(f"{name[:69]:<70}{n:>8}{ms:>12.3f}")
        table = "\n".join(lines)
        print(table)
        return table


def _device_totals(averages, exclude=()) -> Dict[str, tuple]:
    """``{name: (calls, device ms)}`` of the device entries of
    ``key_averages()`` (the kernels and copies; the ``RecordEvent``
    ranges in ``exclude`` left out)."""
    from torch.autograd import DeviceType
    out = {}
    for a in averages:
        if a.device_type != DeviceType.CUDA or a.key in exclude:
            continue
        us = getattr(a, "self_device_time_total",
                     getattr(a, "self_cuda_time_total", 0.0))
        if us > 0:
            out[a.key] = (a.count, us / 1e3)
    return out
