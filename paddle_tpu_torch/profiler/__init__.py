"""Profiler facade (counterpart of paddle_tpu/profiler).

The reference's user API (``Profiler`` with its scheduler states,
``step()``, ``on_trace_ready``, ``summary()``, ``RecordEvent``,
``export_chrome_tracing``) over the port's own host event tree, with
``torch.profiler`` as the device side where the reference has
``jax.profiler``.
"""

from .profiler import (Profiler, ProfilerState, ProfilerTarget,
                       RecordEvent, export_chrome_tracing, export_protobuf,
                       load_profiler_result, make_scheduler,
                       register_trace_source, unregister_trace_source)

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "export_protobuf", "RecordEvent",
           "load_profiler_result", "register_trace_source",
           "unregister_trace_source"]
