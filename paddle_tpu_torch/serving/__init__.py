"""Continuous-batching serving on one card (counterpart of
paddle_tpu/serving at tensor-parallel degree 1)."""

from .api import RequestOutput, ServingEngine
from .engine import (NONFINITE_SENTINEL, EngineCore, finite_or_sentinel,
                     sample_rows)
from .errors import EngineStalledError, RequestRejected
from .faults import POINTS, FaultError, FaultInjector
from .health import (DegradationLadder, EngineHealth, FaultToleranceConfig,
                     SUBSYSTEMS)
from .kv_pool import BlockPool, KVPool
from .metrics import ServingMetrics
from .prefix_cache import MatchResult, PrefixCache
from .scheduler import (PRIORITIES, Request, SamplingParams, Scheduler,
                        bucket_length)
from .spec import NGramDraftTable

__all__ = ["ServingEngine", "RequestOutput", "EngineCore", "sample_rows",
           "finite_or_sentinel", "NONFINITE_SENTINEL", "EngineStalledError",
           "RequestRejected", "KVPool", "BlockPool", "ServingMetrics",
           "PrefixCache", "MatchResult", "PRIORITIES", "Request",
           "SamplingParams", "Scheduler", "bucket_length",
           # speculative decoding
           "NGramDraftTable",
           # fault tolerance
           "FaultError", "FaultInjector", "POINTS", "FaultToleranceConfig",
           "DegradationLadder", "EngineHealth", "SUBSYSTEMS"]
