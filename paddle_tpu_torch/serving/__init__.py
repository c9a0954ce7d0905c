"""Continuous-batching serving (counterpart of paddle_tpu/serving): the
engine on one card or a tensor-parallel mesh, and the fleet tier over
several engines (router, KV handoff, autoscaler)."""

from .aot import (AOTStore, AOTStoreError, AOTStoreWriter,
                  aot_fingerprint, build_engine_store, engine_aot_context)
from .api import RequestOutput, ServingEngine
from .autoscaler import Autoscaler
from .engine import (NONFINITE_SENTINEL, EngineCore, finite_or_sentinel,
                     sample_rows)
from .errors import EngineStalledError, RequestRejected
from .faults import POINTS, FaultError, FaultInjector
from .fleet import fleet_accounting, replica_accounting
from .handoff import Handoff, HandoffManager
from .health import (DegradationLadder, EngineHealth, FaultToleranceConfig,
                     SUBSYSTEMS)
from .journal import RECORD_KINDS, Journal, JournalError
from .kv_pool import BlockPool, KVPool
from .metrics import ServingMetrics
from .prefix_cache import MatchResult, PrefixCache
from .router import ReplicaHandle, Router
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
           "DegradationLadder", "EngineHealth", "SUBSYSTEMS",
           # the durable request journal and the AOT store
           "Journal", "JournalError", "RECORD_KINDS", "AOTStore",
           "AOTStoreWriter", "AOTStoreError", "build_engine_store",
           "engine_aot_context", "aot_fingerprint",
           # the fleet tier
           "Router", "ReplicaHandle", "fleet_accounting",
           "replica_accounting", "Autoscaler", "Handoff", "HandoffManager"]
