"""The MoE stack under its reference path (counterpart of
paddle_tpu/incubate/distributed/models/moe/__init__.py)."""

from .....distributed.moe import (  # noqa: F401
    BaseGate, ExpertFFN, GShardGate, MoELayer, NaiveGate, SwitchGate,
    assign_pos, limit_by_capacity, number_count, prune_gate_by_capacity)

__all__ = ["MoELayer", "ExpertFFN", "NaiveGate", "GShardGate", "SwitchGate",
           "BaseGate", "number_count", "limit_by_capacity",
           "prune_gate_by_capacity", "assign_pos"]
