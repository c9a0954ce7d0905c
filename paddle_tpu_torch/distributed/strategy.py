"""``DistributedStrategy``, the user-facing parallelism config (counterpart
of paddle_tpu/distributed/strategy.py).

A plain config tree with the reference's field names.  ``hybrid_configs``
decides the topology ``fleet.init`` builds; the other fields are recorded
so that fleet scripts run, and nothing reads them here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

__all__ = ["DistributedStrategy"]


@dataclasses.dataclass
class _HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1
    pp_configs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mp_configs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class DistributedStrategy:
    def __init__(self):
        self._hybrid = _HybridConfig()
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"init_loss_scaling": 65536.0,
                                            "use_pure_fp16": False,
                                            "use_bf16": True}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"stage": 1}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "schedule_mode": "1F1B"}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.dgc_configs: Dict[str, Any] = {"rampup_begin_step": 0,
                                            "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs: Dict[str, Any] = {"k_steps": 1,
                                                 "begin_step": 1}
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {}
        self.heter_ccl_mode = False
        self.without_graph_optimization = False

    @property
    def hybrid_configs(self) -> Dict[str, Any]:
        return dataclasses.asdict(self._hybrid)

    @hybrid_configs.setter
    def hybrid_configs(self, cfg: Dict[str, Any]):
        for k, v in cfg.items():
            if not hasattr(self._hybrid, k):
                raise ValueError(f"unknown hybrid config {k!r}")
            setattr(self._hybrid, k, v)

    def __repr__(self) -> str:
        h = self._hybrid
        return (f"DistributedStrategy(hybrid=dp{h.dp_degree}/mp{h.mp_degree}/"
                f"pp{h.pp_degree}/sharding{h.sharding_degree}/"
                f"sep{h.sep_degree}/ep{h.ep_degree},"
                f" amp={self.amp}, recompute={self.recompute})")
