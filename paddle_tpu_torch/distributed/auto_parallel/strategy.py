"""Auto-parallel Strategy config tree (the port's own copy of
paddle_tpu/distributed/auto_parallel/strategy.py).

Reference: python/paddle/distributed/auto_parallel/strategy.py — Strategy
with sub-configs (amp, recompute, sharding, gradient_merge, pipeline...).
Plain dataclasses; the Engine reads ``amp``, ``recompute`` and
``gradient_merge`` (engine.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O2"


@dataclasses.dataclass
class RecomputeConfig:
    enable: bool = False
    # 'full', or a policy name of distributed/recompute.py
    # ('dots_saveable', 'nothing_saveable', ...)
    policy: str = "full"


@dataclasses.dataclass
class ShardingConfig:
    enable: bool = False
    stage: int = 1
    degree: int = -1  # -1: use full dp axis


@dataclasses.dataclass
class GradientMergeConfig:
    enable: bool = False
    k_steps: int = 1
    avg: bool = True


@dataclasses.dataclass
class PipelineConfig:
    enable: bool = False
    schedule_mode: str = "1F1B"
    micro_batch_size: int = 1
    accumulate_steps: int = 1


@dataclasses.dataclass
class Strategy:
    amp: AmpConfig = dataclasses.field(default_factory=AmpConfig)
    recompute: RecomputeConfig = dataclasses.field(default_factory=RecomputeConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    gradient_merge: GradientMergeConfig = dataclasses.field(
        default_factory=GradientMergeConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
