"""``fleet``, the hybrid-parallel front door (counterpart of
paddle_tpu/distributed/fleet.py).

``fleet.init(is_collective=True, strategy=s)`` builds the
:class:`~.topology.HybridCommunicateGroup` of ``s.hybrid_configs`` and
makes it the current group (``get_hybrid_communicate_group()``).  The
port runs collective training from one controller process: the worker
index and count come from the launcher's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` (0 and 1 without a launcher).  Not ported yet
(ROADMAP queue 1): ``distributed_model`` / ``distributed_optimizer`` and
the parameter-server role makers.
"""

from __future__ import annotations

import os
from typing import Optional

from .strategy import DistributedStrategy
from .topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

__all__ = ["init", "get_strategy", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker", "fleet"]

_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         devices=None):
    """Build the rank grid from ``strategy.hybrid_configs`` over
    ``devices`` (default: the first ``world`` CUDA devices; several ranks
    may share one card, ``devices=["cuda:0"] * world``) and make it the
    current hybrid group.  Returns the ``fleet`` object."""
    global _strategy
    if role_maker is not None or not is_collective:
        raise NotImplementedError(
            "fleet.init runs collective training only: the parameter-server "
            "role makers are not ported (ROADMAP queue 1); pass "
            "is_collective=True and no role_maker")
    strategy = strategy or DistributedStrategy()
    h = strategy.hybrid_configs
    hcg = HybridCommunicateGroup(
        dp_degree=h["dp_degree"], mp_degree=h["mp_degree"],
        pp_degree=h["pp_degree"], sharding_degree=h["sharding_degree"],
        sep_degree=h["sep_degree"], ep_degree=h["ep_degree"],
        devices=devices)
    _strategy = strategy
    set_hybrid_communicate_group(hcg)
    return fleet


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy


def worker_index() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def worker_num() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))


def is_first_worker() -> bool:
    return worker_index() == 0


class _FleetModule:
    """The ``fleet`` object: ``fleet.init(...)``, ``fleet.get_hybrid_
    communicate_group()``, ..."""

    init = staticmethod(init)
    get_strategy = staticmethod(get_strategy)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_first_worker = staticmethod(is_first_worker)
    DistributedStrategy = DistributedStrategy


fleet = _FleetModule()
