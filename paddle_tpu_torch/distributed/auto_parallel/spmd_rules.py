"""SPMD sharding-propagation rules as pure shape logic (the port's own
copy of paddle_tpu/distributed/auto_parallel/spmd_rules.py).

Reference: paddle/phi/infermeta/spmd_rules/ — matmul.cc (MatmulInferSpmd),
elementwise.cc, reduction.cc, softmax.cc, embedding.cc; unit-tested with
DistTensorSpec in/out and no communication
(test/auto_parallel/spmd_rules/test_matmul_rule.py).

They are a planner, not the execution path: the port's Engine runs each
sharded layer by its own per-rank rule (engine.py), and these rules give
the reference's results for the same input mappings.

Conventions (the reference's): ``dims_mapping[i]`` = mesh dim that shards
tensor dim i, or -1 for replicated.  A result may also carry
``partial_dims`` — mesh dims over which values are partial sums.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

__all__ = ["DistTensorSpec", "SpmdResult", "matmul_spmd", "elementwise_spmd",
           "reduction_spmd", "embedding_spmd", "softmax_spmd",
           "transpose_spmd", "split_spmd"]


@dataclasses.dataclass
class DistTensorSpec:
    """Shape + dims_mapping (reference: DistTensorSpec in rule tests)."""
    shape: List[int]
    dims_mapping: List[int]

    def __post_init__(self):
        if len(self.shape) != len(self.dims_mapping):
            raise ValueError("shape/dims_mapping rank mismatch")

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass
class SpmdResult:
    """Inferred input mappings (after any forced replication) + output
    mappings + mesh dims on which each output is partial."""
    inputs: List[List[int]]
    outputs: List[List[int]]
    partial_dims: List[List[int]] = dataclasses.field(default_factory=list)


def _merge(a: int, b: int) -> int:
    """Merge two dims_mapping entries for dims that must align: equal wins,
    -1 yields to the sharded one, conflict -> -1 (replicate both)."""
    if a == b:
        return a
    if a == -1:
        return b
    if b == -1:
        return a
    return -1


def _dedup(mappings: List[List[int]]) -> None:
    """A mesh dim may shard at most one tensor dim per tensor; later
    duplicates are replicated (reference rule normalisation)."""
    for m in mappings:
        seen = set()
        for i, d in enumerate(m):
            if d == -1:
                continue
            if d in seen:
                m[i] = -1
            else:
                seen.add(d)


def elementwise_spmd(*specs: DistTensorSpec) -> SpmdResult:
    """Broadcast-aligned elementwise (reference: ElementwiseBinaryInferSpmd).
    Align from trailing dims; broadcast (size-1) dims stay replicated."""
    out_ndim = max(s.ndim for s in specs)
    out = [-1] * out_ndim
    for s in specs:
        off = out_ndim - s.ndim
        for i, d in enumerate(s.dims_mapping):
            if s.shape[i] == 1:
                continue
            out[off + i] = _merge(out[off + i], d)
    _dedup([out])
    ins = []
    for s in specs:
        off = out_ndim - s.ndim
        m = [out[off + i] if s.shape[i] != 1 else -1 for i in range(s.ndim)]
        ins.append(m)
    return SpmdResult(inputs=ins, outputs=[out], partial_dims=[[]])


def matmul_spmd(x: DistTensorSpec, y: DistTensorSpec,
                trans_x: bool = False, trans_y: bool = False) -> SpmdResult:
    """Reference: MatmulInferSpmd (spmd_rules/matmul.cc).

    Output of [..., M, K] @ [..., K, N] is sharded by x's M-dim mesh axis
    and y's N-dim mesh axis; a sharded K produces a partial output over
    that mesh dim (the allreduce GSPMD would insert).
    """
    xm = list(x.dims_mapping)
    ym = list(y.dims_mapping)
    if trans_x:
        xm[-1], xm[-2] = xm[-2], xm[-1]
    if trans_y:
        ym[-1], ym[-2] = ym[-2], ym[-1]
    # after normalisation x: [..., M, K], y: [..., K, N]
    k = _merge(xm[-1], ym[-2])
    xm[-1] = ym[-2] = k
    # batch dims broadcast-align
    xb, yb = xm[:-2], ym[:-2]
    nb = max(len(xb), len(yb))
    batch = [-1] * nb
    for b, nd in ((xb, x.ndim), (yb, y.ndim)):
        off = nb - len(b)
        for i, d in enumerate(b):
            batch[off + i] = _merge(batch[off + i], d)
    m_dim, n_dim = xm[-2], ym[-1]
    out = batch + [m_dim, n_dim]
    _dedup([out])
    batch, (m_dim, n_dim) = out[:-2], out[-2:]
    # the contracted mesh dim must not also shard a batch/M/N dim — that
    # would put one mesh dim on two tensor dims of the same input; force
    # the contraction replicated on conflict
    if k != -1 and k in out:
        k = -1
    partial = [k] if k != -1 else []
    # write aligned (deduped) mappings back through any transposes
    nxm = batch[nb - len(xb):] + [m_dim, k]
    nym = batch[nb - len(yb):] + [k, n_dim]
    if trans_x:
        nxm[-1], nxm[-2] = nxm[-2], nxm[-1]
    if trans_y:
        nym[-1], nym[-2] = nym[-2], nym[-1]
    return SpmdResult(inputs=[nxm, nym], outputs=[out], partial_dims=[partial])


def reduction_spmd(x: DistTensorSpec, axis: Sequence[int],
                   keepdim: bool = False) -> SpmdResult:
    """Reference: ReductionInferSpmd (spmd_rules/reduction.cc).  Reducing a
    sharded dim yields a partial output over its mesh dim."""
    axes = {a % x.ndim for a in axis} if axis else set(range(x.ndim))
    partial = sorted({x.dims_mapping[a] for a in axes
                      if x.dims_mapping[a] != -1})
    out = []
    for i, d in enumerate(x.dims_mapping):
        if i in axes:
            if keepdim:
                out.append(-1)
        else:
            out.append(d)
    return SpmdResult(inputs=[list(x.dims_mapping)], outputs=[out],
                      partial_dims=[partial])


def embedding_spmd(x: DistTensorSpec, w: DistTensorSpec) -> SpmdResult:
    """Reference: EmbeddingInferSpmd (spmd_rules/embedding.cc).  Row
    (vocab)-sharded weight -> partial output (each shard contributes only
    its vocab range; c_embedding masks + allreduces)."""
    row, col = w.dims_mapping
    out = list(x.dims_mapping) + [col]
    _dedup([out])
    partial = [row] if row != -1 else []
    return SpmdResult(inputs=[list(x.dims_mapping), [row, col]],
                      outputs=[out], partial_dims=[partial])


def softmax_spmd(x: DistTensorSpec, axis: int = -1) -> SpmdResult:
    """Reference: SoftmaxInferSpmd (spmd_rules/softmax.cc) — the softmax
    axis must be replicated (forced -1); other dims propagate."""
    a = axis % x.ndim
    ins = list(x.dims_mapping)
    ins[a] = -1
    return SpmdResult(inputs=[ins], outputs=[list(ins)], partial_dims=[[]])


def transpose_spmd(x: DistTensorSpec, perm: Sequence[int]) -> SpmdResult:
    out = [x.dims_mapping[p] for p in perm]
    return SpmdResult(inputs=[list(x.dims_mapping)], outputs=[out],
                      partial_dims=[[]])


def split_spmd(x: DistTensorSpec, num: int, axis: int) -> SpmdResult:
    """Split axis must be replicated; each output inherits the rest."""
    a = axis % x.ndim
    ins = list(x.dims_mapping)
    ins[a] = -1
    return SpmdResult(inputs=[ins], outputs=[list(ins) for _ in range(num)],
                      partial_dims=[[] for _ in range(num)])
