"""The port's single-controller mesh and its collective matmuls
(``distributed/mesh.py``, ``kernels/collective_matmul.py``) against the
JAX package's ``shard_map`` rings on the conftest's virtual CPU devices,
and against the dense ``x @ w``.

Values of the port's mesh are per-shard lists on ``["cpu"] * tp``; the
same numpy inputs go through both packages.  Bars: the ring products
agree with the reference's rings and with the dense product within 1e-5
(f32, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed._jax_compat import shard_map
from paddle_tpu.kernels import collective_matmul as ref_cm
from paddle_tpu_torch.distributed import (Mesh, all_gather, ppermute, psum,
                                          psum_scatter)
from paddle_tpu_torch.kernels.collective_matmul import (
    allgather_matmul, matmul_reduce_scatter, ring_schedule)


def _cpu_mesh(tp):
    return Mesh(["cpu"] * tp)


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_ring_schedule_matches_the_reference(tp):
    """The perm table is the forward ring; the entry sources visit every
    origin once (own shard first) and the exit chunks end on the own
    chunk — entry for entry the reference's schedule."""
    ring, want = ring_schedule(tp), ref_cm.ring_schedule(tp)
    assert ring.perm == want.perm == [(d, (d + 1) % tp) for d in range(tp)]
    for idx in range(tp):
        srcs = [ring.entry_src(idx, h) for h in range(tp)]
        chunks = [ring.exit_chunk(idx, h) for h in range(tp)]
        assert srcs == [want.entry_src(idx, h) for h in range(tp)]
        assert chunks == [want.exit_chunk(idx, h) for h in range(tp)]
        assert sorted(srcs) == list(range(tp)) and srcs[0] == idx
        assert sorted(chunks) == list(range(tp)) and chunks[-1] == idx


def test_ring_schedule_rejects_zero():
    with pytest.raises(ValueError, match="tp >= 1"):
        ring_schedule(0)


def test_mesh_collectives():
    """psum sums in shard order onto every shard; all_gather tiles;
    psum_scatter gives shard d chunk d of the sum; ppermute moves shard
    src to dst and fills a shard nothing is sent to with zeros."""
    mesh = _cpu_mesh(3)
    xs = [torch.full((2, 3), float(d + 1)) for d in range(3)]
    for t in psum(xs, mesh):
        torch.testing.assert_close(t, torch.full((2, 3), 6.0))
    for t in all_gather(xs, mesh, dim=0):
        assert t.shape == (6, 3) and t[4, 0].item() == 3.0
    ys = [torch.arange(6.0).reshape(3, 2) * (d + 1) for d in range(3)]
    sc = psum_scatter(ys, mesh)
    for d in range(3):
        torch.testing.assert_close(sc[d], (torch.arange(6.0).reshape(3, 2)
                                           * 6)[d:d + 1])
    moved = ppermute(xs, mesh, [(0, 1), (1, 2)])
    assert [t[0, 0].item() for t in moved] == [0.0, 1.0, 2.0]
    assert moved[1] is not xs[0]          # a copy, not an alias
    with pytest.raises(ValueError, match="2 shards for a mesh of 3"):
        psum(xs[:2], mesh)
    assert Mesh(["cpu", "cpu"]) == Mesh([torch.device("cpu")] * 2)


def _reference_rings(x, w_in, w_out, tp):
    mesh = JaxMesh(np.array(jax.devices()[:tp]), ("mp",))

    def ag(xs, ws):
        return ref_cm.allgather_matmul(xs, ws, "mp", tp)

    def rs(xs, ws):
        return ref_cm.matmul_reduce_scatter(xs, ws, "mp", tp)
    ya = jax.jit(shard_map(ag, mesh=mesh,
                           in_specs=(P("mp", None), P(None, "mp")),
                           out_specs=P(None, "mp"),
                           check_vma=False))(x, w_in)
    yr = jax.jit(shard_map(rs, mesh=mesh,
                           in_specs=(P(None, "mp"), P("mp", None)),
                           out_specs=P("mp", None),
                           check_vma=False))(x, w_out)
    return np.asarray(ya), np.asarray(yr)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("overlap", [True, False])
def test_ring_matmuls_match_the_reference_and_the_dense_product(tp, overlap):
    rs = np.random.RandomState(3)
    x = rs.randn(8, 16).astype(np.float32)
    w_in = rs.randn(16, 12).astype(np.float32)
    w_out = rs.randn(16, 12).astype(np.float32)
    ref_ag, ref_rs = _reference_rings(jnp.asarray(x), jnp.asarray(w_in),
                                      jnp.asarray(w_out), tp)
    mesh = _cpu_mesh(tp)
    xt = torch.as_tensor(x)
    # entry: slot shards of x against column blocks of w_in
    xs = list(torch.chunk(xt, tp, dim=0))
    ws = list(torch.chunk(torch.as_tensor(w_in), tp, dim=1))
    ya = torch.cat(allgather_matmul(xs, ws, mesh, overlap=overlap), dim=1)
    # exit: contraction shards of x against row blocks of w_out
    xk = [c.contiguous() for c in torch.chunk(xt, tp, dim=1)]
    wk = list(torch.chunk(torch.as_tensor(w_out), tp, dim=0))
    yr = torch.cat(matmul_reduce_scatter(xk, wk, mesh, overlap=overlap),
                   dim=0)
    np.testing.assert_allclose(ya.numpy(), ref_ag, atol=1e-5, rtol=0)
    np.testing.assert_allclose(yr.numpy(), ref_rs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ya.numpy(), x @ w_in, atol=1e-5, rtol=0)
    np.testing.assert_allclose(yr.numpy(), x @ w_out, atol=1e-5, rtol=0)


def test_single_shard_is_the_plain_product():
    mesh = _cpu_mesh(1)
    x, w = torch.randn(4, 8), torch.randn(8, 5)
    torch.testing.assert_close(allgather_matmul([x], [w], mesh)[0], x @ w)
    torch.testing.assert_close(matmul_reduce_scatter([x], [w], mesh)[0],
                               x @ w)
