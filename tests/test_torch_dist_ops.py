"""The PyTorch port's distributed ops at world 2 and 4 against the JAX
package, on the CPU: ``ag_gemm`` (one span and two), ``gemm_rs``
(``scatter`` and ``ring``), ``all_gather`` (``full_mesh_push``) and
``barrier_all_op``. The port's ranks are threads of one ``DistContext`` on
the CPU, running the ops' plain versions; the JAX side runs under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py`` with its
Pallas kernels interpreted. Inputs come from numpy with a seed; payloads
stay at a few KiB, as the interpreter needs.

Tolerances: both sides compute f32 products and sums of the same f32
inputs, differing only in summation order — 1e-4. Gathers are copies and
must be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops.allgather import all_gather as jax_all_gather
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.allgather_gemm import ag_gemm as jax_ag_gemm
from triton_dist_tpu.ops.common import barrier_all_op as jax_barrier
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import gemm_rs as jax_gemm_rs
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import allgather_gemm as tagg
from triton_dist_tpu_torch.ops import common as tcommon
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.shmem.host import create_symmetric_tensor

TOL = 1e-4
WORLDS = [2, 4]


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _rng(world, salt):
    return np.random.default_rng(100 * world + salt)


@pytest.mark.parametrize("world", WORLDS)
def test_ag_gemm_matches_jax(world):
    m_loc, k, n_loc = 8, 64, 32
    rng = _rng(world, 1)
    a = rng.standard_normal((world * m_loc, k)).astype(np.float32)
    b = rng.standard_normal((k, world * n_loc)).astype(np.float32)
    want, want_ag = _shard(
        lambda a, b: jax_ag_gemm(a, b, axis="tp", config=AGGemmConfig(8, 32, 64),
                                 gather_output=True),
        world, (P("tp", None), P(None, "tp")), (P(None, "tp"), P(None, None)),
    )(jnp.asarray(a), jnp.asarray(b))
    ctx = initialize_distributed(world, device="cpu")

    def rank():
        r = ctx.rank
        return tagg.ag_gemm(torch.from_numpy(a[r * m_loc:(r + 1) * m_loc]),
                            torch.from_numpy(b[:, r * n_loc:(r + 1) * n_loc]),
                            ctx=ctx, gather_output=True)

    outs = ctx.run(rank)
    got = torch.cat([out for out, _ in outs], dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    for _, ag in outs:
        np.testing.assert_array_equal(ag.numpy(), np.asarray(want_ag))
    # two spans a shard: the ring AG-GEMM (K15's plain version), same result
    cfg = tagg.AGGemmConfig(8, 32, 64, chunks_per_shard=2)
    outs = ctx.run(lambda: tagg.ag_gemm(
        torch.from_numpy(a[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]),
        torch.from_numpy(b[:, ctx.rank * n_loc:(ctx.rank + 1) * n_loc]),
        ctx=ctx, config=cfg, gather_output=True))
    got = torch.cat([out for out, _ in outs], dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    for _, ag in outs:
        np.testing.assert_array_equal(ag.numpy(), np.asarray(want_ag))


@pytest.mark.parametrize("world", WORLDS)
def test_gemm_rs_matches_jax(world):
    m_loc, k_loc, n = 8, 32, 64
    rng = _rng(world, 2)
    a = rng.standard_normal((world * m_loc, world * k_loc)).astype(np.float32)
    b = rng.standard_normal((world * k_loc, n)).astype(np.float32)
    # method pinned: the interpreter reports a wrap-around ring, so "auto"
    # could pick the ring kernel there
    want = _shard(
        lambda a, b: jax_gemm_rs(a, b, axis="tp", method="scatter",
                                 config=GemmRSConfig(8, 64, 32)),
        world, (P(None, "tp"), P("tp", None)), P("tp", None),
    )(jnp.asarray(a), jnp.asarray(b))
    ctx = initialize_distributed(world, device="cpu")

    def rank():
        r = ctx.rank
        return tgrs.gemm_rs(torch.from_numpy(a[:, r * k_loc:(r + 1) * k_loc].copy()),
                            torch.from_numpy(b[r * k_loc:(r + 1) * k_loc]), ctx=ctx)

    got = torch.cat(ctx.run(rank)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # the plain psum_scatter twin on its own: the ranks' partial products
    parts = [a[:, r * k_loc:(r + 1) * k_loc] @ b[r * k_loc:(r + 1) * k_loc]
             for r in range(world)]
    got = torch.cat(ctx.run(lambda: trs._reduce_scatter_xla(torch.from_numpy(parts[ctx.rank]),
                                                            ctx))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    assert trs.get_auto_reduce_scatter_method(1 << 20, world, True) == "scatter_reduce"
    # the ring method (K16's plain version, a rounding per hop) agrees too
    got = torch.cat(ctx.run(lambda: tgrs.gemm_rs(
        torch.from_numpy(a[:, ctx.rank * k_loc:(ctx.rank + 1) * k_loc].copy()),
        torch.from_numpy(b[ctx.rank * k_loc:(ctx.rank + 1) * k_loc]), ctx=ctx,
        method="ring"))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_matches_jax(world):
    # the SP combine's payload shape: [b*hq + ceil(b*hq/d), d] f32 rows
    rows, d = 5, 64
    x = _rng(world, 3).standard_normal((world * rows, d)).astype(np.float32)
    want = _shard(
        lambda x: jax_all_gather(x, axis="tp", method="full_mesh_push"),
        world, P("tp", None), P(None, None),
    )(jnp.asarray(x))
    ctx = initialize_distributed(world, device="cpu")
    outs = ctx.run(lambda: tag.all_gather(
        torch.from_numpy(x[ctx.rank * rows:(ctx.rank + 1) * rows]), ctx=ctx))
    for got in outs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tag.get_auto_all_gather_method(1 << 30, world, ctx.full_mesh) == "full_mesh_push"
    # the ring methods are ported: on the CPU they gather through the same
    # plain version
    outs = ctx.run(lambda: tag.all_gather(
        torch.from_numpy(x[ctx.rank * rows:(ctx.rank + 1) * rows]), ctx=ctx,
        method="ring_bidir"))
    for got in outs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", WORLDS)
def test_barrier_matches_jax(world):
    """Both return on every rank; the port's plain barrier also orders: a
    value each rank posts before it is seen by every rank after it."""
    want = _shard(lambda: jax_barrier("tp"), world, (), P("tp"))()
    assert np.asarray(want).tolist() == [1] * world
    ctx = initialize_distributed(world, device="cpu")
    posted = [None] * world

    def rank():
        posted[ctx.rank] = ctx.rank
        tcommon.barrier_all_op(ctx)
        return list(posted)

    assert ctx.run(rank) == [list(range(world))] * world
    # the symmetric-memory twin: one same-shape buffer per rank and its
    # peer table, each rank writing only its own
    sym = ctx.run(lambda: create_symmetric_tensor(ctx, (3, 4), torch.float32, name="t"))[0]
    ctx.run(lambda: sym.view(ctx.rank, (3, 4), torch.float32).fill_(ctx.rank))
    for r in range(world):
        assert torch.equal(sym.view(r, (3, 4), torch.float32), torch.full((3, 4), float(r)))
        assert sym.table[r].tolist() == sym.ptrs
