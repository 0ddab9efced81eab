"""The 2-D rank runtime of the PyTorch port and what rides it on the CPU:
``initialize_distributed(mesh_shape=...)``, its axis queries and groups,
the groups' host collectives, a failing rank, the timeout records' global
rank and group; the collectives over an axis pair or three axes
(``all_gather``, ``ag_gemm``, ``gemm_rs``, ``reduce_scatter``) and the
layers ``TPMLP`` / ``TPMoEMLP`` / ``AllGatherLayer`` over a pair.

The JAX side runs under ``shard_map`` on the virtual CPU devices of
``tests/conftest.py``. Most cells hold the port to the goldens the JAX
package's own tests use (``jax.lax.all_gather(x, axes, tiled=True)``,
``psum_scatter``, the dense MLP), which XLA computes cheaply; three cells
run the interpreted Pallas kernels on a 2 x 2 mesh (``all_gather_2d``,
``ag_gemm`` and ``TPMLP`` over ``("dp", "tp")``). Inputs come from numpy
with a seed.

Tolerances: gathers are copies and must be exact; f32 products and sums of
the same inputs in another order, 1e-4 (the MoE layer 1e-4 against the
dense f32 golden).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import TPMLP as JTPMLP
from triton_dist_tpu.ops.allgather import all_gather as jax_all_gather
from triton_dist_tpu.ops.allgather import all_gather_2d as jax_all_gather_2d
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig as JAGGemmConfig
from triton_dist_tpu.ops.allgather_gemm import ag_gemm as jax_ag_gemm
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig as JGemmRSConfig
from triton_dist_tpu_torch import layers as tlayers
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import allgather_gemm as tagg
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
from triton_dist_tpu_torch.ops.moe_utils import select_experts
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import records, sites, watchdog

TOL = 1e-4
SHAPES = {"2x2": {"dp": 2, "tp": 2}, "2x4": {"dp": 2, "tp": 4},
          "2x2x2": {"pp": 2, "dp": 2, "tp": 2}}


def _jmesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _shard(fn, shape, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_jmesh(shape), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _ctx(shape: dict):
    return initialize_distributed(mesh_shape=shape, device="cpu")


def _rng(salt):
    return np.random.default_rng(1300 + salt)


# ------------------------------------------------------------- runtime ----

@pytest.mark.parametrize("name", sorted(SHAPES))
def test_axis_sizes_and_indices_match_jax_mesh(name):
    shape = SHAPES[name]
    axes = tuple(shape)
    n = int(np.prod(list(shape.values())))
    probes = [(a,) for a in axes] + [axes[-2:], axes[::-1], axes]

    def jfn(x):
        return jnp.stack([jax.lax.axis_index(p) for p in probes]).reshape(1, -1) + 0 * x

    want = np.asarray(_shard(jfn, shape, P(axes), P(axes))(jnp.zeros((n, len(probes)),
                                                                      jnp.int32)))
    ctx = _ctx(shape)
    got = ctx.run(lambda: [ctx.axis_index(p if len(p) > 1 else p[0]) for p in probes])
    np.testing.assert_array_equal(np.asarray(got), want)
    for p in probes:
        assert ctx.axis_size(p) == int(np.prod([shape[a] for a in p]))
    assert ctx.axis_names == axes and ctx.world == n


@pytest.mark.parametrize("axis", ["tp", "dp", ("dp", "tp"), ("tp", "dp")],
                         ids=["tp", "dp", "dp-tp", "tp-dp"])
def test_group_collectives_match_jax(axis):
    """``ctx.group(axis)``'s host ``all_gather`` / ``psum`` /
    ``psum_scatter`` / ``all_to_all`` against ``jax.lax`` over the same axis
    of a 2 x 4 mesh (XLA's collectives)."""
    shape = SHAPES["2x4"]
    n = int(np.prod([shape[a] for a in ((axis,) if isinstance(axis, str) else axis)]))
    x = _rng(1).standard_normal((8, n * 3, 5)).astype(np.float32)

    def jfn(x):
        x = x[0]
        return (jax.lax.all_gather(x, axis, tiled=True)[None],
                jax.lax.psum(x, axis)[None],
                jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)[None],
                jax.lax.all_to_all(x.reshape(n, 3, 5), axis, 0, 0, tiled=True)[None])

    spec = P(("dp", "tp"))
    want = [np.asarray(w) for w in _shard(jfn, shape, spec, (spec,) * 4)(jnp.asarray(x))]
    ctx = _ctx(shape)

    def body():
        g = ctx.group(axis)
        t = torch.from_numpy(x[ctx.rank])
        return (g.all_gather(t, 0), g.psum(t), g.psum_scatter(t, 0),
                g.all_to_all(t.reshape(n, 3, 5)).reshape(n * 3, 5))

    for r, outs in enumerate(ctx.run(body)):
        np.testing.assert_array_equal(outs[0].numpy(), want[0][r])
        np.testing.assert_array_equal(outs[3].numpy(), want[3][r].reshape(n * 3, 5))
        for i in (1, 2):
            np.testing.assert_allclose(outs[i].numpy(), want[i][r], rtol=1e-6, atol=1e-6)


def test_a_failing_rank_breaks_every_group_and_the_runtime_refuses():
    """Rank 1 raises while the others wait at their tp and dp groups'
    rendezvous (one of them at a group made after the failure): every
    wait breaks, the first error is raised and the runtime refuses."""
    ctx = _ctx(SHAPES["2x2"])
    ctx.run(lambda: ctx.group("tp").psum(torch.ones(1)))
    started = threading.Event()

    def body():
        if ctx.rank == 1:
            started.wait(5)
            raise ValueError("rank 1 fails")
        if ctx.rank == 3:
            started.set()
            ctx.group(("tp", "dp")).rendezvous()
        ctx.group("tp" if ctx.rank == 0 else "dp").rendezvous()

    with pytest.raises(ValueError, match="rank 1 fails"):
        ctx.run(body)
    with pytest.raises(RuntimeError, match="failed earlier"):
        ctx.run(lambda: 0)


def test_groups_keep_their_own_epochs_buffers_and_records():
    """Two tp groups run the same family at once: each group's epochs and
    symmetric buffers are its own; a timeout record decodes its sites in
    the group's world and names the global rank and the group."""
    ctx = _ctx(SHAPES["2x2"])

    def body():
        tp, pair = ctx.group("tp"), ctx
        e = [tp.next_epoch("all_gather") for _ in range(2)] + [pair.next_epoch("all_gather")]
        buf = tp.symmetric("t", 64)
        return e, buf, tp.members

    outs = ctx.run(body)
    assert [e for e, _, _ in outs] == [[1, 2, 1]] * 4
    assert outs[0][1] is outs[1][1] and outs[0][1] is not outs[2][1]
    assert [m for _, _, m in outs] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    clean = [0] * records.DIAG_LEN
    row = [records.STATUS_TIMEOUT, sites.FAMILIES["all_gather_2d"], 0, 4 + sites.MAX_SPANS + 1,
           sites.KIND_SIGNAL, 3, 2, 1000]
    groups = [{"all_gather_2d": ("dp,tp", 4)}] * 3 + [{"all_gather_ring_1d": ("tp", 2)}]
    with pytest.raises(records.DistTimeoutError) as err:
        watchdog.check([clean, clean, row, clean], 4, groups=groups)
    (rec,) = err.value.records
    assert (rec["pe"], rec["rank"], rec["group"], rec["waits_for"]) == (
        0, 2, "dp,tp", "inner chunk 1 of the outer neighbour's outer round 0")
    assert "[global rank 2, group dp,tp]" in str(err.value)
    row2 = [records.STATUS_TIMEOUT, sites.FAMILIES["all_gather_ring_1d"], 1, 1,
            sites.KIND_BARRIER, 3, 2, 1000]
    with pytest.raises(records.DistTimeoutError) as err:
        watchdog.check([clean, clean, clean, row2], 4, groups=groups)
    (rec,) = err.value.records
    assert (rec["rank"], rec["group"], rec["waits_for"]) == (
        3, "tp", "entry barrier: arrival of rank 1")


# ---------------------------------------------------- pair collectives ----

@pytest.mark.parametrize("name,axes", [("2x4", ("dp", "tp")), ("2x4", ("tp", "dp")),
                                       ("2x2x2", ("pp", "dp", "tp"))],
                         ids=["dp-tp", "tp-dp", "three-axes"])
def test_all_gather_over_axes_matches_jax_golden(name, axes):
    """``all_gather`` over a pair, the swapped pair and three axes against
    ``jax.lax.all_gather(x, axes, tiled=True)`` (``test_allgather.py:90``);
    ``axis=`` and a group ``ctx`` give the same rows."""
    shape = SHAPES[name]
    n = int(np.prod(list(shape.values())))
    x = _rng(2).standard_normal((n * 4, 16)).astype(np.float32)
    want = np.asarray(_shard(lambda v: jax.lax.all_gather(v, axes, tiled=True), shape,
                             P(axes), P(None))(jnp.asarray(x)))
    ctx = _ctx(shape)

    def body():
        i = ctx.axis_index(axes)
        t = torch.from_numpy(x[i * 4:(i + 1) * 4])
        return tag.all_gather(t, ctx=ctx, axis=axes), tag.all_gather(t, ctx=ctx.group(axes))

    for a, b in ctx.run(body):
        np.testing.assert_array_equal(a.numpy(), want)
        np.testing.assert_array_equal(b.numpy(), want)


def test_all_gather_2d_matches_the_interpreted_kernel():
    """The port's pair gather against JAX's ``all_gather_2d`` with its
    Pallas ring ``_ring_2d_kernel`` interpreted, on a 2 x 2 mesh; a 1-D
    shard too."""
    shape = SHAPES["2x2"]
    axes = ("dp", "tp")
    x = _rng(3).standard_normal((4 * 8, 32)).astype(np.float32)
    want = np.asarray(_shard(lambda v: jax_all_gather_2d(v, axes=axes), shape, P(axes),
                             P(None))(jnp.asarray(x)))
    ctx = _ctx(shape)
    outs = ctx.run(lambda: (
        tag.all_gather_2d(torch.from_numpy(x[ctx.rank * 8:(ctx.rank + 1) * 8]), ctx=ctx),
        tag.all_gather_2d(torch.from_numpy(x[ctx.rank * 8:(ctx.rank + 1) * 8, 0].copy()),
                          ctx=ctx, axes=axes)))
    for got, flat in outs:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(flat.numpy(), want[:, 0])


def test_ag_gemm_over_a_pair_matches_the_interpreted_kernel():
    """``ag_gemm(axis=("dp", "tp"))`` with ``gather_output`` against JAX's
    ``_ag_gemm_2d`` with ``_ag_gemm_2d_kernel`` interpreted, on 2 x 2."""
    shape = SHAPES["2x2"]
    m_loc, k, n_loc = 8, 64, 32
    rng = _rng(4)
    a = rng.standard_normal((4 * m_loc, k)).astype(np.float32)
    b = (rng.standard_normal((k, n_loc)) / 8).astype(np.float32)
    want, want_ag = _shard(
        lambda a, b: jax_ag_gemm(a, b, axis=("dp", "tp"), config=JAGGemmConfig(8, 32, 64),
                                 gather_output=True),
        shape, (P(("dp", "tp"), None), P(None, None)), (P(None, None), P(None, None)),
    )(jnp.asarray(a), jnp.asarray(b))
    ctx = _ctx(shape)
    outs = ctx.run(lambda: tagg.ag_gemm(
        torch.from_numpy(a[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]), torch.from_numpy(b),
        ctx=ctx, axis=("dp", "tp"), gather_output=True))
    for out, ag in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(ag.numpy(), np.asarray(want_ag))


@pytest.mark.parametrize("axes", [("dp", "tp"), ("tp", "dp")], ids=["dp-tp", "tp-dp"])
def test_gemm_rs_and_reduce_scatter_over_a_pair_match_jax_golden(axes):
    """``gemm_rs`` and ``reduce_scatter`` over a pair of a 2 x 4 runtime
    against ``jax.lax.psum_scatter(.., axes, tiled=True)``; the ops'
    permuted inner stage then the outer one, as ``_gemm_rs_2d`` and the
    N-D peel stage them."""
    shape = SHAPES["2x4"]
    n = 8
    m_loc, k_loc, nd = 2, 16, 24
    rng = _rng(5)
    a = rng.standard_normal((n, n * m_loc, k_loc)).astype(np.float32)
    b = rng.standard_normal((n, k_loc, nd)).astype(np.float32)

    def jfn(a, b):
        return (jax.lax.psum_scatter(a[0] @ b[0], axes, tiled=True),
                jax.lax.psum_scatter(a[0], axes, tiled=True))

    want_mm, want_rs = (np.asarray(w) for w in _shard(
        jfn, shape, (P(axes), P(axes)), (P(axes), P(axes)))(jnp.asarray(a), jnp.asarray(b)))
    ctx = _ctx(shape)

    def body():
        i = ctx.axis_index(axes)
        ta, tb = torch.from_numpy(a[i]), torch.from_numpy(b[i])
        return i, (tgrs.gemm_rs(ta, tb, ctx=ctx, axis=axes),
                   trs.reduce_scatter(ta, ctx=ctx, axis=axes),
                   trs.reduce_scatter_2d(ta, ctx=ctx, axes=axes))

    for i, (mm, rs, rs2) in ctx.run(body):
        rows = slice(i * m_loc, (i + 1) * m_loc)
        np.testing.assert_allclose(mm.numpy(), want_mm[rows], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rs.numpy(), want_rs[rows], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(rs.numpy(), rs2.numpy())


def test_pair_errors_match_the_reference():
    """A tuple gather with a pinned method raises the reference's
    ``ValueError`` word for word; three axes to ``ag_gemm`` / ``gemm_rs``
    and an axis the runtime lacks raise too."""
    shape = SHAPES["2x2x2"]
    x = np.zeros((8 * 2, 4), np.float32)
    with pytest.raises(ValueError) as want:
        _shard(lambda v: jax_all_gather(v, axis=("dp", "tp"), method="ring_1d"),
               SHAPES["2x2"], P(("dp", "tp")), P(None))(jnp.asarray(x[:8]))
    ctx = _ctx(shape)
    t = torch.zeros((2, 4))
    for fn in (lambda: tag.all_gather(t, ctx=ctx, axis=("dp", "tp"), method="ring_1d"),
               lambda: tlayers.AllGatherLayer(ctx, axis=("dp", "tp")).forward_ring(t)):
        with pytest.raises(ValueError) as got:
            ctx.run(fn)
        assert str(got.value) == str(want.value)
        ctx = _ctx(shape)
    for fn, words in ((lambda: tagg.ag_gemm(t, torch.zeros((4, 4)), ctx=ctx), "at most 2 axes"),
                      (lambda: tgrs.gemm_rs(torch.zeros((16, 4)), torch.zeros((4, 4)), ctx=ctx),
                       "at most 2 axes"),
                      (lambda: ctx.group("ep"), "axis 'ep' is not an axis")):
        with pytest.raises(ValueError, match=words):
            ctx.run(fn)
        ctx = _ctx(shape)


# ------------------------------------------------------------ layers ----

def test_tp_mlp_over_a_pair_matches_the_interpreted_layer():
    """``TPMLP(axis=("dp", "tp"))`` (K37's plain version, then the 2-D
    GEMM-RS) against the JAX layer with its Pallas kernels interpreted on
    2 x 2, and against the dense golden of ``test_layers.py:27``."""
    shape = SHAPES["2x2"]
    axes = ("dp", "tp")
    m_tot, h, f = 16, 32, 64
    rng = _rng(6)
    x = rng.standard_normal((m_tot, h)).astype(np.float32)
    w_up = (rng.standard_normal((h, f)) / 8).astype(np.float32)
    w_down = (rng.standard_normal((f, h)) / 8).astype(np.float32)
    layer = JTPMLP(axis=axes, ag_config=JAGGemmConfig(4, 16, 32),
                   rs_config=JGemmRSConfig(4, 32, 16))
    want = np.asarray(_shard(layer, shape, (P(axes, None), P(None, axes), P(axes, None)),
                             P(axes, None))(jnp.asarray(x), jnp.asarray(w_up),
                                            jnp.asarray(w_down)))
    golden = np.asarray(jnp.dot(jax.nn.gelu(jnp.dot(x, w_up)), w_down))
    np.testing.assert_allclose(want, golden, rtol=TOL, atol=TOL)
    ctx = _ctx(shape)
    m_loc, f_loc = m_tot // 4, f // 4

    def body():
        r = ctx.axis_index(axes)
        mlp = tlayers.TPMLP(ctx, axis=axes)
        return mlp(torch.from_numpy(x[r * m_loc:(r + 1) * m_loc]),
                   torch.from_numpy(w_up[:, r * f_loc:(r + 1) * f_loc].copy()),
                   torch.from_numpy(w_down[r * f_loc:(r + 1) * f_loc]))

    got = torch.cat(ctx.run(body)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _dense_moe(x, w_up, w_down, ids, tw):
    h_e = np.asarray(jax.nn.gelu(jnp.einsum("th,tkhf->tkf", x, w_up[ids])))
    y = np.einsum("tkf,tkfh->tkh", h_e, w_down[ids])
    return np.einsum("tk,tkh->th", tw, y)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sequential"])
def test_tp_moe_mlp_over_a_pair_matches_the_dense_golden(overlap):
    """``TPMoEMLP(axis=("dp", "tp"))`` on 2 x 2 against the per-token dense
    MoE golden of ``test_layers.py:68-90`` (JAX's own routing): the
    overlapped pair over the flattened group, or the sequential composition
    whose gather and reduce-scatter take the 2-D paths."""
    shape = SHAPES["2x2"]
    axes = ("dp", "tp")
    m_tot, h, f, n_exp, topk = 16, 32, 64, 4, 2
    rng = _rng(7)
    x = rng.standard_normal((m_tot, h)).astype(np.float32)
    w_up = (rng.standard_normal((n_exp, h, f)) / 8).astype(np.float32)
    w_down = (rng.standard_normal((n_exp, f, h)) / 8).astype(np.float32)
    logits = rng.standard_normal((m_tot, n_exp)).astype(np.float32)
    tw, ids = select_experts(torch.from_numpy(logits), topk)
    want = _dense_moe(x, w_up, w_down, ids.numpy(), tw.numpy())
    ctx = _ctx(shape)
    m_loc, f_loc = m_tot // 4, f // 4
    layer = tlayers.TPMoEMLP(ctx, gg_config=GroupGemmConfig(4), overlap=overlap, axis=axes)

    def body():
        r = ctx.axis_index(axes)
        rows, cols = slice(r * m_loc, (r + 1) * m_loc), slice(r * f_loc, (r + 1) * f_loc)
        return layer(torch.from_numpy(x[rows]), torch.from_numpy(w_up[:, :, cols].copy()),
                     torch.from_numpy(w_down[:, cols].copy()), ids[rows], tw[rows])

    got = torch.cat(ctx.run(body)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
