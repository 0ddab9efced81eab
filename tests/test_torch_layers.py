"""The PyTorch port's ring allgathers, its chunked ring reduce-scatter and
its layer tier against the JAX package on the CPU: ``all_gather``
(``ring_1d`` and ``ring_bidir``, one span and spans, a 1-D shard of 512
rows in 3 unequal spans) at world 2 and 4, the method choice,
``reduce_scatter(method="ring")`` with 2 and 3 spans at world 4, and the
layers ``AllGatherLayer``, ``SpGQAFlashDecodeAttention`` (contiguous and
paged, ``ring_bidir``), ``TPMLP`` on a ring and ``TPMoEMLP`` (overlapped
and sequential, and the sequential one's gradients against ``jax.vjp``).

The port's ranks are threads of a CPU ``DistContext`` declared a ring
(``ctx.full_mesh = False``), running the plain versions; the JAX side runs
its ring kernels interpreted under ``shard_map`` on the virtual CPU devices
of ``tests/conftest.py``. Payloads stay at a few KiB. A gather is a copy:
exact. f32 elsewhere, the packages differing in summation order only:
1e-5 (gradients 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.layers import AllGatherLayer as JaxAllGatherLayer
from triton_dist_tpu.layers import SpGQAFlashDecodeAttention as JaxSpLayer
from triton_dist_tpu.layers import TPMLP as JaxTPMLP
from triton_dist_tpu.layers import TPMoEMLP as JaxTPMoEMLP
from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops.allgather import all_gather as jax_all_gather
from triton_dist_tpu.ops.allgather import get_auto_all_gather_method as jax_auto_method
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig as JaxAGConfig
from triton_dist_tpu.ops.flash_decode import FlashDecodeConfig as JaxFDConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig as JaxRSConfig
from triton_dist_tpu.ops.group_gemm import GroupGemmConfig as JaxGGConfig
from triton_dist_tpu.ops.reduce_scatter import ReduceScatterConfig as JaxRSCConfig
from triton_dist_tpu.ops.reduce_scatter import reduce_scatter as jax_reduce_scatter
from triton_dist_tpu.perf_model import direct_vs_ring_crossover_bytes
from triton_dist_tpu_torch import layers as tlayers
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu_torch.ops.flash_decode import FlashDecodeConfig
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

TOL, GRAD_TOL = 1e-5, 1e-4
E, TOPK, BM, HID, FFN = 4, 2, 8, 32, 64
RING_METHODS = ("ring_1d", "ring_bidir")


def _shard(fn, world, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


def _ring(world):
    ctx = initialize_distributed(world, device="cpu")
    ctx.full_mesh = False
    return ctx


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ the rings ----

@pytest.mark.parametrize("world,chunks,shape", [
    (2, 1, (6, 16)), (4, 1, (6, 16)), (4, 2, (6, 16)), (4, 3, (512,))],
    ids=["w2", "w4", "w4-chunks2", "w4-512rows-chunks3"])
def test_ring_all_gather_matches_jax(world, chunks, shape):
    """Both rings, one JAX program: every rank's gather equals JAX's
    exactly. 512 rows in 3 chunks are spans of 171/171/170 (a 1-D shard,
    reshaped to rows and back as ``:472-474`` does)."""
    x = np.random.default_rng(world * 10 + chunks).standard_normal(
        (world, *shape)).astype(np.float32)

    def jprog(xs):
        return tuple(jax_all_gather(xs[0], axis="tp", method=m, chunks_per_shard=chunks)[None]
                     for m in RING_METHODS)

    want = _shard(jprog, world, (P("tp"),), (P("tp"),) * 2)(jnp.asarray(x))
    ctx = _ring(world)
    outs = ctx.run(lambda: [tag.all_gather(_t(x[ctx.rank]), ctx=ctx, method=m,
                                           chunks_per_shard=chunks) for m in RING_METHODS])
    golden = x.reshape(world * shape[0], *shape[1:])
    for r, got in enumerate(outs):
        for g, w in zip(got, want):
            assert g.shape == golden.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[r])
            np.testing.assert_array_equal(g.numpy(), golden)


def test_auto_all_gather_method_follows_jax():
    """On a full mesh every size pushes; off one the JAX package's
    branches without its ICI crossover: ``ring_1d`` at two ranks,
    ``ring_bidir`` beyond (JAX's choice above its crossover)."""
    for n in (2, 4, 8):
        assert tag.get_auto_all_gather_method(64, n) == "full_mesh_push"
        cross = direct_vs_ring_crossover_bytes(n)  # inf at two ranks: ring_1d at any size
        big = 1 << 40 if np.isinf(cross) else int(cross) + 1
        assert tag.get_auto_all_gather_method(big, n, full_mesh=False) == \
            jax_auto_method(big, n)
    assert tag.get_auto_all_gather_method(64, 2, full_mesh=False) == "ring_1d"
    assert tag.get_auto_all_gather_method(64, 4, full_mesh=False) == "ring_bidir"
    ctx = _ring(4)
    x = [torch.full((2, 3), float(r)) for r in range(4)]
    for got in ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx)):
        assert torch.equal(got, torch.cat(x))
    with pytest.raises(ValueError, match="at most 16"):
        ctx.run(lambda: tag.all_gather(torch.zeros(32), ctx=ctx, chunks_per_shard=17))


@pytest.mark.parametrize("chunks", [2, 3])
def test_chunked_ring_reduce_scatter_matches_jax(chunks):
    """``reduce_scatter`` on the ring with 2 and 3 spans a hop at world 4
    (8 rows a rank: spans 4/4 and 4/2/2) against JAX's chunked ring
    kernel, and bit-equal to the port's one-span ring."""
    world, m_loc, n = 4, 8, 16
    x = np.random.default_rng(70 + chunks).standard_normal(
        (world, world * m_loc, n)).astype(np.float32)
    want = _shard(lambda xs: jax_reduce_scatter(
        xs[0], axis="tp", config=JaxRSCConfig(block_m=8, block_n=16, method="ring",
                                              chunks_per_shard=chunks)),
        world, (P("tp"),), P("tp"))(jnp.asarray(x))
    ctx = _ring(world)
    cfg = trs.ReduceScatterConfig(block_m=8, block_n=16, chunks_per_shard=chunks)
    outs = ctx.run(lambda: (trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx, config=cfg),
                            trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx, method="ring")))
    _close(torch.cat([o[0] for o in outs]), want)
    for chunked, one in outs:
        assert torch.equal(chunked, one)


# ----------------------------------------------------------- the layers ----

def test_allgather_layer_matches_jax():
    """Every entry of the layer at world 2 on a ring context (``forward``
    ``auto``: ``ring_1d``) against the JAX layer's, exactly."""
    world = 2
    x = np.random.default_rng(80).standard_normal((world, 5, 8)).astype(np.float32)
    jl = JaxAllGatherLayer(axis="tp")
    want = _shard(lambda xs: tuple(f(xs[0])[None] for f in (
        jl, jl.forward_ring, jl.forward_ring_bidir, jl.forward_push)),
        world, (P("tp"),), (P("tp"),) * 4)(jnp.asarray(x))
    ctx = _ring(world)
    layer = tlayers.AllGatherLayer(ctx)
    calls = tag._all_gather_xla.calls
    outs = ctx.run(lambda: [f(_t(x[ctx.rank])) for f in (
        layer, layer.forward_ring, layer.forward_ring_bidir, layer.forward_push)])
    assert tag._all_gather_xla.calls == calls + 4 * world
    for r, got in enumerate(outs):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[r])


def test_sp_flash_decode_layer_matches_jax():
    """``SpGQAFlashDecodeAttention(ag_method="ring_bidir")`` at world 4 on
    a ring context, contiguous and paged (each rank's page pool behind a
    shuffled block table), against the JAX layer; each rank's local
    lengths from the global ones with ``local_lens_from_global``
    (sequence 1 ends inside rank 1's shard, so ranks 2 and 3 hold none of
    it)."""
    world, b, hq, h_kv, d, s_loc, page = 4, 2, 4, 2, 8, 8, 4
    pps = s_loc // page
    rng = np.random.default_rng(81)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((world, b, h_kv, s_loc, d)).astype(np.float32)
            for _ in range(2))
    total = np.array([world * s_loc, s_loc + 3], np.int32)
    perm = rng.permutation(b * pps)
    table = np.stack([perm.reshape(b, pps)] * world).astype(np.int32)

    def paginate(x):  # [world, b, h_kv, s_loc, d] -> each rank's pool, pages at perm
        pages = x.reshape(world, b, h_kv, pps, page, d).transpose(0, 1, 3, 2, 4, 5)
        pool = np.empty((world, b * pps, h_kv, page, d), np.float32)
        pool[:, perm] = pages.reshape(world, b * pps, h_kv, page, d)
        return pool

    kp, vp = paginate(k), paginate(v)
    jl = JaxSpLayer(axis="tp", config=JaxFDConfig(block_s=s_loc), ag_method="ring_bidir")

    def jprog(q, total, k, v, kp, vp, table):
        lens = jl.local_lens_from_global(total, s_loc)
        return (jl(q, k[0], v[0], lens)[None],
                jl.forward_paged(q, kp[0], vp[0], lens, table[0])[None])

    want_c, want_p = _shard(jprog, world, (P(None), P(None)) + (P("tp"),) * 5,
                            (P("tp"), P("tp")))(
        *(jnp.asarray(a) for a in (q, total, k, v, kp, vp, table)))
    ctx = _ring(world)
    layer = tlayers.SpGQAFlashDecodeAttention(ctx, FlashDecodeConfig(block_s=s_loc),
                                              ag_method="ring_bidir")

    def rank():
        r = ctx.rank
        lens = layer.local_lens_from_global(_t(total), s_loc).to(torch.int32)
        assert lens.tolist() == np.clip(total - r * s_loc, 0, s_loc).tolist()
        return (layer(_t(q), _t(k[r]), _t(v[r]), lens),
                layer.forward_paged(_t(q), _t(kp[r]), _t(vp[r]), lens, _t(table[r])))

    for r, (c, p) in enumerate(ctx.run(rank)):
        _close(c, np.asarray(want_c)[r])
        _close(p, np.asarray(want_p)[r])


def test_tp_mlp_on_a_ring_matches_jax():
    """``TPMLP`` at world 2 on a ring context with two spans a hop (the
    ring AG-GEMM and the chunked ring GEMM-RS) against the JAX layer with
    the same configs."""
    world, m_loc = 2, 8
    rng = np.random.default_rng(82)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((HID, FFN)) / 6).astype(np.float32)
    w_down = (rng.standard_normal((FFN, HID)) / 8).astype(np.float32)
    jl = JaxTPMLP(axis="tp", ag_config=JaxAGConfig(8, 64, 64, chunks_per_shard=2),
                  rs_config=JaxRSConfig(8, 64, 64, chunks_per_shard=2))
    want = _shard(jl, world, (P("tp", None), P(None, "tp"), P("tp", None)),
                  P("tp", None))(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down))
    ctx = _ring(world)
    layer = tlayers.TPMLP(ctx, ag_config=AGGemmConfig(8, 64, 64, chunks_per_shard=2),
                          rs_config=GemmRSConfig(8, 64, 64, chunks_per_shard=2))
    f_loc = FFN // world
    outs = ctx.run(lambda: layer(_t(x[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]),
                                 _t(w_up[:, ctx.rank * f_loc:(ctx.rank + 1) * f_loc]),
                                 _t(w_down[ctx.rank * f_loc:(ctx.rank + 1) * f_loc])))
    _close(torch.cat(outs), want)


def _moe_inputs(seed, world, m_loc=8):
    rng = np.random.default_rng(seed)
    m_tot = world * m_loc
    x = rng.standard_normal((m_tot, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / 4).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / 6).astype(np.float32)
    ids = np.argsort(rng.random((m_tot, E)), axis=1)[:, :TOPK].astype(np.int32)
    tw = rng.random((m_tot, TOPK)).astype(np.float32) + 0.1
    return x, w_up, w_down, ids, (tw / tw.sum(1, keepdims=True)).astype(np.float32)


MOE_SPECS = (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None),
             P("tp", None))


def _moe_rank_args(ctx, inputs, world, m_loc=8):
    x, w_up, w_down, ids, tw = inputs
    r, f_loc = ctx.rank, FFN // world
    rows = slice(r * m_loc, (r + 1) * m_loc)
    return (_t(x[rows]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
            _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(ids[rows]), _t(tw[rows]))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sequential"])
def test_tp_moe_mlp_layer_matches_jax(overlap):
    """``TPMoEMLP`` at world 2 on a ring context (sequential: the ring
    allgather of the tokens and the ring reduce-scatter; overlapped: the
    AG-GroupGEMM and MoE-Reduce-RS pair) against the JAX layer with the
    same ``overlap``."""
    world = 2
    inputs = _moe_inputs(83, world)
    jl = JaxTPMoEMLP(axis="tp", gg_config=JaxGGConfig(BM, FFN, FFN), overlap=overlap)
    want = _shard(jl, world, MOE_SPECS, P("tp", None))(*(jnp.asarray(a) for a in inputs))
    ctx = _ring(world)
    layer = tlayers.TPMoEMLP(ctx, GroupGemmConfig(BM), overlap=overlap)
    calls = tag._all_gather_xla.calls
    outs = ctx.run(lambda: layer(*_moe_rank_args(ctx, inputs, world)))
    # the sequential composition gathers the tokens through all_gather
    assert tag._all_gather_xla.calls - calls == (0 if overlap else world)
    _close(torch.cat(outs), want)


def test_tp_moe_mlp_sequential_grads_match_jax_vjp():
    """The sequential MoE MLP's dx, dw_up, dw_down and d topk_weights at
    world 2 on a ring context, through ``TPMoEMLP(overlap=False)``, against
    ``jax.vjp`` of ``tp_moe_mlp_grad(..., overlap=False)``."""
    world = 2
    inputs = _moe_inputs(84, world)
    dout = np.random.default_rng(85).standard_normal((world * 8, HID)).astype(np.float32)
    cfg = JaxGGConfig(BM, FFN, FFN)

    def jax_side(x, wu, wd, ids, tw, dout):
        out, vjp = jax.vjp(lambda x, wu, wd, tw: jgrads.tp_moe_mlp_grad(
            x, wu, wd, ids, tw, "tp", jax.nn.gelu, cfg, None, False), x, wu, wd, tw)
        return (out, *vjp(dout))

    want = _shard(jax_side, world, (*MOE_SPECS, P("tp", None)),
                  (P("tp", None), *[MOE_SPECS[i] for i in (0, 1, 2, 4)]))(
        *(jnp.asarray(a) for a in (*inputs, dout)))
    ctx = _ring(world)
    layer = tlayers.TPMoEMLP(ctx, GroupGemmConfig(BM), overlap=False)

    def rank():
        x, wu, wd, ids, tw = _moe_rank_args(ctx, inputs, world)
        leaves = [t.requires_grad_() for t in (x, wu, wd, tw)]
        out = layer(leaves[0], leaves[1], leaves[2], ids, leaves[3])
        torch.autograd.backward(out, _t(dout[ctx.rank * 8:(ctx.rank + 1) * 8]))
        return out.detach(), *[t.grad for t in leaves]

    outs = ctx.run(rank, grad=True)
    for i, dim in enumerate((0, 0, 2, 1, 0)):
        _close(torch.cat([o[i] for o in outs], dim), want[i], GRAD_TOL if i else TOL)
