"""The PyTorch port's differentiable ops against the JAX package on the CPU:
``ag_gemm_grad`` and ``gemm_rs_grad`` at world 1 and 2, ``group_gemm_dw``
(sorted and unsorted ids, an empty expert) and ``group_gemm_grad``,
``reduce_scatter`` at world 2 and 4, ``tp_moe_mlp_grad`` at world 1 and 2,
and the differentiable host collectives — each against ``jax.vjp`` of its
JAX twin (or the JAX op itself) on the same numpy inputs. JAX runs under
``shard_map`` (``check_vma=False``) with its Pallas kernels interpreted and
whole-operand tiles; the port's ranks are threads of a CPU
``DistContext`` running the plain versions inside ``ctx.run(...,
grad=True)``.

f32 throughout; both sides compute the same products and sums in another
order: 1e-5. Integer metadata and the zero rows of an empty expert must be
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.group_gemm import GroupGemmConfig as JaxGGConfig
from triton_dist_tpu.ops.group_gemm import group_gemm_dw as jax_group_gemm_dw
from triton_dist_tpu.ops.reduce_scatter import ReduceScatterConfig
from triton_dist_tpu.ops.reduce_scatter import reduce_scatter as jax_reduce_scatter
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

TOL = 1e-5
E, TOPK, BM, HID, FFN = 4, 2, 8, 32, 64
AG_CFG, RS_CFG = AGGemmConfig(16, 64, 64), GemmRSConfig(16, 64, 64)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _per_rank(world, body):
    """`body()` once per rank of a CPU world (``ctx`` None at world 1),
    with gradients on; returns the ranks' results and the context."""
    if world == 1:
        return [body(None, 0)], None
    ctx = initialize_distributed(world, device="cpu")
    return ctx.run(lambda: body(ctx, ctx.rank), grad=True), ctx


def _backward(out, cot, *leaves):
    torch.autograd.backward(out, cot)
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("op", ["ag_gemm_grad", "gemm_rs_grad"])
def test_projection_grads_match_jax(op, world):
    """Forward, dA and dB of the column (AG-GEMM) and row (GEMM-RS)
    projections; the backward of one is the other's fused kernel."""
    rng = np.random.default_rng(10 * world + len(op))
    m_loc, k_loc, n_loc = 8, 16, 16
    if op == "ag_gemm_grad":
        a = rng.standard_normal((world * m_loc, 32)).astype(np.float32)
        b = rng.standard_normal((32, world * n_loc)).astype(np.float32)
        dc = rng.standard_normal((world, world * m_loc, n_loc)).astype(np.float32)
        specs = (P("tp", None), P(None, "tp"))
        out_spec, dc_spec = P(None, "tp"), P("tp", None, None)

        def jfn(a, b):
            return jgrads.ag_gemm_grad(a, b, "tp", AG_CFG, RS_CFG)
    else:
        a = rng.standard_normal((world * m_loc, world * k_loc)).astype(np.float32)
        b = rng.standard_normal((world * k_loc, 32)).astype(np.float32)
        dc = rng.standard_normal((world, m_loc, 32)).astype(np.float32)
        specs = (P(None, "tp"), P("tp", None))
        out_spec, dc_spec = P("tp", None), P("tp", None, None)

        def jfn(a, b):
            return jgrads.gemm_rs_grad(a, b, "tp", RS_CFG, AG_CFG)

    def jax_side(a, b, dc):
        out, vjp = jax.vjp(jfn, a, b)
        return (out, *vjp(dc[0]))

    want_out, want_da, want_db = _shard(jax_side, world, (*specs, dc_spec),
                                        (out_spec, *specs))(a, b, dc)
    a_parts = np.split(a, world, axis=0 if op == "ag_gemm_grad" else 1)
    b_parts = np.split(b, world, axis=1 if op == "ag_gemm_grad" else 0)

    def body(ctx, r):
        ta = _t(a_parts[r]).requires_grad_()
        tb = _t(b_parts[r]).requires_grad_()
        out = getattr(tgrads, op)(ta, tb, ctx=ctx)
        return out, *_backward(out, _t(dc[r]), ta, tb)

    outs, _ = _per_rank(world, body)
    cat = 1 if op == "ag_gemm_grad" else 0
    _close(torch.cat([o[0] for o in outs], cat), want_out)
    _close(torch.cat([o[1] for o in outs], 0 if op == "ag_gemm_grad" else 1), want_da)
    _close(torch.cat([o[2] for o in outs], 1 if op == "ag_gemm_grad" else 0), want_db)


@pytest.mark.parametrize("ids", [[0, 3, 1, 0, 3, 3], [0, 0, 1, 3, 3, 3]],
                         ids=["unsorted", "sorted"])
def test_group_gemm_dw_matches_jax(ids):
    """dW[e] = Σ A_iᵀ G_i over expert e's row blocks; expert 2 has no rows
    and comes back exactly zero; ids beyond the bank are clamped."""
    rng = np.random.default_rng(len(ids) + ids[1])
    n_blocks, k, n = len(ids), 32, 64
    a = rng.standard_normal((BM * n_blocks, k)).astype(np.float32)
    g = rng.standard_normal((BM * n_blocks, n)).astype(np.float32)
    e = np.asarray(ids, np.int32)
    sorted_ = bool(np.all(np.diff(e) >= 0))
    want = jax_group_gemm_dw(jnp.asarray(a), jnp.asarray(g), jnp.asarray(e), E,
                             config=JaxGGConfig(BM, n, k), assume_sorted=sorted_)
    cfg = tgg.GroupGemmConfig(BM)
    got = tgg.group_gemm_dw(_t(a), _t(g), _t(e), E, config=cfg)
    _close(got, want)
    assert torch.all(got[2] == 0)
    clamped = tgg.group_gemm_dw(_t(a), _t(g), _t(np.where(e == 3, 7, e)), E, config=cfg)
    assert torch.equal(clamped, got)


def test_group_gemm_grad_matches_jax():
    """``group_gemm_grad``: forward K8's twin, dA through the transposed
    bank, dB through the dW op; ids get no gradient."""
    rng = np.random.default_rng(5)
    ids = np.asarray([1, 0, 3, 1], np.int32)
    a = rng.standard_normal((BM * ids.size, HID)).astype(np.float32)
    b = (rng.standard_normal((E, HID, FFN)) / 4).astype(np.float32)
    dout = rng.standard_normal((BM * ids.size, FFN)).astype(np.float32)
    cfg = JaxGGConfig(BM, FFN, HID)
    out, vjp = jax.vjp(lambda a, b: jgrads.group_gemm_grad(a, b, jnp.asarray(ids), None, cfg),
                       jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dout))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = tgrads.group_gemm_grad(ta, tb, _t(ids), config=tgg.GroupGemmConfig(BM))
    got_da, got_db = _backward(got, _t(dout), ta, tb)
    _close(got, out)
    _close(got_da, want_da)
    _close(got_db, want_db)


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_matches_jax(world):
    """``reduce_scatter`` (scatter_reduce; the plain ``psum_scatter`` on
    the CPU) against the JAX op; world 1 is the identity and the ring
    methods are refused."""
    m_tot, n = 8 * world, 16
    x = np.random.default_rng(world).standard_normal((world, m_tot, n)).astype(np.float32)
    want = _shard(lambda xs: jax_reduce_scatter(xs[0], axis="tp", method="scatter_reduce",
                                                config=ReduceScatterConfig(8, 16)),
                  world, (P("tp", None, None),), P("tp", None))(x)
    ctx = initialize_distributed(world, device="cpu")
    got = torch.cat(ctx.run(lambda: trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx)))
    _close(got, want)
    one = _t(x[0])
    assert trs.reduce_scatter(one) is one
    with pytest.raises(NotImplementedError, match="B12"):
        ctx.run(lambda: trs.reduce_scatter(_t(x[ctx.rank]), ctx=ctx, method="ring"))


def _routing(rng, tokens):
    """Distinct top-k experts per token, and f32 weights summing to 1."""
    ids = np.argsort(rng.random((tokens, E)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("world", [1, 2])
def test_tp_moe_mlp_grad_matches_jax(world):
    """dx, dw_up, dw_down and d topk_weights of the MoE MLP (world 1: the
    sequential composition; world 2: the overlapped pair) against
    ``jax.vjp`` of ``tp_moe_mlp_grad``; the ids get no gradient."""
    rng = np.random.default_rng(40 + world)
    m_loc = 8
    m_tot = world * m_loc
    x = rng.standard_normal((m_tot, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / 4).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / 6).astype(np.float32)
    ids, tw = _routing(rng, m_tot)
    dout = rng.standard_normal((m_tot, HID)).astype(np.float32)
    cfg = JaxGGConfig(BM, FFN, FFN)
    specs = (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None),
             P("tp", None))

    def jax_side(x, wu, wd, ids, tw, dout):
        out, vjp = jax.vjp(lambda x, wu, wd, tw: jgrads.tp_moe_mlp_grad(
            x, wu, wd, ids, tw, "tp", jax.nn.gelu, cfg, None, True), x, wu, wd, tw)
        return (out, *vjp(dout))

    want = _shard(jax_side, world, (*specs, P("tp", None)),
                  (P("tp", None), *[specs[i] for i in (0, 1, 2, 4)]))(
        x, w_up, w_down, ids, tw, dout)
    f_loc = FFN // world

    def body(ctx, r):
        rows = slice(r * m_loc, (r + 1) * m_loc)
        leaves = [_t(x[rows]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
                  _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(tw[rows])]
        for leaf in leaves:
            leaf.requires_grad_()
        out = tgrads.tp_moe_mlp_grad(leaves[0], leaves[1], leaves[2], _t(ids[rows]),
                                     leaves[3], ctx=ctx, gg_config=tgg.GroupGemmConfig(BM))
        return out, *_backward(out, _t(dout[rows]), *leaves)

    outs, _ = _per_rank(world, body)
    for i, dim in enumerate((0, 0, 2, 1, 0)):
        _close(torch.cat([o[i] for o in outs], dim), want[i])


@pytest.mark.parametrize("world", [2, 4])
def test_host_collective_grads_match_jax(world):
    """The transposes of ``psum`` (a psum) and ``all_gather`` (a
    psum_scatter) under ``shard_map`` with ``check_vma=False``, and
    ``grads_all_finite`` over the ranks."""
    rng = np.random.default_rng(60 + world)
    x = rng.standard_normal((world, 4, 3)).astype(np.float32)
    wp = rng.standard_normal((4, 3)).astype(np.float32)
    wg = rng.standard_normal((world * 4, 3)).astype(np.float32)

    def jax_side(xs):
        def f(x):
            return (jnp.sum(jax.lax.psum(x, "tp") * wp)
                    + jnp.sum(jax.lax.all_gather(x, "tp", tiled=True) * wg))
        return jax.grad(f)(xs[0])[None]

    want = _shard(jax_side, world, (P("tp", None, None),), P("tp", None, None))(x)
    ctx = initialize_distributed(world, device="cpu")

    def body():
        tx = _t(x[ctx.rank]).requires_grad_()
        y = ((tgrads.psum(tx, ctx) * _t(wp)).sum()
             + (tgrads.all_gather(tx, ctx) * _t(wg)).sum())
        (g,) = torch.autograd.grad(y, tx)
        bad = torch.full((2,), float("nan")) if ctx.rank == world - 1 else torch.ones(2)
        return g, bool(tgrads.grads_all_finite({"a": [tx], "b": (torch.ones(1),)}, ctx)), \
            bool(tgrads.grads_all_finite([tx, bad], ctx))

    outs = ctx.run(body, grad=True)
    _close(torch.stack([o[0] for o in outs]), want)
    assert [o[1:] for o in outs] == [(True, False)] * world
