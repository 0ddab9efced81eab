"""The PyTorch port's int8 and fp8 expert banks against the JAX package on
the CPU: the quantizers (int8 pools and f32 scales equal, fp8 pools equal
byte for byte), ``quantize_moe_serving_params`` with its shardings, the
plain twins of the scaled kernels K24 (grouped GEMM), K25 (AG-GroupGEMM)
and K26 (MoE-Reduce-RS) against ``_group_gemm_xla``, ``_ag_overlap_xla``
and ``_moe_rs_overlap_xla`` with their scale, the MoE MLP forward against
``_tp_moe_forward_impl`` (pre-quantized scales at world 1 and 2, on-the-fly
``w8``/``fp8`` at world 2), its straight-through backward against
``jax.vjp`` of ``tp_moe_mlp_grad``, a decode step over quantized banks, and
``ServingEngine`` greedy tokens at world 1 and 2 (from float banks with
``gg_config.w8``/``.fp8``, and from pre-quantized banks). JAX runs under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py`` with its
Pallas kernels interpreted; the port's ranks are threads of a CPU
``DistContext`` running the plain versions. Inputs come from numpy with a
seed; hidden 32, ffn 64, 4 experts, top-2, 8-row blocks, one layer.

Tolerances (f32 throughout; the weights are upcast exactly, so both sides
compute the same products and sums in another order): the ops 1e-5, the
MLP, its gradients and the model 1e-4; tokens must be identical.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops import moe_utils as jmu
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.allgather_group_gemm import _ag_overlap_xla as jax_ag_overlap
from triton_dist_tpu.ops.allgather_group_gemm import presort_local_rows as jax_presort
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.moe_reduce_rs import _moe_rs_overlap_xla as jax_moe_rs_overlap
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import allgather_group_gemm as tagg
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import moe_mlp as tmlp
from triton_dist_tpu_torch.ops import moe_reduce_rs as trs
from triton_dist_tpu_torch.ops import moe_utils as tmu
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.serving import engine as teng

# the JAX package's ops/__init__ re-exports a function under this module's name
jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")

TOL = 1e-5
MLP_TOL = 1e-4
E, TOPK, BM, HID, FFN = 4, 2, 8, 32, 64
DIMS = dict(vocab=32, hidden=HID, ffn=FFN, n_layers=1, n_q_heads=4, n_kv_heads=2,
            head_dim=8, batch=2, seq=8, n_experts=E, topk=TOPK)
S_MAX = 16
FMTS = ("int8", "fp8")
JAX_QUANT = {"int8": jgg.quantize_expert_weights, "fp8": jgg.quantize_expert_weights_fp8}
TORCH_QUANT = {"int8": tgg.quantize_expert_weights, "fp8": tgg.quantize_expert_weights_fp8}


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _t(x):
    """A numpy (or JAX) array as a torch tensor, fp8 through its bytes."""
    a = np.asarray(x)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(tgg.FP8_DTYPE)
    return torch.from_numpy(np.array(a))  # a writable copy (JAX's arrays are read-only)


def _np(t):
    """A torch tensor as numpy, fp8 as its bytes."""
    t = t.detach()
    return t.view(torch.uint8).numpy() if t.dtype == tgg.FP8_DTYPE else t.numpy()


def _bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _routing(rng, tokens):
    ids = np.argsort(rng.random((tokens, E)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


def _banks(rng, f=FFN):
    """Float banks whose columns span two decades of scale."""
    spread = np.logspace(-1, 1, f).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, f)) / np.sqrt(HID) * spread).astype(np.float32)
    w_down = (rng.standard_normal((E, f, HID)) / np.sqrt(f)).astype(np.float32)
    return w_up, w_down


@pytest.mark.parametrize("fmt", FMTS)
def test_quantizers_match_jax(fmt):
    """Pools equal (int8 values, fp8 bytes), scales bit-equal, and
    ``resolve_w8``'s on-the-fly branch equal to the explicit quantizer."""
    rng = np.random.default_rng(1)
    b = (rng.standard_normal((E, HID, 48)) * np.logspace(-3, 2, 48)).astype(np.float32)
    b[1, :, 5] = 0.0  # an all-zero column: the 1e-8 scale floor
    jq, js = JAX_QUANT[fmt](jnp.asarray(b))
    tq, ts = TORCH_QUANT[fmt](_t(b))
    assert tq.dtype == (torch.int8 if fmt == "int8" else tgg.FP8_DTYPE)
    np.testing.assert_array_equal(_np(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    cfg = tgg.GroupGemmConfig(BM, w8=fmt == "int8", fp8=fmt == "fp8")
    rq, rs = tgg.resolve_w8(_t(b), None, cfg)
    assert torch.equal(rq.view(torch.uint8) if fmt == "fp8" else rq,
                       tq.view(torch.uint8) if fmt == "fp8" else tq)
    assert torch.equal(rs, ts)
    # an explicit scale wins; a float config passes the bank through
    assert tgg.resolve_w8(tq, ts, cfg)[0] is tq
    assert tgg.resolve_w8(_t(b), None, tgg.GroupGemmConfig(BM))[1] is None


def test_serving_params_and_shardings_match_jax(moe):
    """``quantize_moe_serving_params`` (both formats): the tree, the pools
    and scales of every layer, carried over with ``params_from_numpy``; and
    each rank's shard at world 2 against JAX's ``moe_quantized_param_specs``
    placement (``w_up_scale`` split with F, ``w_down_scale`` replicated)."""
    jcfg, jparams, _, tparams = moe
    mesh = _mesh(2)
    for fmt in FMTS:
        jq = jtm.quantize_moe_serving_params(jparams, fmt=fmt)
        tq = ttm.quantize_moe_serving_params(tparams, fmt=fmt)
        carried = ttm.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)
        assert sorted(tq["layers"][0]) == sorted(jq["layers"][0])
        for name in ("w_up", "w_down", "w_up_scale", "w_down_scale"):
            want = _bytes(jq["layers"][0][name])
            np.testing.assert_array_equal(_np(tq["layers"][0][name]), want, err_msg=name)
            np.testing.assert_array_equal(_np(carried["layers"][0][name]), want, err_msg=name)
            assert carried["layers"][0][name].dtype == tq["layers"][0][name].dtype
        assert tq["embed"] is tparams["embed"]
        specs = jtm.specs_for(jcfg, jq)
        assert ttm.specs_for(ttm.MoETransformerConfig(**DIMS), tq)["layers"][0] == dict(
            attn_norm=None, wqkv=1, wo=0, mlp_norm=None, router=None, w_up=2, w_down=1,
            w_up_scale=2, w_down_scale=None)
        placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jq, specs)
        shards = ttm.shard_params(tq, 2)
        for r in range(2):
            dev = mesh.devices.flat[r].id
            want = jax.tree.map(lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                                               if s.device.id == dev), placed)
            for name in ("w_up", "w_down", "w_up_scale", "w_down_scale"):
                np.testing.assert_array_equal(_np(shards[r]["layers"][0][name]),
                                              _bytes(want["layers"][0][name]), err_msg=name)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("act", [False, True], ids=["plain", "gelu"])
def test_scaled_group_gemm_plain_matches_xla(fmt, act):
    """K24's plain twin against ``_group_gemm_xla(scale=)``, f32 and bf16
    activations and outputs; a sentinel block reads the clamped expert's
    bank and scale."""
    rng = np.random.default_rng(2)
    ids, _ = _routing(rng, 20)
    al = tmu.moe_align_block_size(_t(ids.reshape(-1)), E, BM)
    eids = al.expert_ids.clone()
    eids[-1] = E + 2
    t_pad = al.sorted_token_ids.shape[0]
    a = rng.standard_normal((t_pad, HID)).astype(np.float32)
    jq, js = JAX_QUANT[fmt](jnp.asarray(_banks(rng)[0]))
    for a_dt, out_dt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
        j_a = jnp.asarray(a).astype(jnp.float32 if a_dt == torch.float32 else jnp.bfloat16)
        want = _group_gemm_xla_f32(j_a, jq, js, eids, act, out_dt)
        got = tgg.group_gemm(_t(a).to(a_dt), _t(jq), eids, scale=_t(js),
                             config=tgg.GroupGemmConfig(BM, 16, 16), out_dtype=out_dt,
                             act_fn=tgg.gelu if act else None)
        assert got.dtype == out_dt
        if out_dt == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        else:
            # both round an f32 sum to bf16: at most one ulp apart
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)
    # the aliases are the same op
    got = tgg.group_gemm_w8 if fmt == "int8" else tgg.group_gemm_fp8
    np.testing.assert_array_equal(
        got(_t(a), _t(jq), _t(js), eids, config=tgg.GroupGemmConfig(BM)).numpy(),
        tgg.group_gemm(_t(a), _t(jq), eids, scale=_t(js), config=tgg.GroupGemmConfig(BM)).numpy())


def _group_gemm_xla_f32(a, b, scale, eids, act, out_dt):
    jdt = jnp.float32 if out_dt == torch.float32 else jnp.bfloat16
    out = jgg._group_gemm_xla(a, b, jnp.asarray(eids.numpy()), valid_rows=None, scale=scale,
                              ragged=False, bm=BM, out_dtype=jdt,
                              act_fn=jax.nn.gelu if act else None)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("fmt", FMTS)
def test_scaled_overlap_ops_match_jax(fmt):
    """K25's and K26's plain twins at world 2: the up-projection over the
    exchanged sorted slabs with the w_up scale, then the down-projection,
    combine and reduce-scatter with the w_down scale."""
    world, m_loc, f_loc = 2, 6, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up, w_down = _banks(rng, world * f_loc)
    ids, tw = _routing(rng, world * m_loc)
    # per-rank banks quantized on their own shards, as each rank holds them
    uq = [JAX_QUANT[fmt](jnp.asarray(w_up[:, :, r * f_loc:(r + 1) * f_loc])) for r in range(2)]
    dq = [JAX_QUANT[fmt](jnp.asarray(w_down[:, r * f_loc:(r + 1) * f_loc])) for r in range(2)]
    stack = lambda qs, i, ax: jnp.concatenate([q[i] for q in qs], ax)  # noqa: E731

    def jprog(x, wu, su, wd, sd, ids_full, tw_full):
        ral = jmu.moe_align_ranked(ids_full.reshape(world, -1), E, BM, m_loc)
        a_srt = jax_presort(x, ral, "tp")
        h = jax_ag_overlap(a_srt, wu, su, ral, axis="tp", ragged=False, gather_output=False,
                           out_dtype=jnp.float32)
        dst, wr = jmu.ranked_scatter_meta(ral, tw_full)
        sd_me = sd.reshape(world, E, 1, HID)[jax.lax.axis_index("tp")]
        y = jax_moe_rs_overlap(h, wd, sd_me, ral.expert_ids, dst, wr, axis="tp", ragged=False,
                               valid_rows=None, m_out=m_loc, out_dtype=jnp.float32)
        return h, y

    jh, jy = _shard(
        jprog, world,
        (P("tp", None), P(None, None, "tp"), P(None, None, "tp"), P(None, "tp", None),
         P(None, None, None), P(None, None), P(None, None)),
        (P(None, "tp"), P("tp", None)),
    )(jnp.asarray(x), stack(uq, 0, 2), stack(uq, 1, 2), stack(dq, 0, 1),
      jnp.stack([q[1] for q in dq]).reshape(world * E, 1, HID), jnp.asarray(ids),
      jnp.asarray(tw))

    ctx = initialize_distributed(world, device="cpu")
    ral = tmu.moe_align_ranked(_t(ids).reshape(world, -1), E, BM, m_loc)
    dst, wr = tmu.ranked_scatter_meta(ral, _t(tw))
    cfg = tgg.GroupGemmConfig(BM, 16, 16)

    def rank():
        r = ctx.rank
        h = tagg.ag_group_gemm_overlap(_t(x[r * m_loc:(r + 1) * m_loc]), _t(uq[r][0]), ral,
                                       ctx=ctx, config=cfg, scale=_t(uq[r][1]))
        y = trs.moe_reduce_rs_overlap(_t(np.asarray(jh)[:, r * f_loc:(r + 1) * f_loc]),
                                      _t(dq[r][0]), ral.expert_ids, dst, wr, ctx=ctx,
                                      m_out=m_loc, config=cfg, scale=_t(dq[r][1]))
        return h, y

    outs = ctx.run(rank)
    np.testing.assert_allclose(torch.cat([h for h, _ in outs], 1).numpy(), np.asarray(jh),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.cat([y for _, y in outs]).numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)


MLP_CASES = {  # name: (world, format, pre-quantized)
    "world1-int8-prequantized": (1, "int8", True),
    "world2-fp8-prequantized": (2, "fp8", True),
    "world2-w8-on-the-fly": (2, "int8", False),
    "world1-fp8-on-the-fly": (1, "fp8", False),
}


def _mlp_inputs(world, seed):
    m_loc = 8
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up, w_down = _banks(rng)
    ids, tw = _routing(rng, world * m_loc)
    return m_loc, x, w_up, w_down, ids, tw


def _per_rank(world, body, grad=False):
    if world == 1:
        return [body(None, 0)]
    ctx = initialize_distributed(world, device="cpu")
    return ctx.run(lambda: body(ctx, ctx.rank), grad=grad)


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_scaled_moe_mlp_forward_matches_jax(case):
    """Pre-quantized banks pass their whole-bank scales through every
    grouped GEMM; ``w8``/``fp8`` on float banks quantizes each rank's own
    shard at each op boundary (w_down's shard is split on its contracted
    dim, so its scales differ from the whole bank's)."""
    world, fmt, pre = MLP_CASES[case]
    m_loc, x, w_up, w_down, ids, tw = _mlp_inputs(world, 20 + world)
    f_loc = FFN // world
    fmt_kw = dict(w8=fmt == "int8", fp8=fmt == "fp8")
    jcfg = jgg.GroupGemmConfig(BM, 64, 64, **fmt_kw)
    specs = (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None),
             P("tp", None))
    if pre:
        (uq, us), (dq, ds) = JAX_QUANT[fmt](jnp.asarray(w_up)), JAX_QUANT[fmt](jnp.asarray(w_down))
        want = _shard(lambda *a: jgrads._tp_moe_forward_impl(
            *a[:5], "tp", jax.nn.gelu, jcfg, None, True, a[5], a[6])[0], world,
            (*specs, P(None, None, "tp"), P(None, None, None)), P("tp", None))(
            jnp.asarray(x), uq, dq, jnp.asarray(ids), jnp.asarray(tw), us, ds)
        w_up_t, w_down_t, us_t, ds_t = _t(uq), _t(dq), _t(us), _t(ds)
    else:
        want = _shard(lambda *a: jgrads._tp_moe_forward_impl(
            *a, "tp", jax.nn.gelu, jcfg, None, True)[0], world, specs, P("tp", None))(
            jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
            jnp.asarray(tw))
        w_up_t, w_down_t, us_t, ds_t = _t(w_up), _t(w_down), None, None
    cfg = tgg.GroupGemmConfig(BM, 16, 16, **fmt_kw)

    def body(ctx, r):
        rows, cols = slice(r * m_loc, (r + 1) * m_loc), slice(r * f_loc, (r + 1) * f_loc)
        return tmlp.tp_moe_mlp(
            _t(x[rows]), w_up_t[:, :, cols].contiguous(), w_down_t[:, cols].contiguous(),
            _t(ids[rows]), _t(tw[rows]), ctx=ctx, gg_config=cfg,
            w_up_scale=None if us_t is None else us_t[:, :, cols].contiguous(),
            w_down_scale=ds_t)

    got = torch.cat(_per_rank(world, body))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)


@pytest.mark.parametrize("world", [1, 2])
def test_scaled_moe_mlp_backward_is_straight_through(world):
    """``tp_moe_mlp_grad`` with pre-quantized int8 banks: the forward, dx
    and d topk_weights against ``jax.vjp`` (the backward differentiates the
    dequantized banks), zero scale cotangents, no bank gradient; and with
    ``w8`` on float banks (world 2) the banks' gradients of the
    straight-through backward too."""
    m_loc, x, w_up, w_down, ids, tw = _mlp_inputs(world, 40 + world)
    dout = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    f_loc = FFN // world
    (uq, us), (dq, ds) = jgg.quantize_expert_weights(jnp.asarray(w_up)), \
        jgg.quantize_expert_weights(jnp.asarray(w_down))
    jcfg = jgg.GroupGemmConfig(BM, 64, 64, w8=True)
    specs = (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None),
             P("tp", None), P(None, None, "tp"), P(None, None, None))

    def jax_side(x, wu, wd, ids, tw, su, sd, dout):
        out, vjp = jax.vjp(lambda x, tw, su, sd: jgrads.tp_moe_mlp_grad(
            x, wu, wd, ids, tw, "tp", jax.nn.gelu, jcfg, None, True, su, sd), x, tw, su, sd)
        return (out, *vjp(dout))

    want = _shard(jax_side, world, (*specs, P("tp", None)),
                  (P("tp", None), P("tp", None), P("tp", None), P(None, None, "tp"),
                   P(None, None, None)))(
        jnp.asarray(x), uq, dq, jnp.asarray(ids), jnp.asarray(tw), us, ds, dout)
    cfg = tgg.GroupGemmConfig(BM, 16, 16, w8=True)

    def body(ctx, r):
        rows, cols = slice(r * m_loc, (r + 1) * m_loc), slice(r * f_loc, (r + 1) * f_loc)
        leaves = [_t(x[rows]), _t(tw[rows]), _t(us)[:, :, cols].contiguous(), _t(ds)]
        for leaf in leaves:
            leaf.requires_grad_()
        out = tgrads.tp_moe_mlp_grad(leaves[0], _t(uq)[:, :, cols].contiguous(),
                                     _t(dq)[:, cols].contiguous(), _t(ids[rows]), leaves[1],
                                     ctx=ctx, gg_config=cfg, w_up_scale=leaves[2],
                                     w_down_scale=leaves[3])
        torch.autograd.backward(out, _t(dout[rows]))
        return out.detach(), *[leaf.grad for leaf in leaves]

    outs = _per_rank(world, body, grad=True)
    for i in (0, 1, 2):
        np.testing.assert_allclose(torch.cat([o[i] for o in outs]).numpy(),
                                   np.asarray(want[i]), rtol=MLP_TOL, atol=MLP_TOL)
    for o in outs:
        assert not o[3].any() and not o[4].any()
    np.testing.assert_array_equal(np.asarray(want[3]), 0.0)
    np.testing.assert_array_equal(np.asarray(want[4]), 0.0)
    if world == 2:
        # w8 on float banks: the banks get the straight-through gradients
        def jax_float(x, wu, wd, ids, tw, dout):
            out, vjp = jax.vjp(lambda x, wu, wd, tw: jgrads.tp_moe_mlp_grad(
                x, wu, wd, ids, tw, "tp", jax.nn.gelu, jcfg, None, True), x, wu, wd, tw)
            return (out, *vjp(dout))

        want = _shard(jax_float, world, (*specs[:5], P("tp", None)),
                      (P("tp", None), *[specs[i] for i in (0, 1, 2, 4)]))(
            jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
            jnp.asarray(tw), dout)

        def body_float(ctx, r):
            rows, cols = slice(r * m_loc, (r + 1) * m_loc), slice(r * f_loc, (r + 1) * f_loc)
            leaves = [_t(x[rows]), _t(w_up[:, :, cols]).contiguous(),
                      _t(w_down[:, cols]).contiguous(), _t(tw[rows])]
            for leaf in leaves:
                leaf.requires_grad_()
            out = tgrads.tp_moe_mlp_grad(leaves[0], leaves[1], leaves[2], _t(ids[rows]),
                                         leaves[3], ctx=ctx, gg_config=cfg)
            torch.autograd.backward(out, _t(dout[rows]))
            return out.detach(), *[leaf.grad for leaf in leaves]

        outs = _per_rank(world, body_float, grad=True)
        for i, dim in enumerate((0, 0, 2, 1, 0)):
            np.testing.assert_allclose(torch.cat([o[i] for o in outs], dim).numpy(),
                                       np.asarray(want[i]), rtol=MLP_TOL, atol=MLP_TOL)


@pytest.fixture(scope="module")
def moe():
    # whole-operand tiles: the fewest interpreted grid steps; 8-row blocks
    jcfg = jtm.MoETransformerConfig(**DIMS, ag_config=AGGemmConfig(16, 128, 128),
                                    rs_config=GemmRSConfig(16, 128, 128),
                                    gg_config=jgg.GroupGemmConfig(BM, 64, 64))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jtm.init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            FFN if "w_down" in str(path[-1]) else HID) ** -0.5), x.dtype),
        shapes)
    tcfg = ttm.MoETransformerConfig(**DIMS, gg_config=tgg.GroupGemmConfig(BM, 16, 16))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tcfg, tparams


def _with_format(jcfg, tcfg, fmt):
    kw = dict(w8=fmt == "int8", fp8=fmt == "fp8")
    return (dataclasses.replace(jcfg, gg_config=dataclasses.replace(jcfg.gg_config, **kw)),
            dataclasses.replace(tcfg, gg_config=dataclasses.replace(tcfg.gg_config, **kw)))


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_decode_step_matches_jax(moe, fmt):
    """One decode step of two sequences at positions 5 and 0 over a zeroed
    contiguous cache, the banks pre-quantized: the upcast einsums with the
    scales folded after the contraction."""
    jcfg, jparams, tcfg, tparams = moe
    jq = jtm.quantize_moe_serving_params(jparams, fmt=fmt)
    tq = ttm.quantize_moe_serving_params(tparams, fmt=fmt)
    tokens = np.array([3, 17], np.int32)
    pos = np.array([5, 0], np.int32)
    jspec = jdec.KVCacheSpec(S_MAX)
    cspecs = jspec.specs(jcfg)
    step = _shard(lambda p, c, t, q: jdec.decode_step(jcfg, p, c, t, q, spec=jspec), 1,
                  (jtm.specs_for(jcfg, jq), cspecs, P(None), P(None)),
                  (P(None, None), cspecs))
    jlogits, _ = step(jq, jspec.init(jcfg, 1), jnp.asarray(tokens), jnp.asarray(pos))
    tspec = tdec.KVCacheSpec(S_MAX)
    tlogits, _ = tdec.decode_step(tcfg, tq, tspec.init(tcfg, "cpu"), torch.from_numpy(tokens),
                                  torch.from_numpy(pos), spec=tspec)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)


ENGINE_CASES = {  # name: (world, format, pre-quantized)
    "world1-int8-float-banks": (1, "int8", False),
    "world1-fp8-prequantized": (1, "fp8", True),
    "world2-int8-prequantized": (2, "int8", True),
    "world2-fp8-float-banks": (2, "fp8", False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_quantized_engine_tokens_match_jax(moe, case):
    """``ServingEngine`` greedy tokens with int8/fp8 banks, paged bulk
    prefill (the scaled grouped GEMMs) and decode (the upcast einsums),
    equal to the JAX engine's; from float banks the engine quantizes once
    (``_serving_params``, cached), pre-quantized banks pass through."""
    world, fmt, pre = ENGINE_CASES[case]
    jcfg, jparams, tcfg, tparams = moe
    jcfg, tcfg = _with_format(jcfg, tcfg, fmt)
    if pre:
        jparams = jtm.quantize_moe_serving_params(jparams, fmt=fmt)
        tparams = ttm.quantize_moe_serving_params(tparams, fmt=fmt)
    kw = dict(page_size=4, prefill=True)
    jeng_ = jeng.ServingEngine(jcfg, jparams, _mesh(world), s_max=S_MAX, **kw)
    ctx = None if world == 1 else initialize_distributed(world, device="cpu")
    teng_ = teng.ServingEngine(tcfg, tparams, s_max=S_MAX, device="cpu", ctx=ctx, **kw)
    served = teng_._serving_params()
    assert served is teng_._serving_params()  # quantized once, cached
    assert (served is tparams) == pre
    assert served["layers"][0]["w_up"].dtype == (torch.int8 if fmt == "int8"
                                                 else tgg.FP8_DTYPE)
    prompts = ([1, 2, 3], [7, 1, 2, 9], [5, 4, 3])
    for eng, mod in ((jeng_, jdec), (teng_, tdec)):
        for i, p in enumerate(prompts):
            eng.submit(mod.Request(list(p), max_new_tokens=3, uid=f"r{i}"))
    jdone, tdone = jeng_.run_until_idle(), teng_.run_until_idle()
    assert {u: r.tokens for u, r in tdone.items()} == {u: r.tokens for u, r in jdone.items()}


def test_train_step_keeps_quantized_pools(moe):
    """``train_step`` over pre-quantized banks under a ``w8`` config: the
    pools take zero cotangents, as in the JAX package, and come back
    unchanged in their own dtype; the scales (zero gradients) too; the
    other parameters take their step."""
    _, _, tcfg, tparams = moe
    cfg = _with_format(moe[0], tcfg, "int8")[1]
    quant = ttm.quantize_moe_serving_params(tparams)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 32, 16))
    new, loss = ttm.train_step(ttm.TPMoETransformer(cfg), quant, tokens,
                               torch.roll(tokens, -1), lr=0.3)
    assert torch.isfinite(loss)
    for name in ("w_up", "w_down", "w_up_scale", "w_down_scale"):
        got, want = new["layers"][0][name], quant["layers"][0][name]
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert not torch.equal(new["layers"][0]["router"], quant["layers"][0]["router"])


def test_scaled_contracts_are_loud(moe):
    _, _, tcfg, tparams = moe
    b = torch.randn(E, HID, 16)
    q, s = tgg.quantize_expert_weights(b)
    a, e = torch.zeros(8, HID), torch.zeros(1, dtype=torch.int32)
    # a quantized bank under w8 without its scale: resolve_w8's error
    with pytest.raises(ValueError, match="needs the matching"):
        tgg.group_gemm(a, q, e, config=tgg.GroupGemmConfig(BM, w8=True))
    with pytest.raises(ValueError, match="needs its scale"):
        tgg.group_gemm(a, q, e, config=tgg.GroupGemmConfig(BM))
    with pytest.raises(ValueError, match="scale"):
        tgg.group_gemm(a, q, e, scale=s[:, :, :8], config=tgg.GroupGemmConfig(BM))
    # one scale without the other, and scales with float banks
    x, ids, tw = torch.zeros(4, HID), torch.zeros(4, TOPK, dtype=torch.int32), torch.ones(4, TOPK)
    qd, sd = tgg.quantize_expert_weights(torch.randn(E, 16, HID))
    with pytest.raises(ValueError, match="both w_up_scale and w_down_scale"):
        tmlp.tp_moe_mlp(x, q, qd, ids, tw, gg_config=tgg.GroupGemmConfig(BM), w_up_scale=s)
    with pytest.raises(ValueError, match="int8/fp8 pools"):
        tmlp.tp_moe_mlp(x, b, torch.randn(E, 16, HID), ids, tw,
                        gg_config=tgg.GroupGemmConfig(BM), w_up_scale=s, w_down_scale=sd)
    # ragged rows serve the scaled formats; their backward keeps its queue id
    with pytest.raises(NotImplementedError, match="B16, ragged dW"):
        tgg.group_gemm_dw(a, a, e, E, config=tgg.GroupGemmConfig(BM, ragged=True, w8=True))
    with pytest.raises(ValueError, match="valid_rows"):
        tgg.group_gemm(a, q, e, scale=s, config=tgg.GroupGemmConfig(BM, ragged=True))
    with pytest.raises(ValueError, match="fmt"):
        ttm.quantize_moe_serving_params(tparams, fmt="int4")
    with pytest.raises(ValueError, match="exclusive"):
        tgg.GroupGemmConfig(BM, w8=True, fp8=True)
