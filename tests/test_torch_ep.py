"""The PyTorch port's expert-parallel MoE against the JAX package on the CPU,
at world 4 (and 2, 1 where stated): the padded-slab all-to-all
``fast_all_to_all`` (with and without metadata, whole-slab and chunked)
and its differentiable form against ``jax.vjp``, ``EPAll2AllLayer``'s
dispatch and combine on the bf16-free and the one-byte wires (the wire
quantizer bit-equal), slab overflow (equal counts, the NaN poison),
``EPMoEMLP``, the EP model forward with its expert-dim ``shard_params``,
greedy ``generate`` tokens equal to the JAX package's and to the port's
tensor-parallel decoder, ``ServingEngine`` at world 4 (bulk, chunked with
the prefix cache, the quantize-once int8 banks with the int8 wire), and
the refusals (hierarchical EP's missing axis) and a world-1 EP training
step (padded and ragged). JAX runs under ``shard_map``
on the virtual CPU devices of ``tests/conftest.py`` with its Pallas
kernels interpreted; the port's ranks are threads of a CPU
``DistContext`` running the plain versions. Inputs come from numpy with a
seed: hidden 32, ffn 64, 8 experts, top-2, one layer (the dims of
``tests/test_decode.py::test_generate_flat_ep_moe_matches_tp_moe``).

Tolerances: the all-to-all is a copy, so its outputs are bit-equal; the
dispatch's received rows, counts and expert ids are equal too, and the
combine (two non-zero terms a token, added in either order) within 1e-6;
the MLP and the model forward in f32 within 1e-5 (the packages' grouped
GEMMs sum in another order); tokens must be identical.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.layers import ep_a2a_layer as jlayer
from triton_dist_tpu.layers.ep_moe_mlp import EPMoEMLP as JaxEPMoEMLP
from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops import grads as jgrads
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.flash_decode import FlashDecodeConfig as JaxFDConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch import config as tconfig
from triton_dist_tpu_torch.layers import ep_a2a_layer as tlayer
from triton_dist_tpu_torch.layers import ep_moe_mlp as tmlp
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import presets as tpresets
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig
from triton_dist_tpu_torch.ops import all_to_all as ta2a
from triton_dist_tpu_torch.ops import grads as tgrads
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.serving import engine as teng

# the JAX package's ops/__init__ re-exports functions under these modules' names
ja2a = importlib.import_module("triton_dist_tpu.ops.all_to_all")
jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")

TOL = 1e-5
WORLD, E, TOPK, BM, HID, FFN = 4, 8, 2, 4, 32, 64
DIMS = dict(vocab=32, hidden=HID, ffn=FFN, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=4, seq=8, n_experts=E, topk=TOPK)
PROMPT_LEN, N_STEPS, S_MAX = 3, 3, 16


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _t(x):
    """A numpy (or JAX) array as a torch tensor: bf16 through f32, fp8
    through its bytes."""
    a = np.asarray(x)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(tgg.FP8_DTYPE)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    """A torch tensor as numpy: bf16 as f32, fp8 as its bytes."""
    t = t.detach()
    if t.dtype == tgg.FP8_DTYPE:
        return t.view(torch.uint8).numpy()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bytes(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _ranks(world, body, grad=False):
    if world == 1:
        return [body(None, 0)]
    ctx = initialize_distributed(world, device="cpu")
    return ctx.run(lambda: body(ctx, ctx.rank), grad=grad)


def _routing(rng, tokens, n_exp=E):
    ids = np.argsort(rng.random((tokens, n_exp)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ the a2a ----

A2A_CASES = {  # name: (dtype, with meta, A2AConfig fields)
    "f32": (np.float32, False, {}),
    "bf16-meta": (jnp.bfloat16, True, {}),
    "chunks2-meta": (np.float32, True, dict(chunks_per_shard=2)),
    "chunks3-puts2": (np.float32, False, dict(puts_per_slab=2, chunks_per_shard=3)),
}


@pytest.mark.parametrize("case", list(A2A_CASES))
def test_fast_all_to_all_matches_jax(case):
    """Every rank's recv, counts and metadata bit-equal to the JAX kernel's
    (whole-slab ``_a2a_kernel``, or ``_a2a_chunked_kernel`` with spans);
    the f32 case also holds ``all_to_all_post_process``, the op entry and
    the world-1 identity."""
    dtype, with_meta, fields = A2A_CASES[case]
    rng = np.random.default_rng(len(case))
    n, max_m, hidden = WORLD, 6, 8
    tokens = jnp.asarray(rng.standard_normal((n, n, max_m, hidden)), dtype)
    splits = rng.integers(0, max_m + 1, (n, n)).astype(np.int32)
    meta = rng.integers(-50, 50, (n, n, 7)).astype(np.int32)
    jcfg, tcfg = ja2a.A2AConfig(**fields), ta2a.A2AConfig(**fields)
    spec = (P("tp", None, None, None), P("tp", None), P("tp", None, None))

    def jfn(t, s, m):
        out = ja2a.fast_all_to_all(t[0], s[0], meta=m[0] if with_meta else None, axis="tp",
                                   config=jcfg)
        return tuple(o[None] for o in out)

    want = _shard(jfn, n, spec, (spec[0], spec[1], spec[2])[:3 if with_meta else 2])(
        tokens, jnp.asarray(splits), jnp.asarray(meta))

    def body(ctx, r):
        return ta2a.fast_all_to_all(_t(tokens[r]), torch.from_numpy(splits[r]),
                                    meta=torch.from_numpy(meta[r]) if with_meta else None,
                                    ctx=ctx, config=tcfg)

    got = _ranks(n, body)
    for i, w in enumerate(want):
        for r in range(n):
            np.testing.assert_array_equal(_np(got[r][i]), _bytes(w[r]), err_msg=f"{i} {r}")
    if case != "f32":
        return
    for r in range(n):
        jp, jt = ja2a.all_to_all_post_process(want[0][r], want[1][r])
        tp_, tt = ta2a.all_to_all_post_process(got[r][0], got[r][1])
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
        assert int(tt) == int(jt)
    jrecv, jsplits = ja2a.fast_all_to_all_op(tokens, jnp.asarray(splits), _mesh(n))
    op = _ranks(n, lambda ctx, r: ta2a.fast_all_to_all_op(_t(tokens[r]),
                                                          torch.from_numpy(splits[r]), ctx=ctx))
    np.testing.assert_array_equal(torch.stack([o[0] for o in op]).numpy(), np.asarray(jrecv))
    np.testing.assert_array_equal(torch.stack([o[1] for o in op]).numpy(), np.asarray(jsplits))
    one = ta2a.fast_all_to_all(_t(tokens[0, :1]), torch.from_numpy(splits[0, :1]))
    assert torch.equal(one[0], _t(tokens[0, :1])) and one[1].tolist() == [splits[0, 0]]


def test_fast_all_to_all_grad_matches_vjp():
    """The differentiable exchange: forward and the tokens' gradient (the
    same exchange of the cotangent with the received counts) bit-equal to
    ``jax.grad`` through ``fast_all_to_all_grad``; the metadata rides
    along and takes no gradient."""
    rng = np.random.default_rng(7)
    n, max_m, hidden = WORLD, 5, 8
    tokens = rng.standard_normal((n, n, max_m, hidden)).astype(np.float32)
    splits = rng.integers(0, max_m + 1, (n, n)).astype(np.int32)
    meta = rng.integers(0, 9, (n, n, max_m)).astype(np.int32)
    cot = rng.standard_normal((n, n, max_m, hidden)).astype(np.float32)
    spec4, spec2, spec3 = P("tp", None, None, None), P("tp", None), P("tp", None, None)

    def jfn(t, s, m, c):
        def loss(tt):
            recv, _, _ = jgrads.fast_all_to_all_grad(tt[0], s[0], m[0], "tp", None, None)
            return jnp.sum(recv * c[0]), recv

        (_, recv), dt = jax.value_and_grad(loss, has_aux=True)(t)
        return recv[None], dt

    jrecv, jdt = _shard(jfn, n, (spec4, spec2, spec3, spec4), (spec4, spec4))(
        tokens, splits, meta, cot)

    def body(ctx, r):
        x = torch.from_numpy(tokens[r]).requires_grad_(True)
        recv, rs, rm = tgrads.fast_all_to_all_grad(x, torch.from_numpy(splits[r]),
                                                   torch.from_numpy(meta[r]), ctx=ctx)
        assert not rs.requires_grad and not rm.requires_grad
        (recv * torch.from_numpy(cot[r])).sum().backward()
        return recv.detach(), x.grad

    got = _ranks(n, body, grad=True)
    np.testing.assert_array_equal(torch.stack([g[0] for g in got]).numpy(), np.asarray(jrecv))
    np.testing.assert_array_equal(torch.stack([g[1] for g in got]).numpy(),
                                  np.asarray(jdt).reshape(tokens.shape))


# ------------------------------------------------------ the EP layers ----

def _layer_fn(layer, m_loc):
    def fn(x, ids, tw):
        recv, info = layer.dispatch(x, ids)
        out = layer.combine(recv * 2.0, info, tw, m_loc)  # doubling "experts"
        return (recv[None], info.recv_splits[None], info.recv_expert[None],
                info.send_splits[None], info.overflow[None], out)

    return fn


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_dispatch_and_combine_match_jax(quant):
    """``EPAll2AllLayer`` at world 4: the wire quantizer's bytes and row
    scales bit-equal to JAX's (jitted, as its dispatch runs it) on a slab
    with padding rows, the received
    rows (dequantized on the one-byte wires), counts and local expert ids
    equal, and the combine of doubled rows within 1e-6."""
    rng = np.random.default_rng(11 if quant is None else len(quant))
    m_loc, hidden = 6, 16
    m_tot = WORLD * m_loc
    x = rng.standard_normal((m_tot, hidden)).astype(np.float32) * np.logspace(
        -2, 1, hidden).astype(np.float32)
    ids, tw = _routing(rng, m_tot)
    if quant is not None:
        slab = rng.standard_normal((WORLD, 5, hidden)).astype(np.float32) * 3
        slab[1, 2:] = 0.0  # padding rows: scale 1e-8, exact zeros
        # as the dispatch runs it: under jit, where XLA multiplies by 1 / qmax
        jq, js = jax.jit(jlayer._quantize_rows, static_argnums=1)(jnp.asarray(slab), quant)
        tq, ts = tlayer._quantize_rows(torch.from_numpy(slab), quant)
        np.testing.assert_array_equal(_np(tq), _bytes(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jl = jlayer.EPAll2AllLayer(E, TOPK, m_loc * TOPK, axis="tp", quant=quant)
    want = _shard(_layer_fn(jl, m_loc), WORLD, (P("tp", None),) * 3,
                  (P("tp", None, None, None), P("tp", None), P("tp", None, None),
                   P("tp", None), P("tp"), P("tp", None)))(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(tw))

    def body(ctx, r):
        rows = slice(r * m_loc, (r + 1) * m_loc)
        tl = tlayer.EPAll2AllLayer(E, TOPK, m_loc * TOPK, ctx, quant=quant)
        recv, info = tl.dispatch(torch.from_numpy(x[rows]), torch.from_numpy(ids[rows]))
        out = tl.combine(recv * 2.0, info, torch.from_numpy(tw[rows]), m_loc)
        return recv, info, out

    got = _ranks(WORLD, body)
    for r, (recv, info, _) in enumerate(got):
        np.testing.assert_array_equal(recv.numpy(), np.asarray(want[0][r]))
        np.testing.assert_array_equal(info.recv_splits.numpy(), np.asarray(want[1][r]))
        np.testing.assert_array_equal(info.recv_expert.numpy(), np.asarray(want[2][r]))
        np.testing.assert_array_equal(info.send_splits.numpy(), np.asarray(want[3][r]))
        assert int(info.overflow) == int(np.asarray(want[4])[r]) == 0
    np.testing.assert_allclose(torch.cat([g[2] for g in got]).numpy(), np.asarray(want[5]),
                               rtol=1e-6, atol=1e-6)


def _mlp_inputs(rng, m_loc, world):
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / np.sqrt(FFN)).astype(np.float32)
    return x, w_up, w_down


def _jax_mlp(world, layer, args, scales=None, with_overflow=False):
    specs = (P("tp", None), P("tp", None, None), P("tp", None, None), P("tp", None),
             P("tp", None))

    if scales is None:
        def fn(*a):
            out = layer(*a, with_overflow=with_overflow)
            return (out[0], out[1][None]) if with_overflow else out
        outs = (P("tp", None), P("tp")) if with_overflow else P("tp", None)
        return _shard(fn, world, specs, outs)(*args)
    return _shard(lambda *a: layer(*a[:5], w_up_scale=a[5], w_down_scale=a[6]), world,
                  (*specs, P("tp", None, None), P("tp", None, None)), P("tp", None))(
        *args, *scales)


def test_slab_overflow_counts_and_poison(capsys):
    """An undersized ``max_m`` (every assignment routed to expert 0, slab
    2): each rank's dropped count equals JAX's and the surviving
    contributions agree; under ``config.ep_overflow_check`` the output is
    all NaN with the diagnostic on stderr, and ``assert_no_overflow``
    stops."""
    rng = np.random.default_rng(13)
    m_loc, max_m = 4, 2
    x, w_up, w_down = _mlp_inputs(rng, m_loc, WORLD)
    ids = np.zeros((WORLD * m_loc, TOPK), np.int32)
    tw = np.full((WORLD * m_loc, TOPK), 0.5, np.float32)
    jl = JaxEPMoEMLP(n_experts=E, topk=TOPK, max_m=max_m, axis="tp",
                     gg_config=jgg.GroupGemmConfig(BM, 64, 64))
    jout, jov = _jax_mlp(WORLD, jl, tuple(map(jnp.asarray, (x, w_up, w_down, ids, tw))),
                         with_overflow=True)
    epr = E // WORLD
    cfg = tgg.GroupGemmConfig(BM)

    def body(ctx, r):
        rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
        layer = tmlp.EPMoEMLP(E, TOPK, max_m, ctx, gg_config=cfg)
        return layer(torch.from_numpy(x[rows]), torch.from_numpy(w_up[ex]),
                     torch.from_numpy(w_down[ex]), torch.from_numpy(ids[rows]),
                     torch.from_numpy(tw[rows]), with_overflow=True)

    got = _ranks(WORLD, body)
    assert [int(g[1]) for g in got] == np.asarray(jov).tolist()
    assert all(int(g[1]) == m_loc * TOPK - max_m for g in got)
    np.testing.assert_allclose(torch.cat([g[0] for g in got]).numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    with tconfig.ep_overflow_check():  # module state: set for every rank at once
        poisoned = _ranks(WORLD, body)
    assert all(torch.isnan(g[0]).all() for g in poisoned)
    assert "slab overflow" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="slab overflow"):
        tmlp.assert_no_overflow(got[0][1])
    tmlp.assert_no_overflow(torch.tensor(0))


MLP_CASES = {  # name: (world, wire, one-byte banks)
    "world4": (4, None, None),
    "world2-int8-wire": (2, "int8", None),
    "world4-fp8-wire-int8-banks": (4, "fp8", "int8"),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_ep_moe_mlp_matches_jax(case):
    """``EPMoEMLP`` (dispatch, the grouped GEMMs' plain twins, combine)
    against JAX's, f32 within 1e-5: float banks, the int8 wire, and
    pre-quantized int8 banks (their scales through K24's twin) on the fp8
    wire."""
    world, wire, banks = MLP_CASES[case]
    rng = np.random.default_rng(world + len(case))
    m_loc = 6
    x, w_up, w_down = _mlp_inputs(rng, m_loc, world)
    ids, tw = _routing(rng, world * m_loc)
    args = tuple(map(jnp.asarray, (x, w_up, w_down, ids, tw)))
    scales = None
    if banks is not None:
        (uq, us), (dq, ds) = jgg.quantize_expert_weights(args[1]), jgg.quantize_expert_weights(
            args[2])
        args, scales = (args[0], uq, dq, *args[3:]), (us, ds)
    jl = JaxEPMoEMLP(n_experts=E, topk=TOPK, max_m=m_loc * TOPK, axis="tp", quant=wire,
                     gg_config=jgg.GroupGemmConfig(BM, 64, 64))
    want = _jax_mlp(world, jl, args, scales)
    epr = E // world

    def body(ctx, r):
        rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
        kw = {} if scales is None else dict(w_up_scale=_t(scales[0])[ex],
                                            w_down_scale=_t(scales[1])[ex])
        layer = tmlp.EPMoEMLP(E, TOPK, m_loc * TOPK, ctx, gg_config=tgg.GroupGemmConfig(BM),
                              quant=wire)
        return layer(_t(args[0])[rows], _t(args[1])[ex], _t(args[2])[ex], _t(args[3])[rows],
                     _t(args[4])[rows], **kw)

    got = torch.cat(_ranks(world, body))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ------------------------------------------------------ the EP model ----

@pytest.fixture(scope="module")
def ep():
    """The JAX and port EP configs and weights (``init_moe_params``' tree
    filled from numpy at its scales), and the TP twins of the configs."""
    jcfg = jtm.EPMoETransformerConfig(**DIMS, ag_config=AGGemmConfig(8, 128, 128),
                                      rs_config=GemmRSConfig(8, 128, 128),
                                      gg_config=jgg.GroupGemmConfig(BM, 64, 64))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jtm.init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            FFN if "w_down" in str(path[-1]) else HID) ** -0.5), x.dtype),
        shapes)
    tcfg = ttm.EPMoETransformerConfig(**DIMS, gg_config=tgg.GroupGemmConfig(BM))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tcfg, tparams


def test_ep_model_forward_and_shard_params(ep):
    """``shard_params(..., cfg=ep_cfg)`` equals JAX's ``ep_moe_param_specs``
    shards (whole experts a rank, the quantized scales with them); the EP
    forward at world 4 equals JAX's ``EPMoETransformer`` to 1e-5; banks
    split the tensor-parallel way (no config) are refused by the EP layer."""
    jcfg, jparams, tcfg, tparams = ep
    mesh = _mesh(WORLD)
    for jp, tp_ in ((jparams, tparams),
                    (jtm.quantize_moe_serving_params(jparams),
                     ttm.quantize_moe_serving_params(tparams))):
        specs = jtm.specs_for(jcfg, jp)
        placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jp, specs)
        shards = ttm.shard_params(tp_, WORLD, cfg=tcfg)
        for r in range(WORLD):
            dev = mesh.devices.flat[r].id
            want = jax.tree.map(lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                                               if s.device.id == dev), placed)
            for (path, g), w in zip(
                    jax.tree_util.tree_leaves_with_path(jax.tree.map(_np, shards[r])),
                    jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert shards[0]["layers"][0]["w_up"].shape == (E // WORLD, HID, FFN)
    assert shards[0]["layers"][0]["w_down_scale"].shape == (E // WORLD, 1, HID)

    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, jcfg.batch * jcfg.seq)
    specs = jtm.specs_for(jcfg)
    placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jparams, specs)
    want = jax.jit(jax.shard_map(
        lambda t, p: jtm.EPMoETransformer(jcfg)(t, p), mesh=mesh,
        in_specs=(P("tp"), specs), out_specs=P(None, "tp"), check_vma=False,
    ))(jnp.asarray(tokens, jnp.int32), placed)
    m_loc = tokens.size // WORLD
    ctx = initialize_distributed(WORLD, device="cpu")
    shards = ttm.shard_params(tparams, WORLD, cfg=tcfg)

    def forward(shard):
        return lambda: ttm.EPMoETransformer(tcfg, ctx=ctx)(
            torch.from_numpy(tokens[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]), shard[ctx.rank])

    got = torch.cat(ctx.run(forward(shards)), dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="whole experts"):
        ctx.run(forward(ttm.shard_params(tparams, WORLD)))


def _tp_cfgs(jcfg, tcfg):
    """The tensor-parallel twins of the EP configs (same fields)."""
    base = {f.name for f in dataclasses.fields(ttm.MoETransformerConfig)}
    jbase = {f.name for f in dataclasses.fields(jtm.MoETransformerConfig)}
    return (jtm.MoETransformerConfig(**{k: getattr(jcfg, k) for k in jbase}),
            ttm.MoETransformerConfig(**{k: getattr(tcfg, k) for k in base}))


GENERATE_CASES = {  # name: (prefill, one-byte wire and banks)
    "bulk": (False, None),
    "prefill-int8-wire-int8-banks": (True, "int8"),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_ep_greedy_tokens_match_jax_and_tp(ep, case):
    """Greedy ``generate`` at world 4 on the EP decoder: the decode MLP's
    row slice, dispatch and gather (and with ``prefill=True`` the EP forward
    writing the cache) give the JAX package's EP tokens, and the port's
    tensor-parallel decoder's on the float banks (the JAX package's own
    EP = TP check, the one-byte case included)."""
    prefill, quant = GENERATE_CASES[case]
    jcfg, jparams, tcfg, tparams = ep
    tp_cfg, tp_params = _tp_cfgs(jcfg, tcfg)[1], tparams
    if quant is not None:
        jcfg = dataclasses.replace(jcfg, ep_quant=quant)
        tcfg = dataclasses.replace(tcfg, ep_quant=quant)
        jparams = jtm.quantize_moe_serving_params(jparams)
        tparams = ttm.quantize_moe_serving_params(tparams)
    prompt = np.random.default_rng(51).integers(0, DIMS["vocab"], (DIMS["batch"], PROMPT_LEN))
    want = jdec.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), N_STEPS, _mesh(WORLD),
                         s_max=S_MAX, fd_config=JaxFDConfig(block_s=4), prefill=prefill)
    kw = dict(s_max=S_MAX, prefill=prefill, device="cpu")
    got = tdec.generate(tcfg, tparams, prompt, N_STEPS,
                        ctx=initialize_distributed(WORLD, device="cpu"), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tp_tokens = tdec.generate(tp_cfg, tp_params, prompt, N_STEPS,
                              ctx=initialize_distributed(WORLD, device="cpu"), **kw)
    np.testing.assert_array_equal(got.numpy(), tp_tokens.numpy())


ENGINE_CASES = {  # name: (ServingConfig fields, one-byte wire and banks)
    "bulk": ({}, None),
    "chunked-prefix-cache": (dict(prefill_chunk_tokens=4, prefix_cache=PrefixCacheConfig()),
                             None),
    "quantize-once-int8": ({}, "int8"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_ep_serving_engine_matches_tp(ep, case):
    """``ServingEngine`` at world 4, paged, bulk prefill: the EP decoder's
    greedy tokens equal the tensor-parallel decoder's on the same traffic —
    with chunked prefill and the prefix cache (the ranged pass runs the
    decode MLP), and from float banks under ``gg_config.w8`` with the int8
    wire (the engine quantizes once; the banks split on the expert dim)."""
    fields, quant = ENGINE_CASES[case]
    _, _, tcfg, tparams = ep
    tp_cfg = _tp_cfgs(ep[0], tcfg)[1]
    if quant is not None:
        gg = tgg.GroupGemmConfig(BM, w8=True)
        tcfg = dataclasses.replace(tcfg, gg_config=gg, ep_quant=quant)
        tp_cfg = dataclasses.replace(tp_cfg, gg_config=gg)
    prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 3, 3], [5, 4, 3], [7])
    out = []
    for cfg in (tcfg, tp_cfg):
        eng = teng.ServingEngine(cfg, tparams, s_max=32, page_size=4, prefill=True,
                                 device="cpu", ctx=initialize_distributed(WORLD, device="cpu"),
                                 serving=teng.ServingConfig(**fields))
        if quant is not None:
            served = eng._serving_params()
            assert served is not tparams and served["layers"][0]["w_up"].dtype == torch.int8
        for i, p in enumerate(prompts):
            eng.submit(tdec.Request(list(p), max_new_tokens=3, uid=f"r{i}"))
        out.append({u: r.tokens for u, r in eng.run_until_idle().items()})
    assert len(out[0]) == len(prompts) and out[0] == out[1]


def test_ep_presets_and_refusals(ep):
    """``:ep`` builds the EP config; hierarchical EP builds too (the preset,
    the config field, the layer, which needs a runtime with both axes);
    decode rows that do not divide over the ranks refuse. EP training (with
    ragged rows too) runs: a world-1 step of each keeps the loss finite and
    moves the router (held to JAX's steps in ``test_torch_train2d.py``)."""
    cfg = tpresets.preset("mixtral-8x7b:ep", n_layers=8, batch=8)
    assert isinstance(cfg, ttm.EPMoETransformerConfig)
    assert (cfg.hidden, cfg.ffn, cfg.n_experts, cfg.topk, cfg.ep_max_m, cfg.ep_quant) == (
        4096, 14336, 8, 2, None, None)
    assert tpresets.preset("mixtral-8x7b", ep=True) == tpresets.preset("mixtral-8x7b:ep")
    with pytest.raises(ValueError, match="dense"):
        tpresets.preset("llama-3.1-8b:ep")
    assert tpresets.preset("mixtral-8x7b:ep-hier") == dataclasses.replace(
        tpresets.preset("mixtral-8x7b:ep"), ep_outer="dcn")
    assert ttm.EPMoETransformerConfig(**DIMS, ep_outer="dp").ep_outer == "dp"
    with pytest.raises(ValueError, match="no axis 'dp'|not an axis"):
        tmlp.EPMoEMLP(E, TOPK, 4, initialize_distributed(WORLD, device="cpu"), outer="dp",
                      inner="tp")
    with pytest.raises(ValueError, match="quant"):
        ttm.EPMoETransformerConfig(**DIMS, ep_quant="int4")
    _, _, tcfg, tparams = ep
    tokens = torch.zeros(DIMS["batch"] * DIMS["seq"], dtype=torch.long)
    params = ttm.init_moe_params(tcfg, seed=1, device="cpu")
    ragged = dataclasses.replace(tcfg, gg_config=tgg.GroupGemmConfig(BM, ragged=True))
    trained = {}
    for name, cfg in (("ragged", ragged), ("padded", tcfg)):
        new, loss = ttm.train_step(ttm.EPMoETransformer(cfg), params, tokens, tokens, lr=0.1,
                                   dp_axis=None)
        assert torch.isfinite(loss)
        assert not torch.equal(new["layers"][0]["router"], params["layers"][0]["router"])
        trained[name] = (new, loss)
    # ragged rows change which rows are computed, never a live value
    assert trained["ragged"][1].item() == trained["padded"][1].item()
    ctx = initialize_distributed(WORLD, device="cpu")
    shards = ttm.shard_params(tparams, WORLD, cfg=tcfg)
    x = torch.zeros((6, HID))
    with pytest.raises(ValueError, match="divide evenly"):
        ctx.run(lambda: tdec._decode_mlp(tcfg, x, shards[ctx.rank]["layers"][0], ctx))
