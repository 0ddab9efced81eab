"""Hierarchical expert parallelism of the PyTorch port on a 2-D rank runtime
(``{"dp": 2, "tp": 2}`` on the CPU) against the JAX package on a 2 x 2
mesh: ``HierEPAll2AllLayer``'s two-phase dispatch and combine (bf16-free
f32 slabs and the int8 phase-1 wire), ``EPMoEMLP`` over the pair, the
hierarchical EP model's forward and ``shard_params`` against
``ep_moe_param_specs``, greedy ``generate`` (token-fed and bulk prefill,
contiguous and paged caches) and the ``ContinuousBatcher`` against the
JAX hierarchical deployment and the port's flat EP serve, the
``:ep-hier`` preset through ``ServingEngine``, and the errors of a batch
that does not divide over the outer groups and of a runtime without the
outer axis.

The JAX side runs under ``shard_map`` with its Pallas all-to-all
interpreted. Weights are the JAX init's tree filled from numpy at its
scales, carried over with ``params_from_numpy``; inputs come from numpy
with a seed. Tolerances: the layers' f32 sums in another order, 1e-5;
greedy tokens identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.layers import ep_a2a_layer as jlayer
from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.flash_decode import FlashDecodeConfig as JaxFDConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu_torch.layers import ep_a2a_layer as tlayer
from triton_dist_tpu_torch.layers import ep_moe_mlp as tmlp
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import presets as tpresets
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.serving import engine as teng

jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")

TOL = 1e-5
SHAPE = {"dp": 2, "tp": 2}
AXES = ("dp", "tp")
N_O, N_I = 2, 2
WORLD = N_O * N_I
E, TOPK, BM, HID, FFN = 8, 2, 4, 32, 64
DIMS = dict(vocab=32, hidden=HID, ffn=FFN, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=4, seq=8, n_experts=E, topk=TOPK)
PROMPT_LEN, N_STEPS, S_MAX = 3, 3, 16


def _jmesh():
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(N_O, N_I), AXES)


def _shard(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_jmesh(), in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


def _ctx():
    return initialize_distributed(mesh_shape=SHAPE, device="cpu")


def _routing(rng, tokens):
    ids = np.argsort(rng.random((tokens, E)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def hier():
    """The JAX and port hierarchical EP configs and weights (the JAX init's
    tree filled from numpy), and the flat EP twin of the port config."""
    kw = dict(DIMS, ep_outer="dp")
    jcfg = jtm.EPMoETransformerConfig(**kw, ag_config=AGGemmConfig(8, 128, 128),
                                      rs_config=GemmRSConfig(8, 128, 128),
                                      gg_config=jgg.GroupGemmConfig(BM, 64, 64))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jtm.init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            FFN if "w_down" in str(path[-1]) else HID) ** -0.5), x.dtype),
        shapes)
    tcfg = ttm.EPMoETransformerConfig(**kw, gg_config=tgg.GroupGemmConfig(BM))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    flat = ttm.EPMoETransformerConfig(**DIMS, gg_config=tgg.GroupGemmConfig(BM))
    return jcfg, jparams, tcfg, tparams, flat


# -------------------------------------------------------------- layers ----

@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32-wire", "int8-wire"])
def test_hier_dispatch_and_combine_match_jax(quant):
    """Two-phase dispatch, identity experts, combine (≙
    ``test_layers.py:276``): the received phase-2 slabs, counts, local
    experts and phase-1 counts equal JAX's, the combined rows too (the
    weighted identity on the f32 wire); with an all-on-one-group routing
    exactly one copy of a token crosses the outer axis."""
    m_loc, hidden = 6, 16
    m_tot = WORLD * m_loc
    rng = np.random.default_rng(7 if quant is None else 8)
    x = rng.standard_normal((m_tot, hidden)).astype(np.float32)
    ids, tw = _routing(rng, m_tot)
    ids[:m_loc] = [0, 1]  # rank 0's tokens: two experts of outer group 0
    max_m1, max_m2 = m_loc, N_O * m_loc * TOPK
    jl = jlayer.HierEPAll2AllLayer(n_experts=E, topk=TOPK, max_m1=max_m1, max_m2=max_m2,
                                   outer="dp", inner="tp", quant=quant)

    def jfn(x, ids, tw):
        recv, info = jl.dispatch(x, ids, tw)
        out = jl.combine(recv, info, m_loc)
        return (recv[None], info.recv_splits2[None], info.recv_expert[None],
                info.send_splits1[None], out)

    spec = P(AXES)
    want = [np.asarray(w) for w in _shard(jfn, (spec,) * 3, (spec,) * 5)(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(tw))]
    ctx = _ctx()
    layer = tlayer.HierEPAll2AllLayer(E, TOPK, max_m1, max_m2, ctx, "dp", "tp", quant=quant)

    def body():
        r = ctx.rank
        rows = slice(r * m_loc, (r + 1) * m_loc)
        recv, info = layer.dispatch(torch.from_numpy(x[rows]), torch.from_numpy(ids[rows]),
                                    torch.from_numpy(tw[rows]))
        return (recv, info.recv_splits2, info.recv_expert, info.send_splits1,
                layer.combine(recv, info, m_loc), info.overflow)

    outs = ctx.run(body)
    for r, got in enumerate(outs):
        for i in range(4):
            np.testing.assert_array_equal(got[i].numpy(), want[i][r], err_msg=f"{i} {r}")
        np.testing.assert_allclose(got[4].numpy(), want[4][r * m_loc:(r + 1) * m_loc],
                                   rtol=TOL, atol=TOL)
        assert int(got[5]) == 0
    assert outs[0][3].tolist() == [m_loc, 0]
    if quant is None:
        want_id = x * tw.sum(-1)[:, None]
        np.testing.assert_allclose(torch.cat([o[4] for o in outs]).numpy(), want_id,
                                   rtol=TOL, atol=TOL)


def _dense_moe(x, w_up, w_down, ids, tw):
    h_e = np.asarray(jax.nn.gelu(jnp.einsum("th,tkhf->tkf", x, w_up[ids])))
    return np.einsum("tk,tkh->th", tw, np.einsum("tkf,tkfh->tkh", h_e, w_down[ids]))


def test_ep_moe_mlp_over_a_pair_matches_the_dense_golden():
    """``EPMoEMLP(outer="dp", inner="tp")`` on 2 x 2 (≙ ``test_layers.py:136``,
    one whole expert... two a rank here) against the per-token dense MoE,
    and equal to the flat layer over the flattened ranks within f32
    summation order."""
    m_loc = 4
    m_tot = WORLD * m_loc
    rng = np.random.default_rng(9)
    x = rng.standard_normal((m_tot, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / 8).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / 8).astype(np.float32)
    ids, tw = _routing(rng, m_tot)
    want = _dense_moe(x, w_up, w_down, ids, tw)
    epr = E // WORLD
    cfg = tgg.GroupGemmConfig(BM)

    def run(ctx, **kw):
        layer = tmlp.EPMoEMLP(E, TOPK, m_loc * TOPK, ctx, gg_config=cfg, **kw)

        def body():
            r = ctx.rank
            rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
            return layer(torch.from_numpy(x[rows]), torch.from_numpy(w_up[ex]),
                         torch.from_numpy(w_down[ex]), torch.from_numpy(ids[rows]),
                         torch.from_numpy(tw[rows]))

        return torch.cat(ctx.run(body)).numpy()

    got = run(_ctx(), outer="dp", inner="tp")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    flat = run(initialize_distributed(WORLD, device="cpu"))
    np.testing.assert_allclose(got, flat, rtol=TOL, atol=TOL)


# --------------------------------------------------------------- model ----

def test_hier_model_forward_and_shard_params_match_jax(hier):
    """``shard_params(..., ctx=)`` on the 2-D runtime equals JAX's
    ``ep_moe_param_specs`` shards on the 2 x 2 mesh (TP shards replicated
    over dp, banks over (dp, tp)); the hierarchical EP forward (≙
    ``test_models.py:243``: each dp group its own token slice) equals
    JAX's to 1e-5."""
    jcfg, jparams, tcfg, tparams, _ = hier
    mesh = _jmesh()
    specs = jtm.ep_moe_param_specs(jcfg)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams, specs)
    ctx = _ctx()
    shards = ttm.shard_params(tparams, cfg=tcfg, ctx=ctx)
    devices = list(mesh.devices.reshape(-1))
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        for shard in leaf.addressable_shards:
            r = devices.index(shard.device)
            node = shards[r]
            for p in path:
                node = node[getattr(p, "key", getattr(p, "idx", None))]
            np.testing.assert_array_equal(node.numpy(), np.asarray(shard.data),
                                          err_msg=str(path))
    m = DIMS["batch"] * DIMS["seq"]
    tokens = np.random.default_rng(10).integers(0, DIMS["vocab"], N_O * m)
    model = jtm.EPMoETransformer(jcfg)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda t, p: model(t, p), mesh=mesh, in_specs=(P(AXES), specs),
        out_specs=P("dp", "tp"), check_vma=False))(jnp.asarray(tokens, jnp.int32), placed))
    m_loc = tokens.size // WORLD
    got = ctx.run(lambda: ttm.EPMoETransformer(tcfg, ctx=ctx)(
        torch.from_numpy(tokens[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]), shards[ctx.rank]))
    got = np.concatenate([torch.cat(got[o * N_I:(o + 1) * N_I], dim=1).numpy()
                          for o in range(N_O)])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


GENERATE_CASES = {  # name: port generate kwargs beside the JAX token-fed run
    "token-fed": dict(),
    "prefill": dict(prefill=True),
    "paged": dict(page_size=4),
    "int8-wire": dict(quant="int8"),
}


@pytest.fixture(scope="module")
def jax_hier_tokens(hier):
    """JAX's hierarchical greedy tokens (one program, token-fed), the
    prompt, and the port's flat EP tokens at world 4 on the same weights."""
    jcfg, jparams, _, tparams, flat = hier
    prompt = np.random.default_rng(51).integers(0, DIMS["vocab"], (DIMS["batch"], PROMPT_LEN))
    want = np.asarray(jdec.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), N_STEPS,
                                    _jmesh(), s_max=S_MAX, fd_config=JaxFDConfig(block_s=4)))
    flat_tokens = tdec.generate(flat, tparams, prompt, N_STEPS, s_max=S_MAX, device="cpu",
                                ctx=initialize_distributed(WORLD, device="cpu")).numpy()
    return prompt, want, flat_tokens


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_hier_greedy_tokens_match_jax_and_flat_ep(hier, jax_hier_tokens, case):
    """Greedy ``generate`` on the hierarchical deployment (≙
    ``test_decode.py:561``): each dp group serves its batch slice, the
    two-phase dispatch spans the four ranks; the tokens equal JAX's
    hierarchical ones and the port's flat EP serve's, token-fed, with the
    bulk prefill, on the paged cache and over the int8 phase-1 wire."""
    import dataclasses

    _, _, tcfg, tparams, _ = hier
    prompt, want, flat_tokens = jax_hier_tokens
    kw = dict(GENERATE_CASES[case])
    quant = kw.pop("quant", None)
    cfg = tcfg if quant is None else dataclasses.replace(tcfg, ep_quant=quant)
    got = tdec.generate(cfg, tparams, prompt, N_STEPS, s_max=S_MAX, device="cpu", ctx=_ctx(),
                        **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flat_tokens)


def test_hier_continuous_batcher_matches_jax(hier):
    """The ``ContinuousBatcher`` schedules against the hierarchical
    deployment unchanged (≙ ``test_decode.py:620``): ragged slots,
    admission and completion give JAX's batcher's tokens, and the port's
    flat EP batcher's."""
    jcfg, jparams, tcfg, tparams, flat = hier
    rng = np.random.default_rng(63)
    specs = [(list(map(int, rng.integers(0, DIMS["vocab"], rng.integers(1, 5)))),
              int(rng.integers(1, 4))) for _ in range(6)]
    jb = jdec.ContinuousBatcher(jcfg, jparams, _jmesh(), s_max=S_MAX,
                                fd_config=JaxFDConfig(block_s=4))
    for i, (p, n) in enumerate(specs):
        jb.submit(jdec.Request(prompt=p, max_new_tokens=n, uid=i))
    want = {u: list(map(int, t)) for u, t in jb.run()}
    for cfg, ctx in ((tcfg, _ctx()), (flat, initialize_distributed(WORLD, device="cpu"))):
        tb = tdec.ContinuousBatcher(cfg, tparams, s_max=S_MAX, device="cpu", ctx=ctx)
        for i, (p, n) in enumerate(specs):
            tb.submit(tdec.Request(p, max_new_tokens=n, uid=i))
        assert {u: list(map(int, t)) for u, t in tb.run()} == want


def test_ep_hier_preset_serves_through_the_engine(hier):
    """``preset("mixtral-8x7b:ep-hier")`` names the outer axis ``"dcn"``
    as the JAX preset does; a config of its family served by
    ``ServingEngine`` on a ``{"dcn": 2, "tp": 2}`` runtime (bulk prefill,
    paged) gives the flat EP engine's tokens."""
    import dataclasses

    from triton_dist_tpu.models import presets as jpresets

    got, want = tpresets.preset("mixtral-8x7b:ep-hier"), jpresets.preset("mixtral-8x7b:ep-hier")
    assert isinstance(got, ttm.EPMoETransformerConfig) and got.ep_outer == want.ep_outer == "dcn"
    _, _, tcfg, tparams, flat = hier
    prompts = np.random.default_rng(70).integers(0, DIMS["vocab"], (5, 4))
    out = []
    for cfg, ctx in ((dataclasses.replace(tcfg, ep_outer="dcn"),
                      initialize_distributed(mesh_shape={"dcn": 2, "tp": 2}, device="cpu")),
                     (flat, initialize_distributed(WORLD, device="cpu"))):
        eng = teng.ServingEngine(cfg, tparams, s_max=S_MAX, page_size=4, prefill=True,
                                 device="cpu", ctx=ctx)
        for i, p in enumerate(prompts):
            eng.submit(tdec.Request(list(p), max_new_tokens=3, uid=f"r{i}"))
        out.append({u: r.tokens for u, r in eng.run_until_idle().items()})
    assert len(out[0]) == len(prompts) and out[0] == out[1]


def test_hier_serving_errors_match_the_reference(hier):
    """A batch that does not divide over the outer groups and a runtime
    without the outer axis raise the JAX package's messages; the prefix
    cache stays flat-only."""
    import dataclasses

    from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig

    jcfg, jparams, tcfg, tparams, _ = hier
    prompt = np.zeros((DIMS["batch"], 2), np.int64)
    with pytest.raises(ValueError) as want:
        jdec.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), 1,
                      Mesh(np.array(jax.devices()[:2]), ("tp",)), s_max=S_MAX)
    with pytest.raises(ValueError) as got:
        tdec.generate(tcfg, tparams, prompt, 1, s_max=S_MAX, device="cpu",
                      ctx=initialize_distributed(2, device="cpu"))
    assert str(got.value) == str(want.value)
    odd = dataclasses.replace(tcfg, batch=3)
    with pytest.raises(ValueError, match="must divide over the 2 outer"):
        tdec.generate(odd, tparams, prompt[:3], 1, s_max=S_MAX, device="cpu", ctx=_ctx())
    with pytest.raises(ValueError, match="flat \\(1-axis\\) serving"):
        tdec.ContinuousBatcher(tcfg, tparams, s_max=S_MAX, page_size=4, device="cpu",
                               ctx=_ctx(), prefix_cache=PrefixCacheConfig())
