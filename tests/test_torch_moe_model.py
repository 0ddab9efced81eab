"""The PyTorch port's MoE decoder against the JAX package on the CPU, at
world 1 and 2: ``shard_params`` against the JAX per-device shards of
``moe_param_specs``, the ``TPMoETransformer`` forward, greedy ``generate``
and the ``ContinuousBatcher`` (greedy and seeded-sampled requests) on the
contiguous and the paged cache, and a ``FakeClock`` ``ServingEngine``
serve at world 1 — the twin of
``tests/test_decode.py::test_generate_moe_matches_full_forward``. The JAX
weights (``init_moe_params``) are carried over with ``params_from_numpy``;
JAX runs under ``shard_map`` with its Pallas kernels interpreted, the
port's ranks are threads of a CPU ``DistContext`` running the plain
versions. One decoder block, hidden 32, 4 experts, top-2, 8-row blocks.
The JAX weights are ``init_moe_params``' tree filled from numpy (its shapes
from ``jax.eval_shape``: no ``jax.random`` program to compile).

f32 throughout, the packages differ only in summation order: 1e-4 on
logits; tokens, timestamps and the trace fingerprint must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import decode as jdec
from triton_dist_tpu.models.tp_transformer import (
    MoETransformerConfig as JaxMoEConfig,
    TPMoETransformer as JaxTPMoETransformer,
    init_moe_params as jax_init_moe_params,
    moe_param_specs,
)
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.group_gemm import GroupGemmConfig as JaxGGConfig
from triton_dist_tpu.resilience import retry as jretry
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu.serving import metrics as jmetrics
from triton_dist_tpu.serving import traffic as jtraffic
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import presets as tpresets
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import retry as tretry
from triton_dist_tpu_torch.serving import engine as teng
from triton_dist_tpu_torch.serving import metrics as tmetrics
from triton_dist_tpu_torch.serving import traffic as ttraffic

TOL = 1e-4
DIMS = dict(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4, n_kv_heads=2,
            head_dim=8, batch=2, seq=8, n_experts=4, topk=2)
S_MAX = 16


@pytest.fixture(scope="module")
def moe():
    # whole-operand tiles: the fewest interpreted grid steps; 8-row blocks
    jcfg = JaxMoEConfig(**DIMS, ag_config=AGGemmConfig(16, 128, 128),
                        rs_config=GemmRSConfig(16, 128, 128),
                        gg_config=JaxGGConfig(8, 64, 64))
    # init_moe_params' tree at its scales: norms at one, the embedding at
    # 0.02, every matrix at one over the square root of its fan-in
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jax_init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            DIMS["ffn"] if "w_down" in str(path[-1]) else DIMS["hidden"]) ** -0.5), x.dtype),
        shapes)
    tcfg = ttm.MoETransformerConfig(**DIMS, gg_config=GroupGemmConfig(8, 16, 16))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                    torch.float32)
    return jcfg, jparams, tcfg, tparams


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _ctx(world):
    return None if world == 1 else initialize_distributed(world, device="cpu")


@pytest.mark.parametrize("world", [1, 2])
def test_moe_shards_and_forward_match_jax(moe, world):
    jcfg, jparams, tcfg, tparams = moe
    mesh = _mesh(world)
    specs = moe_param_specs(jcfg)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                          jparams, specs)
    shards = ttm.shard_params(tparams, world)
    for r in range(world):
        dev = mesh.devices.flat[r].id
        want = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device.id == dev), placed)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
                jax.tree.map(lambda t: t.numpy(), shards[r])), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w, err_msg=str(path))

    tokens = np.random.default_rng(world).integers(0, jcfg.vocab, jcfg.batch * jcfg.seq)
    want = jax.jit(jax.shard_map(
        lambda t, p: JaxTPMoETransformer(jcfg)(t, p), mesh=mesh,
        in_specs=(P("tp"), specs), out_specs=P(None, "tp"), check_vma=False,
    ))(jnp.asarray(tokens, jnp.int32), placed)
    ctx = _ctx(world)
    m_loc = tokens.size // world
    if ctx is None:
        got = ttm.TPMoETransformer(tcfg)(torch.from_numpy(tokens), tparams)
    else:
        got = torch.cat(ctx.run(lambda: ttm.TPMoETransformer(tcfg, ctx=ctx)(
            torch.from_numpy(tokens[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]),
            shards[ctx.rank])), dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _requests(mod):
    # prompts of 3-4 tokens: one prefill bucket, so JAX compiles one
    # prefill program
    return [
        mod.Request([1, 2, 3], max_new_tokens=4, uid="a"),
        mod.Request([7, 1, 2], max_new_tokens=1, uid="one"),
        mod.Request([5, 4, 3, 2], max_new_tokens=3, temperature=0.9, seed=5, uid="s"),
        mod.Request([9, 3, 3], max_new_tokens=4, temperature=0.7, top_k=5, seed=8, uid="k"),
    ]


CONTIGUOUS, PAGED = dict(), dict(page_size=4, prefill=True)


@pytest.mark.parametrize("world,batcher_kw,generate_kw", [(1, PAGED, CONTIGUOUS),
                                                          (2, CONTIGUOUS, PAGED)],
                         ids=["world1", "world2"])
def test_moe_tokens_match_jax(moe, world, batcher_kw, generate_kw):
    """Greedy and seeded-sampled requests through the batcher, and greedy
    ``generate``: each world runs the contiguous cache (token-by-token
    prompts) and the paged cache (bulk prefill), one through each entry."""
    jcfg, jparams, tcfg, tparams = moe
    mesh = _mesh(world)
    jb = jdec.ContinuousBatcher(jcfg, jparams, mesh, s_max=S_MAX, **batcher_kw)
    tb = tdec.ContinuousBatcher(tcfg, tparams, s_max=S_MAX, device="cpu", ctx=_ctx(world),
                                **batcher_kw)
    for j, t in zip(_requests(jdec), _requests(tdec)):
        jb.submit(j)
        tb.submit(t)
    assert tb.run(max_steps=100) == jb.run(max_steps=100)

    prompt = np.array([[3, 1, 4, 1], [5, 9, 2, 6]], np.int32)
    want = jdec.generate(jcfg, jparams, prompt, 4, mesh, s_max=S_MAX, **generate_kw)
    got = tdec.generate(tcfg, tparams, prompt, 4, s_max=S_MAX, device="cpu",
                        ctx=_ctx(world), **generate_kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_engine_serve_matches_jax(moe):
    jcfg, jparams, tcfg, tparams = moe

    def spec(mod):
        # prompts of 3-4 tokens: one prefill bucket (one JAX program)
        return mod.TrafficSpec(rate_rps=8.0, n_requests=4, prompt_len=("uniform", 3, 4),
                               output_len=("uniform", 2, 4), vocab=DIMS["vocab"], seed=4)

    sampled = lambda dec, tr: tr.Arrival(  # noqa: E731
        t_s=0.05, request=dec.Request([4, 5, 6], max_new_tokens=4, temperature=0.8,
                                      top_k=6, seed=77, uid="sampled"), deadline_ms=200)
    jtrace = jtraffic.generate_trace(spec(jtraffic)) + (sampled(jdec, jtraffic),)
    ttrace = ttraffic.generate_trace(spec(ttraffic)) + (sampled(tdec, ttraffic),)
    assert ttraffic.trace_fingerprint(ttrace) == jtraffic.trace_fingerprint(jtrace)
    serving = dict(virtual_step_s=0.01, virtual_prefill_work_s=1e-4, max_queue=3)
    kw = dict(page_size=4, prefill=True)
    jeng_ = jeng.ServingEngine(
        jcfg, jparams, _mesh(1), s_max=S_MAX, clock=jretry.FakeClock(),
        serving=jeng.ServingConfig(slo=jmetrics.SLOTargets(ttft_ms=80.0), **serving), **kw)
    teng_ = teng.ServingEngine(
        tcfg, tparams, s_max=S_MAX, clock=tretry.FakeClock(), device="cpu",
        serving=teng.ServingConfig(slo=tmetrics.SLOTargets(ttft_ms=80.0), **serving), **kw)
    jdone, tdone = jeng_.serve(jtrace), teng_.serve(ttrace)
    assert sorted(tdone) == sorted(jdone)
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.tokens == want.tokens, uid
        assert (got.t_enqueue, got.t_admitted, got.t_first_token, got.t_finished) == (
            want.t_enqueue, want.t_admitted, want.t_first_token, want.t_finished), uid
    jsnap, tsnap = jeng_.snapshot(), teng_.snapshot()
    for key in ("requests", "tokens", "latency_ms", "load", "slo", "engine"):
        assert tsnap[key] == jsnap[key], key


def test_moe_preset_init_and_refusals(moe):
    _, _, tcfg, tparams = moe
    cfg = tpresets.preset("mixtral-8x7b", n_layers=8, batch=8)
    assert isinstance(cfg, ttm.MoETransformerConfig)
    assert (cfg.hidden, cfg.ffn, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab,
            cfg.n_experts, cfg.topk, cfg.n_layers, cfg.dtype) == (
        4096, 14336, 32, 8, 128, 32000, 8, 2, 8, torch.bfloat16)
    ep = tpresets.preset("mixtral-8x7b:ep", n_layers=8, batch=8)
    assert isinstance(ep, ttm.EPMoETransformerConfig)
    assert dataclasses.asdict(ep) == dict(dataclasses.asdict(cfg), ep_outer=None,
                                          ep_max_m=None, ep_quant=None)
    assert tpresets.preset("mixtral-8x7b:ep-hier", n_layers=8, batch=8) == dataclasses.replace(
        ep, ep_outer="dcn")
    p = ttm.init_moe_params(tcfg, seed=1, device="cpu")
    layer = p["layers"][0]
    assert (layer["router"].shape, layer["w_up"].shape, layer["w_down"].shape) == (
        (32, 4), (4, 32, 64), (4, 64, 32))
    assert "w_gate_up" not in layer
    assert torch.equal(layer["w_up"], ttm.init_moe_params(tcfg, seed=1, device="cpu")
                       ["layers"][0]["w_up"])
    # the int8/fp8 expert banks are served: the config builds, and a batcher
    # fed pre-quantized banks (with their scales) serves them
    w8cfg = ttm.MoETransformerConfig(**DIMS, gg_config=GroupGemmConfig(8, w8=True))
    assert w8cfg.gg_config.w8
    quant = ttm.quantize_moe_serving_params(tparams)
    assert quant["layers"][0]["w_up"].dtype == torch.int8
    assert quant["layers"][0]["w_up_scale"].shape == (4, 1, 64)
    qb = tdec.ContinuousBatcher(w8cfg, quant, s_max=S_MAX, device="cpu")
    qb.submit(tdec.Request([1, 2, 3], max_new_tokens=2, uid="q"))
    done = dict(qb.run(max_steps=20))
    assert list(done) == ["q"] and len(done["q"]) == 2
    with pytest.raises(NotImplementedError, match="A10"):
        teng.ServingEngine(tcfg, tparams, s_max=S_MAX, device="cpu",
                           serving=teng.ServingConfig(speculative=object()))
    assert dataclasses.replace(tcfg, seq=4).n_experts == 4
