"""The PyTorch port's chunked MoE overlap schedules against the JAX package
on the CPU: the span policies (``resolve_spans`` and its schedules,
``gather_group_blocks_for``, ``torus_factor``) equal to JAX's, their two
``ValueError``s with the reference's text; the overlapped up- and
down-projections under ``GroupGemmConfig(chunks_per_shard=2|3,
span_policy=...)`` at world 2 and 4 (padded and ragged, f32, bf16 and int8
banks; the plain twins of K32 and K33 here) against JAX's
``ag_group_gemm_overlap`` and ``moe_reduce_rs_overlap`` with their chunked
Pallas kernels interpreted; the ``ragged_dot`` backend through
``group_gemm`` and ``tp_moe_mlp`` at world 1 and 2; a two-layer TP MoE
``FakeClock`` serve at world 2 under ``chunks_per_shard=2``; and the
reference's errors and fields of ``preset(tp_check=, ep_outer=)`` and
``ServingConfig`` / ``submit(priority=)``.

Inputs come from numpy with a seed. The op cells are sized so that both
kernels really run more than one span: the combine side cuts a rank's
``m_out`` token rows into 128-row quanta, so each rank holds 256 or 384
tokens (hidden 16, 4 experts, top-2, 128-row blocks), and the AG side's
gather group is one block (``gather_group_blocks=1``). The JAX fused
kernels run with ``fallback_to_xla`` off, so a kernel that fails to trace
fails the test instead of handing over its golden.

Tolerances: spans, factorizations and group sizes are integers and must
be equal; the f32 ops sum the same products in another order, 1e-5, and
so do the bf16 up-projection's f32 rows; the bf16 down-projection within
2^-7 of its largest magnitude: the JAX kernel rounds each grouped-GEMM row
and routing weight to bf16 for its one-hot combine product
(``ops/gg_pipeline.py:723-730``), where its own golden and the port keep
them f32; the MoE MLP 1e-4 (two chained products with a GELU between);
tokens identical.
"""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu import config as jconfig
from triton_dist_tpu.models import tp_transformer as jtm
from triton_dist_tpu.ops import moe_utils as jmu
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.grads import _tp_moe_forward_impl
from triton_dist_tpu.parallel import topology as jtopo
from triton_dist_tpu.resilience import retry as jretry
from triton_dist_tpu.serving import engine as jeng
from triton_dist_tpu.serving import traffic as jtraffic
from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.ops import allgather_group_gemm as tagg
from triton_dist_tpu_torch.ops import common as tcommon
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import moe_mlp as tmlp
from triton_dist_tpu_torch.ops import moe_reduce_rs as trs
from triton_dist_tpu_torch.ops import moe_utils as tmu
from triton_dist_tpu_torch.parallel import topology as ttopo
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import retry as tretry
from triton_dist_tpu_torch.serving import engine as teng
from triton_dist_tpu_torch.serving import traffic as ttraffic

# the JAX package's ops/__init__ re-exports functions under these modules' names
jgg = importlib.import_module("triton_dist_tpu.ops.group_gemm")
jcommon = importlib.import_module("triton_dist_tpu.ops.common")
jagg = importlib.import_module("triton_dist_tpu.ops.allgather_group_gemm")
jrs = importlib.import_module("triton_dist_tpu.ops.moe_reduce_rs")

TOL = 1e-5
MLP_TOL = 1e-4
E, TOPK = 4, 2


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _t(x):
    """A numpy (or JAX) array as a torch tensor, bf16 through f32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _routing(rng, tokens, n_exp=E, topk=TOPK):
    """Distinct top-k experts per token, and f32 weights summing to 1."""
    ids = np.argsort(rng.random((tokens, n_exp)), axis=1)[:, :topk].astype(np.int32)
    w = rng.random((tokens, topk)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.fixture
def fused_only():
    """The JAX entries' fused kernels, loudly: no silent golden fallback."""
    old = jconfig.get_config().fallback_to_xla
    jconfig.update(fallback_to_xla=False)
    yield
    jconfig.update(fallback_to_xla=old)


# ------------------------------------------------------- span policies ----

@pytest.mark.parametrize("policy", sorted(tcommon.SPAN_POLICIES))
def test_span_policies_match_jax(policy):
    """``resolve_spans`` (both sides, every policy) over a grid of rows,
    chunks, quanta and worlds equal to JAX's, or the same ``ValueError``;
    ``torus_factor`` and ``gather_group_blocks_for`` equal."""
    assert sorted(tcommon.SPAN_POLICIES) == sorted(jcommon.SPAN_POLICIES)
    grid = itertools.product((1, 7, 128, 500, 512, 2048), (1, 2, 3, 5, 16), (1, 128, 1024),
                             (1, 2, 3, 4, 8), ("ag", "moe_rs"))
    for rows, chunks, quantum, world, side in grid:
        kw = dict(policy=policy, world=world, side=side)
        try:
            want = jcommon.resolve_spans(rows, chunks, quantum, **kw)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                tcommon.resolve_spans(rows, chunks, quantum, **kw)
            assert str(got.value) == str(err)
            continue
        assert tcommon.resolve_spans(rows, chunks, quantum, **kw) == want, (rows, chunks,
                                                                             quantum, kw)
    for n in range(1, 65):
        assert ttopo.torus_factor(n) == jtopo.torus_factor(n), n
    for nb, bm, k, itemsize in itertools.product((1, 3, 16, 40), (8, 128, 512), (16, 4096),
                                                 (1, 2, 4)):
        assert (tagg.gather_group_blocks_for(nb, bm, k, itemsize)
                == jagg.gather_group_blocks_for(nb, bm, k, itemsize))


def test_span_policy_errors_match_jax():
    """The reference's two ``ValueError``s word for word, and the overlap
    entries raise them before anything runs (world 2, CPU)."""
    for policy, side in (("no-such", "moe_rs"), ("no-such", "ag"), ("interleave", "ag")):
        with pytest.raises(ValueError) as want:
            jcommon.validate_span_policy(policy, side)
        with pytest.raises(ValueError) as got:
            tcommon.validate_span_policy(policy, side)
        assert str(got.value) == str(want.value)
    ctx = initialize_distributed(2, device="cpu")
    ids = torch.tensor([[0, 1], [2, 3], [1, 2], [0, 3]], dtype=torch.int32)
    ral = tmu.moe_align_ranked(ids.reshape(2, -1), E, 8, 2)
    x, b = torch.zeros(2, 4), torch.zeros(E, 4, 4)

    def calls():
        out = []
        for policy in ("interleave", "no-such"):
            cfg = tgg.GroupGemmConfig(8, chunks_per_shard=2, span_policy=policy)
            with pytest.raises(ValueError, match="span_policy") as err:
                tagg.ag_group_gemm_overlap(x, b, ral, ctx=ctx, config=cfg)
            out.append(str(err.value))
        dst, wr = tmu.ranked_scatter_meta(ral, torch.ones(4, TOPK))
        with pytest.raises(ValueError, match="unknown span_policy"):
            trs.moe_reduce_rs_overlap(torch.zeros(2 * ral.t_pad_loc, 4), b, ral.expert_ids,
                                      dst, wr, ctx=ctx, m_out=2,
                                      config=tgg.GroupGemmConfig(8, span_policy="no-such"))
        # the sentinel backend has no fused form at world > 1
        for fn in (lambda c: tagg.ag_group_gemm_overlap(x, b, ral, ctx=ctx, config=c),
                   lambda c: trs.moe_reduce_rs_overlap(
                       torch.zeros(2 * ral.t_pad_loc, 4), b, ral.expert_ids, dst, wr,
                       ctx=ctx, m_out=2, config=c)):
            with pytest.raises(ValueError, match="ragged_dot sentinel"):
                fn(tgg.GroupGemmConfig(8, backend="ragged_dot"))
        return out

    tagg._ag_overlap_xla.calls = 0
    for msgs in ctx.run(calls):
        assert "emits non-contiguous span order" in msgs[0] and "known:" in msgs[1]
    assert tagg._ag_overlap_xla.calls == 0  # refused before the plain twin ran


# ------------------------------------------------- the overlapped ops ----

# name: (world, chunks, ragged, format, AG policy, combine policy); 256 tokens
# a rank for two chunks, 384 for three
OPS_CASES = {
    "w2-c2-bf16": (2, 2, False, "bf16", "contig", "window"),
    "w2-c3-w8-ragged": (2, 3, True, "w8", "window", "interleave"),
    "w4-c2-ragged": (4, 2, True, "f32", "torus2d", "torus2d"),
    "w4-c3-padded": (4, 3, False, "f32", "contig", "interleave"),
}
OPS_E, OPS_BM, OPS_HID, OPS_FFN, GROUP_BLOCKS = 2, 128, 16, 32, 1


@pytest.mark.parametrize("case", list(OPS_CASES))
def test_chunked_overlap_ops_match_jax(fused_only, case):
    """The overlapped up-projection (its gathered slabs too) and the
    down-projection + combine + reduce-scatter under a chunked config
    against JAX's entries with their chunked Pallas kernels interpreted;
    both sides' span lists hold more than one span."""
    world, chunks, ragged, fmt, ag_policy, rs_policy = OPS_CASES[case]
    m_loc = 128 * chunks
    f_loc = OPS_FFN // world
    rng = np.random.default_rng(list(OPS_CASES).index(case))
    x = rng.standard_normal((world * m_loc, OPS_HID)).astype(np.float32)
    w_up = (rng.standard_normal((OPS_E, OPS_HID, OPS_FFN)) / 4).astype(np.float32)
    w_down = (rng.standard_normal((OPS_E, OPS_FFN, OPS_HID)) / 6).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc, OPS_E, 1)
    dtype = jnp.bfloat16 if fmt == "bf16" else jnp.float32
    x, w_up, w_down = (np.asarray(jnp.asarray(a, dtype)) for a in (x, w_up, w_down))

    def jcfg(policy):
        return jgg.GroupGemmConfig(OPS_BM, 32, 16, chunks_per_shard=chunks, ragged=ragged,
                                   w8=fmt == "w8", span_policy=policy)

    def jprog(x, w_up, w_down, ids_full, tw_full):
        ral = jmu.moe_align_ranked(ids_full.reshape(world, -1), OPS_E, OPS_BM, m_loc,
                                   ragged=ragged)
        h, ag = jagg.ag_group_gemm_overlap(x, w_up, ral, axis="tp", config=jcfg(ag_policy),
                                           gather_output=True, out_dtype=jnp.float32,
                                           gather_group_blocks=GROUP_BLOCKS)
        dst, wr = jmu.ranked_scatter_meta(ral, tw_full)
        y = jrs.moe_reduce_rs_overlap(h.astype(dtype), w_down, ral.expert_ids, dst, wr,
                                      axis="tp", m_out=m_loc, valid_rows=ral.valid_rows,
                                      config=jcfg(rs_policy), out_dtype=jnp.float32)
        return h, ag, y

    jh, jag, jy = _shard(
        jprog, world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P(None, None), P(None, None)),
        (P(None, "tp"), P(None, None), P("tp", None)),
    )(*map(jnp.asarray, (x, w_up, w_down, ids, tw)))

    ctx = initialize_distributed(world, device="cpu")
    ral = tmu.moe_align_ranked(_t(ids).reshape(world, -1), OPS_E, OPS_BM, m_loc,
                               ragged=ragged)
    dst, wr = tmu.ranked_scatter_meta(ral, _t(tw))
    t_pad_loc, k = ral.t_pad_loc, OPS_HID
    ag_spans = tcommon.resolve_spans(t_pad_loc, chunks, GROUP_BLOCKS * OPS_BM,
                                     policy=ag_policy, world=world, side="ag")
    rs_spans = tcommon.resolve_spans(m_loc, chunks, 128, policy=rs_policy, world=world)
    assert len(ag_spans) > 1 and len(rs_spans) > 1 and k == OPS_HID

    def tcfg(policy):
        return tgg.GroupGemmConfig(OPS_BM, chunks_per_shard=chunks, ragged=ragged,
                                   w8=fmt == "w8", span_policy=policy)

    def rank():
        r = ctx.rank
        h, ag = tagg.ag_group_gemm_overlap(
            _t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]), ral,
            ctx=ctx, config=tcfg(ag_policy), gather_output=True, out_dtype=torch.float32,
            gather_group_blocks=GROUP_BLOCKS)
        y = trs.moe_reduce_rs_overlap(
            _t(np.asarray(jh)[:, r * f_loc:(r + 1) * f_loc]).to(_t(x).dtype),
            _t(w_down[:, r * f_loc:(r + 1) * f_loc]), ral.expert_ids, dst, wr, ctx=ctx,
            m_out=m_loc, valid_rows=ral.valid_rows, config=tcfg(rs_policy),
            out_dtype=torch.float32)
        return h, ag, y

    outs = ctx.run(rank)
    np.testing.assert_allclose(torch.cat([h for h, _, _ in outs], 1).numpy(), np.asarray(jh),
                               rtol=TOL, atol=TOL)
    for _, ag, _ in outs:
        np.testing.assert_array_equal(ag.float().numpy(), np.asarray(jag, np.float32))
    y, jy = torch.cat([y for _, _, y in outs]).numpy(), np.asarray(jy)
    if fmt == "bf16":
        np.testing.assert_allclose(y, jy, rtol=2.0**-7, atol=2.0**-7 * np.abs(jy).max())
    else:
        np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)


# ------------------------------------------------- the ragged_dot backend ----

@pytest.mark.parametrize("world", [1, 2])
def test_ragged_dot_backend_matches_jax(world):
    """``backend="ragged_dot"``: at world 1 the grouped GEMM (f32 with the
    GELU on A, and an int8 bank with its scale fold) against JAX's
    sentinel; at world 1 and 2 the MoE MLP (the sequential composition the
    backend routes to, ``overlap=True`` asked) against JAX's, and equal to
    the port's ``pallas`` MLP to 1e-5."""
    bm, m_loc, hid, ffn = 8, 8, 32, 64
    rng = np.random.default_rng(70 + world)
    x = rng.standard_normal((world * m_loc, hid)).astype(np.float32)
    w_up = (rng.standard_normal((E, hid, ffn)) / np.sqrt(hid)).astype(np.float32)
    w_down = (rng.standard_normal((E, ffn, hid)) / np.sqrt(ffn)).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc)
    jcfg = jgg.GroupGemmConfig(bm, 64, 64, backend="ragged_dot")
    tcfg = tgg.GroupGemmConfig(bm, backend="ragged_dot")
    if world == 1:
        al = tmu.moe_align_block_size(_t(ids).reshape(-1), E, bm)
        jal = jmu.moe_align_block_size(jnp.asarray(ids).reshape(-1), E, bm)
        np.testing.assert_array_equal(al.expert_ids.numpy(), np.asarray(jal.expert_ids))
        a = rng.standard_normal((al.sorted_token_ids.numel(), hid)).astype(np.float32)
        for act, w8 in ((True, False), (False, True)):
            kw = dict(act_fn=jax.nn.gelu if act else None)
            want = jgg.group_gemm(jnp.asarray(a), jnp.asarray(w_up), jal.expert_ids,
                                  config=jgg.GroupGemmConfig(bm, 64, 64, w8=w8,
                                                             backend="ragged_dot"), **kw)
            got = tgg.group_gemm(_t(a), _t(w_up), al.expert_ids,
                                 config=tgg.GroupGemmConfig(bm, w8=w8, backend="ragged_dot"),
                                 act_fn=tgg.gelu if act else None)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    want = _shard(
        lambda *a: _tp_moe_forward_impl(*a, "tp", jax.nn.gelu, jcfg, None, True)[0],
        world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None), P("tp", None)),
        P("tp", None),
    )(*map(jnp.asarray, (x, w_up, w_down, ids, tw)))
    f_loc = ffn // world

    def args(r):
        return (_t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
                _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(ids[r * m_loc:(r + 1) * m_loc]),
                _t(tw[r * m_loc:(r + 1) * m_loc]))

    got = {}
    for cfg in (tcfg, tgg.GroupGemmConfig(bm)):
        tagg._ag_overlap_xla.calls = tgg._group_gemm_plain.calls = 0
        if world == 1:
            got[cfg.backend] = tmlp.tp_moe_mlp(*args(0), gg_config=cfg)
        else:
            ctx = initialize_distributed(world, device="cpu")
            got[cfg.backend] = torch.cat(ctx.run(lambda: tmlp.tp_moe_mlp(
                *args(ctx.rank), ctx=ctx, gg_config=cfg)))
        if cfg is tcfg:  # both grouped GEMMs of every rank, no overlapped pair
            assert tgg._group_gemm_plain.calls == 2 * world
            assert tagg._ag_overlap_xla.calls == 0
    np.testing.assert_allclose(got["ragged_dot"].numpy(), np.asarray(want), rtol=MLP_TOL,
                               atol=MLP_TOL)
    np.testing.assert_allclose(got["ragged_dot"].numpy(), got["pallas"].numpy(), rtol=TOL,
                               atol=TOL)


# ----------------------------------------------------- the chunked serve ----

SERVE_DIMS = dict(vocab=32, hidden=32, ffn=64, n_layers=2, n_q_heads=4, n_kv_heads=2,
                  head_dim=8, batch=2, seq=8, n_experts=E, topk=TOPK)


def test_chunked_tp_moe_serve_matches_jax():
    """A two-layer TP MoE ``ServingEngine`` serve at world 2 under
    ``GroupGemmConfig(8, chunks_per_shard=2)`` on a ``FakeClock``: tokens
    and lifecycle timestamps equal to the JAX engine's under the same
    config."""
    jcfg = jtm.MoETransformerConfig(
        **SERVE_DIMS, ag_config=AGGemmConfig(16, 128, 128), rs_config=GemmRSConfig(16, 128, 128),
        gg_config=jgg.GroupGemmConfig(8, 64, 64, chunks_per_shard=2))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jtm.init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            SERVE_DIMS["ffn"] if "w_down" in str(path[-1]) else SERVE_DIMS["hidden"]) ** -0.5),
            x.dtype),
        shapes)
    tcfg = ttm.MoETransformerConfig(**SERVE_DIMS,
                                    gg_config=tgg.GroupGemmConfig(8, chunks_per_shard=2))
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)

    def spec(mod):  # prompts of 3-4 tokens: one prefill bucket (one JAX program)
        return mod.TrafficSpec(rate_rps=8.0, n_requests=2, prompt_len=("uniform", 3, 4),
                               output_len=("uniform", 2, 4), vocab=SERVE_DIMS["vocab"], seed=5)

    jtrace, ttrace = jtraffic.generate_trace(spec(jtraffic)), ttraffic.generate_trace(
        spec(ttraffic))
    serving = dict(virtual_step_s=0.01, virtual_prefill_work_s=1e-4, max_queue=3)
    jeng_ = jeng.ServingEngine(jcfg, jparams, _mesh(2), s_max=16, clock=jretry.FakeClock(),
                               serving=jeng.ServingConfig(**serving), page_size=4,
                               prefill=True)
    teng_ = teng.ServingEngine(tcfg, tparams, s_max=16, clock=tretry.FakeClock(), device="cpu",
                               ctx=initialize_distributed(2, device="cpu"),
                               serving=teng.ServingConfig(**serving), page_size=4,
                               prefill=True)
    jdone, tdone = jeng_.serve(jtrace), teng_.serve(ttrace)
    assert sorted(tdone) == sorted(jdone) and len(tdone) == 2
    for uid, want in jdone.items():
        got = tdone[uid]
        assert got.tokens == want.tokens, uid
        assert (got.t_enqueue, got.t_admitted, got.t_first_token, got.t_finished) == (
            want.t_enqueue, want.t_admitted, want.t_first_token, want.t_finished), uid


# ---------------------------------- presets and serving config (C2, C3) ----

def test_preset_checks_and_serving_config_match_reference():
    """``preset(tp_check=)`` raises the reference's ``ValueError`` word for
    word (and passes the config through where the degree divides);
    ``ep_outer=`` builds the hierarchical expert-parallel config;
    ``ServingConfig`` and ``Rejected`` carry the reference's fields in
    its order; ``submit(priority=)`` is accepted and inert."""
    from triton_dist_tpu.models import presets as jpresets
    from triton_dist_tpu_torch.models import presets as tpresets

    for name, tp in (("llama-3.1-8b", 3), ("llama-3.1-70b", 16), ("mixtral-8x7b", 5)):
        with pytest.raises(ValueError) as want:
            jpresets.preset(name, tp_check=tp)
        with pytest.raises(ValueError) as got:
            tpresets.preset(name, tp_check=tp)
        assert str(got.value) == str(want.value)
    assert tpresets.preset("mixtral-8x7b", tp_check=4) == tpresets.preset("mixtral-8x7b")
    for kw in (dict(ep_outer="dcn"), dict(ep=True, ep_outer="dcn")):
        got, want = tpresets.preset("mixtral-8x7b", **kw), jpresets.preset("mixtral-8x7b", **kw)
        assert type(got).__name__ == type(want).__name__ and got.ep_outer == want.ep_outer
        assert (got.hidden, got.ffn, got.n_experts, got.topk) == (
            want.hidden, want.ffn, want.n_experts, want.topk)
    for pkg in (jpresets, tpresets):
        with pytest.raises(ValueError, match="is dense"):
            pkg.preset("llama-3.1-8b", ep_outer="dcn")

    def fields(cls):
        return [f.name for f in dataclasses.fields(cls)]

    assert fields(teng.ServingConfig) == fields(jeng.ServingConfig)
    assert fields(teng.Rejected) == fields(jeng.Rejected)
    for name in ("probe_interval_steps", "max_step_failures"):
        with pytest.raises(ValueError) as want:
            jeng.ServingConfig(**{name: 0}).validate()
        with pytest.raises(ValueError) as got:
            teng.ServingConfig(**{name: 0}).validate()
        assert str(got.value) == str(want.value)
    assert teng.ServingConfig(probe_interval_steps=5).validate().probe_interval_steps == 5
    for kw in (dict(max_step_failures=3), dict(world_ok=lambda n: True)):
        with pytest.raises(NotImplementedError, match="A9"):
            teng.ServingConfig(**kw).validate()
    cfg = ttm.TransformerConfig(vocab=32, hidden=32, ffn=64, n_layers=1, n_q_heads=4,
                                n_kv_heads=2, head_dim=8, batch=1, seq=8)
    eng = teng.ServingEngine(cfg, ttm.init_params(cfg, device="cpu"), s_max=16,
                             clock=tretry.FakeClock(), device="cpu",
                             serving=teng.ServingConfig(max_queue=1))
    # a takes the one slot, b the one queue place, c is turned away
    assert eng.submit(tdec.Request([1, 2], 2, uid="a"), priority="batch") == "a"
    assert eng.submit(tdec.Request([3], 2, uid="b"), priority="batch") == "b"
    rej = eng.submit(tdec.Request([4], 2, uid="c"), priority="interactive")
    assert isinstance(rej, teng.Rejected) and rej.priority is None and rej.uid == "c"
    assert sorted(eng.run_until_idle()) == ["a", "b"]
