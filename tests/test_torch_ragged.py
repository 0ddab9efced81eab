"""The PyTorch port's ragged-row policy of the MoE grouped GEMMs against the
JAX package on the CPU: the ``valid_rows`` maps of the three alignment
builders and of the EP receiver alignment, the plain ragged grouped GEMM
(K29's twin; f32, bf16, the GELU, int8 and fp8 banks) against the
interpreted Pallas ragged kernel (``_group_gemm_fused(ragged=True)``, two
row panels a block) and against ``jax.lax.ragged_dot`` over the packed live
rows, the overlapped ops' plain twins (K30's and K31's) at world 2, the MoE
MLP at world 1 and 2, ``EPMoEMLP`` at world 4, greedy tokens of ragged
``generate`` and ``ServingEngine`` serves (EP at world 4, tensor-parallel
at world 2), and the refusals that remain (the ragged backward,
``ragged_dot``, chunks, span policies).

Inputs come from numpy with a seed: hidden 32, ffn 64, 4 or 8 experts,
top-2, one layer, 8-row blocks (4 in the model tests). JAX runs under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py`` with its
Pallas kernels interpreted; the port's ranks are threads of a CPU
``DistContext`` running the plain twins.

Tolerances: maps are integers and must be equal; dead rows must be exact
zeros and live rows bit-equal to the padded plain path (the same products,
masked); f32 products against JAX's sum in another order, 1e-5 (1e-4 for
the MLP: two chained products with a GELU between); bf16 outputs within
one bf16 ulp; tokens identical.
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
from triton_dist_tpu.ops import moe_utils as jmu
from triton_dist_tpu.ops.allgather_gemm import AGGemmConfig
from triton_dist_tpu.ops.allgather_group_gemm import _ag_overlap_xla as jax_ag_overlap
from triton_dist_tpu.ops.allgather_group_gemm import presort_local_rows as jax_presort
from triton_dist_tpu.ops.flash_decode import FlashDecodeConfig as JaxFDConfig
from triton_dist_tpu.ops.gemm_reduce_scatter import GemmRSConfig
from triton_dist_tpu.ops.grads import _tp_moe_forward_impl
from triton_dist_tpu.ops.moe_reduce_rs import _moe_rs_overlap_xla as jax_moe_rs_overlap
from triton_dist_tpu_torch.layers import ep_a2a_layer as tlayer
from triton_dist_tpu_torch.layers import ep_moe_mlp as tepmlp
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


def _routing(rng, tokens, n_exp=E):
    """Distinct top-k experts per token, and f32 weights summing to 1."""
    ids = np.argsort(rng.random((tokens, n_exp)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


# expert counts [5, 0, 12, 1]: a tail of 5, a zero-row expert, a full block
# and a tail of 4, a one-row tail (8-row blocks)
CASE_IDS = np.array([0] * 5 + [2] * 12 + [3], np.int32)

_jit_align = jax.jit(jmu.moe_align_block_size, static_argnums=(1, 2),
                     static_argnames="ragged")
_jit_ranked = jax.jit(jmu.moe_align_ranked, static_argnums=(1, 2, 3),
                      static_argnames="ragged")


def _equal_fields(got, want, names):
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_ragged_maps_match_jax():
    """``moe_align_block_size(ragged=True)`` (the case counts, skewed
    routing, a single assignment), ``valid_rows_from_sorted``,
    ``moe_align_ranked(ragged=True)`` and its global view, and the EP
    receiver alignment with its virtual padding expert's blocks dead."""
    rng = np.random.default_rng(0)
    fields = ("sorted_token_ids", "expert_ids", "num_tokens_post_pad", "valid_rows")
    cases = [(CASE_IDS, BM), (rng.choice(E, 48, p=[0.6, 0.3, 0.1, 0.0]).astype(np.int32), 8),
             (np.array([3], np.int32), 4), (rng.integers(0, E, 64).astype(np.int32), 16)]
    for flat, bm in cases:
        want = _jit_align(jnp.asarray(flat), E, bm, ragged=True)
        got = tmu.moe_align_block_size(_t(flat), E, bm, ragged=True)
        _equal_fields(got, want, fields)
        assert got.valid_rows.dtype == torch.int32
        assert tmu.moe_align_block_size(_t(flat), E, bm).valid_rows is None
        np.testing.assert_array_equal(
            tmu.valid_rows_from_sorted(got.sorted_token_ids, bm, flat.size).numpy(),
            np.asarray(jmu.valid_rows_from_sorted(want.sorted_token_ids, bm, flat.size)))
    got = tmu.moe_align_block_size(_t(CASE_IDS), E, BM, ragged=True)
    # the zero-row expert owns no block; the worst-case trailing blocks are dead
    assert got.valid_rows.tolist() == [5, 8, 4, 1] + [0] * (got.valid_rows.numel() - 4)

    for n, m_loc in ((2, 6), (4, 5)):
        ids, _ = _routing(rng, n * m_loc)
        ids_full = ids.reshape(n, m_loc * TOPK)
        jral = _jit_ranked(jnp.asarray(ids_full), E, BM, m_loc, ragged=True)
        tral = tmu.moe_align_ranked(_t(ids_full), E, BM, m_loc, ragged=True)
        _equal_fields(tral, jral, ("local_ids", "src_rows", "expert_ids", "valid_rows"))
        _equal_fields(tmu.ranked_global_view(tral, m_loc, TOPK),
                      jmu.ranked_global_view(jral, m_loc, TOPK), fields)

    # the receiver side: slabs of 6 rows from 4 sources, partly filled
    epr, max_m = 2, 6
    recv_exp = rng.integers(0, epr, (4, max_m)).astype(np.int32)
    splits = np.array([6, 0, 1, 3], np.int32)
    want = jax.jit(jlayer._align_received, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(recv_exp), jnp.asarray(splits), max_m, epr, 4, True)
    got = tlayer._align_received(_t(recv_exp), _t(splits), max_m, epr, 4, ragged=True)
    _equal_fields(got, want, fields)
    # every block of the virtual expert is dead: live rows are the received ones
    assert int(got.valid_rows.sum()) == int(splits.sum())


FORMATS = {  # name: (activation dtype, bank format, fused GELU)
    "f32": ("f32", None, False),
    "f32-gelu": ("f32", None, True),
    "bf16-gelu": ("bf16", None, True),
    "int8": ("f32", "int8", False),
    "fp8-gelu": ("f32", "fp8", True),
}


@pytest.fixture
def small_panels(monkeypatch):
    """Two 4-row panels a block in the JAX kernel, so its panel skip runs
    at 8-row blocks (set on the module itself: the package's ``ops``
    namespace shadows the module's name with a function)."""
    monkeypatch.setattr(jgg, "_PANEL_ROWS", 4)


@pytest.mark.parametrize("case", list(FORMATS))
def test_ragged_group_gemm_plain_matches_pallas(small_panels, case):
    """K29's plain twin against the interpreted Pallas ragged kernel and
    against ``jax.lax.ragged_dot`` over the packed live rows; dead rows are
    exact zeros and live rows bit-equal to the padded plain path."""
    adt, fmt, act = FORMATS[case]
    rng = np.random.default_rng(len(case))
    al = tmu.moe_align_block_size(_t(CASE_IDS), E, BM, ragged=True)
    t_pad, n = al.sorted_token_ids.shape[0], 48
    a = rng.standard_normal((t_pad, HID)).astype(np.float32)
    b = (rng.standard_normal((E, HID, n)) / np.sqrt(HID)).astype(np.float32)
    jdt = jnp.float32 if adt == "f32" else jnp.bfloat16
    ja, jb, scale = jnp.asarray(a, jdt), jnp.asarray(b, jdt), None
    if fmt is not None:
        quantize = jgg.quantize_expert_weights if fmt == "int8" else jgg.quantize_expert_weights_fp8
        jb, scale = quantize(jnp.asarray(b))
    jact = jax.nn.gelu if act else None
    ids, valid = jnp.asarray(al.expert_ids.numpy()), jnp.asarray(al.valid_rows.numpy())
    want = jgg._group_gemm_fused(
        ja, jb, ids, valid_rows=valid, scale=scale, ragged=True, bm=BM, out_dtype=jdt,
        act_fn=jact, cfg=jgg.GroupGemmConfig(BM, 16, 16, ragged=True), interpret=None)
    ta, tb = _t(ja), _t(jb)
    tscale = None if scale is None else _t(scale)
    cfg = tgg.GroupGemmConfig(BM, ragged=True)
    kw = dict(scale=tscale, act_fn=tgg.gelu if act else None)
    got = tgg.group_gemm(ta, tb, al.expert_ids, valid_rows=al.valid_rows, config=cfg, **kw)
    padded = tgg.group_gemm(ta, tb, al.expert_ids, config=tgg.GroupGemmConfig(BM), **kw)

    live = (np.arange(t_pad) % BM) < np.repeat(al.valid_rows.numpy(), BM)
    assert live.sum() == CASE_IDS.size
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert not g[~live].any() and not w[~live].any()
    assert torch.equal(got[torch.from_numpy(live)], padded[torch.from_numpy(live)])
    if adt == "f32":
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    else:  # both round an f32 sum to bf16: at most one ulp apart
        np.testing.assert_allclose(g, w, rtol=2.0**-7, atol=1e-6)
    # the golden of the live rows alone: ragged_dot over them packed by expert
    packed = np.asarray(ja.astype(jnp.float32))[live]
    if act:
        packed = np.asarray(jax.nn.gelu(jnp.asarray(packed)).astype(jdt).astype(jnp.float32))
    bank = jnp.asarray(jb, jnp.float32)
    ref = jax.lax.ragged_dot(jnp.asarray(packed), bank,
                             group_sizes=jnp.bincount(jnp.asarray(CASE_IDS), length=E))
    if scale is not None:
        ref = ref * scale[jnp.asarray(np.sort(CASE_IDS)), 0, :]
    rtol = TOL if adt == "f32" else 2.0**-7
    np.testing.assert_allclose(g[live], np.asarray(ref), rtol=rtol, atol=rtol)


def test_ragged_group_gemm_needs_the_map():
    a, b = torch.zeros(16, 4), torch.zeros(2, 4, 4)
    al = tmu.moe_align_block_size(torch.tensor([0, 1], dtype=torch.int32), 2, 8)
    with pytest.raises(ValueError, match="valid_rows map"):
        tgg.group_gemm(a[:al.sorted_token_ids.shape[0]], b, al.expert_ids,
                       config=tgg.GroupGemmConfig(8, ragged=True))
    ral = tmu.moe_align_ranked(torch.zeros((1, 2), dtype=torch.int32), 2, 8, 1)
    with pytest.raises(ValueError, match="ragged RankedAlignment"):
        tagg.ag_group_gemm_overlap(a[:1], b, ral, config=tgg.GroupGemmConfig(8, ragged=True))


def test_ragged_overlap_ops_match_jax():
    """K30's and K31's plain twins at world 2 against ``_ag_overlap_xla``
    and ``_moe_rs_overlap_xla`` with ``ragged=True``; the gathered slabs
    equal; the down-projection equal to the padded plain path bit for bit
    (the combine reads only live rows)."""
    world, m_loc, f_loc = 2, 6, 16
    rng = np.random.default_rng(12)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, world * f_loc)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((E, world * f_loc, HID)) / 8).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc)

    def jprog(x, w_up, w_down, ids_full, tw_full):
        ral = jmu.moe_align_ranked(ids_full.reshape(world, -1), E, BM, m_loc, ragged=True)
        a_srt = jax_presort(x, ral, "tp")
        h, ag = jax_ag_overlap(a_srt, w_up, None, ral, axis="tp", ragged=True,
                               gather_output=True, out_dtype=jnp.float32)
        dst, wr = jmu.ranked_scatter_meta(ral, tw_full)
        y = jax_moe_rs_overlap(h, w_down, None, ral.expert_ids, dst, wr, axis="tp",
                               ragged=True, valid_rows=ral.valid_rows, m_out=m_loc,
                               out_dtype=jnp.float32)
        return h, ag, y

    jh, jag, jy = _shard(
        jprog, world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P(None, None), P(None, None)),
        (P(None, "tp"), P(None, None), P("tp", None)),
    )(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
      jnp.asarray(tw))

    ctx = initialize_distributed(world, device="cpu")
    ral = tmu.moe_align_ranked(_t(ids).reshape(world, -1), E, BM, m_loc, ragged=True)
    dst, wr = tmu.ranked_scatter_meta(ral, _t(tw))
    cfgs = (tgg.GroupGemmConfig(BM, ragged=True), tgg.GroupGemmConfig(BM))

    def rank():
        r = ctx.rank
        h, ag = tagg.ag_group_gemm_overlap(
            _t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]), ral,
            ctx=ctx, config=cfgs[0], gather_output=True)
        hs = _t(np.asarray(jh)[:, r * f_loc:(r + 1) * f_loc])
        wd = _t(w_down[:, r * f_loc:(r + 1) * f_loc])
        ys = [trs.moe_reduce_rs_overlap(hs, wd, ral.expert_ids, dst, wr, ctx=ctx, m_out=m_loc,
                                        valid_rows=ral.valid_rows, config=cfg)
              for cfg in cfgs]
        return h, ag, ys

    outs = ctx.run(rank)
    np.testing.assert_allclose(torch.cat([h for h, _, _ in outs], 1).numpy(), np.asarray(jh),
                               rtol=TOL, atol=TOL)
    dead = np.repeat(ral.valid_rows.reshape(-1).numpy(), BM) <= np.arange(
        ral.local_ids.numel()) % BM
    assert dead.any() and not np.asarray(jh)[dead].any()
    for _, ag, (ragged, padded) in outs:
        np.testing.assert_array_equal(ag.numpy(), np.asarray(jag))
        assert torch.equal(ragged, padded)
    np.testing.assert_allclose(torch.cat([y[0] for _, _, y in outs]).numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", [1, 2])
def test_ragged_moe_mlp_matches_jax(world):
    """The MoE MLP with a ragged config (world 1: the sequential
    composition over K29's twin; world 2: the overlapped pair over K30's
    and K31's) against JAX's with its Pallas ragged kernels interpreted,
    and equal to the port's padded MLP bit for bit."""
    m_loc = 8
    rng = np.random.default_rng(30 + world)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / np.sqrt(FFN)).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc)
    jcfg = jgg.GroupGemmConfig(BM, 64, 64, ragged=True)
    want = _shard(
        lambda *a: _tp_moe_forward_impl(*a, "tp", jax.nn.gelu, jcfg, None, True)[0],
        world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None), P("tp", None)),
        P("tp", None),
    )(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
      jnp.asarray(tw))
    f_loc = FFN // world

    def args(r):
        return (_t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
                _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(ids[r * m_loc:(r + 1) * m_loc]),
                _t(tw[r * m_loc:(r + 1) * m_loc]))

    got = {}
    for ragged in (True, False):
        cfg = tgg.GroupGemmConfig(BM, ragged=ragged)
        if world == 1:
            got[ragged] = tmlp.tp_moe_mlp(*args(0), gg_config=cfg)
        else:
            ctx = initialize_distributed(world, device="cpu")
            got[ragged] = torch.cat(ctx.run(lambda: tmlp.tp_moe_mlp(*args(ctx.rank), ctx=ctx,
                                                                    gg_config=cfg)))
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)
    assert torch.equal(got[True], got[False])


def test_ragged_ep_moe_mlp_matches_jax():
    """``EPMoEMLP`` at world 4 with a ragged config against JAX's (its
    Pallas ragged kernels interpreted), equal to the padded layer bit for
    bit; the live rows counted are a strict part of the layout's."""
    world, n_exp, m_loc, bm = 4, 8, 6, 4
    rng = np.random.default_rng(41)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((n_exp, HID, FFN)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((n_exp, FFN, HID)) / np.sqrt(FFN)).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc, n_exp)
    jl = JaxEPMoEMLP(n_experts=n_exp, topk=TOPK, max_m=m_loc * TOPK, axis="tp",
                     gg_config=jgg.GroupGemmConfig(bm, 64, 64, ragged=True))
    want = _shard(jl, world, (P("tp", None), P("tp", None, None), P("tp", None, None),
                              P("tp", None), P("tp", None)), P("tp", None))(
        *map(jnp.asarray, (x, w_up, w_down, ids, tw)))
    epr = n_exp // world
    ctx = initialize_distributed(world, device="cpu")
    got, counts = {}, {}
    for ragged in (True, False):
        tepmlp.EPMoEMLP.rows, tepmlp.EPMoEMLP.live_rows = 0, {}

        def body():
            r = ctx.rank
            rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
            layer = tepmlp.EPMoEMLP(n_exp, TOPK, m_loc * TOPK, ctx,
                                    gg_config=tgg.GroupGemmConfig(bm, ragged=ragged))
            return layer(*(_t(a[s]) for a, s in ((x, rows), (w_up, ex), (w_down, ex),
                                                  (ids, rows), (tw, rows))))

        got[ragged] = torch.cat(ctx.run(body))
        counts[ragged] = (tepmlp.EPMoEMLP.rows, tepmlp.EPMoEMLP.live_row_count())
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert torch.equal(got[True], got[False])
    # padded: every layout row is computed; ragged: the live 128-row tiles only
    assert counts[False][0] == counts[False][1] == counts[True][0]
    assert 0 < counts[True][1] < counts[True][0]


# -------------------------------------------------------- the serves ----

MODEL_E, MODEL_BM = 8, 4
DIMS = dict(vocab=32, hidden=HID, ffn=FFN, n_layers=1, n_q_heads=8, n_kv_heads=4,
            head_dim=8, batch=4, seq=8, n_experts=MODEL_E, topk=TOPK)
PROMPT_LEN, N_STEPS, S_MAX = 3, 3, 16


@pytest.fixture(scope="module")
def moe():
    """One MoE weight tree (``init_moe_params``' tree filled from numpy at
    its scales) in both packages."""
    jcfg = jtm.MoETransformerConfig(**DIMS, gg_config=jgg.GroupGemmConfig(MODEL_BM, 64, 64))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda key: jtm.init_moe_params(key, jcfg), jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.ones(x.shape, x.dtype) if "norm" in str(path[-1])
        else jnp.asarray(rng.standard_normal(x.shape) * (0.02 if "embed" in str(path[-1]) else (
            FFN if "w_down" in str(path[-1]) else HID) ** -0.5), x.dtype),
        shapes)
    tparams = ttm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jparams, tparams


SERVE_CASES = {"ep-world4": (True, 4), "tp-world2": (False, 2)}


def _configs(ep, ragged):
    jgc = jgg.GroupGemmConfig(MODEL_BM, 64, 64, ragged=ragged)
    jkw = dict(ag_config=AGGemmConfig(8, 128, 128), rs_config=GemmRSConfig(8, 128, 128))
    jcls, tcls = ((jtm.EPMoETransformerConfig, ttm.EPMoETransformerConfig) if ep else
                  (jtm.MoETransformerConfig, ttm.MoETransformerConfig))
    return (jcls(**DIMS, **jkw, gg_config=jgc),
            tcls(**DIMS, gg_config=tgg.GroupGemmConfig(MODEL_BM, ragged=ragged)))


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_ragged_serves_match_padded_and_jax(moe, case):
    """Greedy tokens of a ragged serve: ``generate`` with bulk prefill
    (the model forward over the ragged GEMMs, then the decode MLP) equal
    to the JAX package's ragged ``generate``; and ``ServingEngine`` (paged,
    bulk prefill, four prompts of unequal length) equal to the padded
    engine's on the same traffic."""
    ep, world = SERVE_CASES[case]
    jparams, tparams = moe
    jcfg, tcfg = _configs(ep, True)
    prompt = np.random.default_rng(51).integers(0, DIMS["vocab"], (DIMS["batch"], PROMPT_LEN))
    want = jdec.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), N_STEPS, _mesh(world),
                         s_max=S_MAX, fd_config=JaxFDConfig(block_s=4), prefill=True)
    got = tdec.generate(tcfg, tparams, prompt, N_STEPS, s_max=S_MAX, prefill=True,
                        device="cpu", ctx=initialize_distributed(world, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 3, 3], [5, 4, 3], [7])
    out = []
    for cfg in (tcfg, _configs(ep, False)[1]):
        eng = teng.ServingEngine(cfg, tparams, s_max=32, page_size=4, prefill=True,
                                 device="cpu", ctx=initialize_distributed(world, device="cpu"))
        for i, p in enumerate(prompts):
            eng.submit(tdec.Request(list(p), max_new_tokens=3, uid=f"r{i}"))
        out.append({u: r.tokens for u, r in eng.run_until_idle().items()})
    assert len(out[0]) == len(prompts) and out[0] == out[1]


# ------------------------------------------------------- the refusals ----

def test_ragged_refusals_that_remain(moe):
    """The ragged backward refuses (ROADMAP B16, ragged dW) at every entry,
    ``train_step`` before its first step; ``ragged_dot``, chunks and span
    policies refuse with their items, ragged or not."""
    a, b = torch.zeros(8, 4), torch.zeros(2, 4, 4)
    e, v = torch.zeros(1, dtype=torch.int32), torch.full((1,), 8, dtype=torch.int32)
    ragged = tgg.GroupGemmConfig(8, ragged=True)
    for refuse in (lambda: tgg.group_gemm_dw(a, a, e, 2, config=ragged),
                   lambda: tgrads.group_gemm_grad(a, b, e, config=ragged),
                   lambda: tgrads.tp_moe_mlp_grad(a[:4], b, b, e.reshape(1, 1).expand(4, 1),
                                                  torch.ones(4, 1), gg_config=ragged)):
        with pytest.raises(NotImplementedError, match="ROADMAP B16, ragged dW"):
            refuse()
    _, tparams = moe
    tcfg = _configs(False, True)[1]
    tokens = torch.zeros(DIMS["batch"] * DIMS["seq"], dtype=torch.long)
    before = [p.clone() for p in tparams["layers"][0].values()]
    with pytest.raises(NotImplementedError, match="ROADMAP B16, ragged dW"):
        ttm.train_step(ttm.TPMoETransformer(tcfg), tparams, tokens, tokens, lr=0.1)
    assert all(torch.equal(p, q) for p, q in zip(before, tparams["layers"][0].values()))
    for fields, item in ((dict(backend="ragged_dot"), "B16, ragged_dot"),
                         (dict(chunks_per_shard=2), "B17/B18, chunked"),
                         (dict(span_policy="window"), "B17/B18, span")):
        for rag in (False, True):
            with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
                tgg.group_gemm(a, b, e, valid_rows=v,
                               config=tgg.GroupGemmConfig(8, ragged=rag, **fields))
    # the ragged forward itself runs: the whole block live is the padded one
    assert torch.equal(tgg.group_gemm(a, b, e, valid_rows=v, config=ragged),
                       tgg.group_gemm(a, b, e, config=tgg.GroupGemmConfig(8)))
    assert dataclasses.replace(ragged, ragged=False) == tgg.GroupGemmConfig(8)
