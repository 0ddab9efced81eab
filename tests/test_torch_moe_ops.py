"""The PyTorch port's MoE ops against the JAX package on the CPU: the
routing and alignment metadata of ``ops/moe_utils.py``, the plain
grouped GEMM (K8's twin) against ``_group_gemm_xla``, the plain overlapped
up- and down-projections (K9's and K10's twins) against
``_ag_overlap_xla`` and ``_moe_rs_overlap_xla`` at world 2 and 4, and the
MoE MLP forward against ``_tp_moe_forward_impl`` at world 1 (its
sequential composition, the Pallas grouped GEMM interpreted) and world 2
(its overlapped pair, both Pallas kernels interpreted). The port's ranks
are threads of one CPU ``DistContext``; the JAX side runs under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py``. Inputs
come from numpy with a seed; the shapes are tiny (hidden 32, ffn 64, 4
experts, top-2, 8-row blocks).

Tolerances: alignment metadata is integer and must be equal; the routing
ids must be equal and the routing weights agree to 1e-6 (XLA's and
PyTorch's f32 ``exp`` differ in the last bit on some inputs); the ops
compute f32 products and sums of the same f32 inputs in another order —
1e-5, and 1e-4 for the whole MLP (two chained products with a GELU between).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops import moe_utils as jmu
from triton_dist_tpu.ops.allgather_group_gemm import _ag_overlap_xla as jax_ag_overlap
from triton_dist_tpu.ops.allgather_group_gemm import presort_local_rows as jax_presort
from triton_dist_tpu.ops.grads import _tp_moe_forward_impl
from triton_dist_tpu.ops.group_gemm import GroupGemmConfig as JaxGGConfig
from triton_dist_tpu.ops.group_gemm import _group_gemm_xla
from triton_dist_tpu.ops.moe_reduce_rs import _moe_rs_overlap_xla as jax_moe_rs_overlap
from triton_dist_tpu_torch.ops import allgather_group_gemm as tagg
from triton_dist_tpu_torch.ops import group_gemm as tgg
from triton_dist_tpu_torch.ops import moe_mlp as tmlp
from triton_dist_tpu_torch.ops import moe_reduce_rs as trs
from triton_dist_tpu_torch.ops import moe_utils as tmu
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

TOL = 1e-5
MLP_TOL = 1e-4
E, TOPK, BM, HID, FFN = 4, 2, 8, 32, 64


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _shard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _routing(rng, tokens):
    """Distinct top-k experts per token, and f32 weights summing to 1."""
    ids = np.argsort(rng.random((tokens, E)), axis=1)[:, :TOPK].astype(np.int32)
    w = rng.random((tokens, TOPK)).astype(np.float32) + 0.1
    return ids, (w / w.sum(1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# the JAX side jitted: one compile per shape instead of one per primitive
_jit_align = jax.jit(jmu.moe_align_block_size, static_argnums=(1, 2))
_jit_ranked = jax.jit(jmu.moe_align_ranked, static_argnums=(1, 2, 3))


def test_routing_and_alignment_match_jax():
    rng = np.random.default_rng(0)
    # select_experts, ties included: the lower index wins on both sides
    logits = rng.standard_normal((40, E)).astype(np.float32)
    logits[:4] = [[0, 0, 0, 0], [1, 2, 2, 0], [3, 3, -1, 3], [0.5, 0.5, 0.5, 0.5]]
    jw, jids = jax.jit(jmu.select_experts, static_argnums=1)(jnp.asarray(logits), TOPK)
    tw, tids = tmu.select_experts(_t(logits), TOPK)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)

    # moe_align_block_size: skewed and empty experts, several block sizes
    for t, bm in ((48, 8), (7, 4), (64, 16), (1, 8)):
        flat = rng.choice(E, t, p=[0.6, 0.3, 0.1, 0.0]).astype(np.int32)
        want = _jit_align(jnp.asarray(flat), E, bm)
        got = tmu.moe_align_block_size(_t(flat), E, bm)
        for name in ("sorted_token_ids", "expert_ids", "num_tokens_post_pad"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        assert got.block_m == bm and got.sorted_token_ids.dtype == torch.int32

    # gather + combine round trip at 24 tokens
    x = rng.standard_normal((24, HID)).astype(np.float32)
    ids, w = _routing(rng, 24)
    jal = _jit_align(jnp.asarray(ids.reshape(-1)), E, BM)
    tal = tmu.moe_align_block_size(_t(ids.reshape(-1)), E, BM)
    jrows = jmu.gather_sorted_rows(jnp.asarray(x), jal, TOPK)
    trows = tmu.gather_sorted_rows(_t(x), tal, TOPK)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    y = rng.standard_normal((trows.shape[0], HID)).astype(np.float32)
    want = jmu.scatter_add_unsorted(jnp.asarray(y), jal, jnp.asarray(w), 24)
    got = tmu.scatter_add_unsorted(_t(y), tal, _t(w), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    # the per-rank alignment, its global view and the combine metadata
    for n, m_loc in ((2, 6), (4, 5)):
        ids, w = _routing(rng, n * m_loc)
        ids_full = ids.reshape(n, m_loc * TOPK)
        jral = _jit_ranked(jnp.asarray(ids_full), E, BM, m_loc)
        tral = tmu.moe_align_ranked(_t(ids_full), E, BM, m_loc)
        for name in ("local_ids", "src_rows", "expert_ids"):
            np.testing.assert_array_equal(getattr(tral, name).numpy(),
                                          np.asarray(getattr(jral, name)), err_msg=name)
        jg, tg = jmu.ranked_global_view(jral, m_loc, TOPK), tmu.ranked_global_view(
            tral, m_loc, TOPK)
        for name in ("sorted_token_ids", "expert_ids", "num_tokens_post_pad"):
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        for got, want in zip(tmu.ranked_scatter_meta(tral, _t(w)),
                             jmu.ranked_scatter_meta(jral, jnp.asarray(w))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the combine's inverse rows: token t's k-th assignment sits there
        inv = tmu.ranked_combine_rows(tral, m_loc, TOPK).numpy()
        lids = np.asarray(jral.local_ids)
        for c in range(n):
            np.testing.assert_array_equal(
                lids[c][inv[c]], np.arange(m_loc * TOPK).reshape(m_loc, TOPK))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", [False, True], ids=["plain", "gelu"])
def test_group_gemm_plain_matches_xla(act, out_dtype):
    rng = np.random.default_rng(1)
    ids, _ = _routing(rng, 20)
    al = tmu.moe_align_block_size(_t(ids.reshape(-1)), E, BM)
    t_pad = al.sorted_token_ids.shape[0]
    a = rng.standard_normal((t_pad, HID)).astype(np.float32)
    b = (rng.standard_normal((E, HID, FFN)) / np.sqrt(HID)).astype(np.float32)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = _group_gemm_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(al.expert_ids.numpy()),
                           valid_rows=None, scale=None, ragged=False, bm=BM, out_dtype=jdt,
                           act_fn=jax.nn.gelu if act else None)
    got = tgg.group_gemm(_t(a), _t(b), al.expert_ids, config=tgg.GroupGemmConfig(BM, 16, 16),
                         out_dtype=out_dtype, act_fn=tgg.gelu if act else None)
    assert got.dtype == out_dtype and tgg._group_gemm_plain.calls > 0
    want = np.asarray(want, np.float32)
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    else:
        # both round an f32 sum to bf16: at most one ulp apart
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)


def test_group_gemm_refuses_what_is_not_ported():
    """The options this grid GEMM once refused run: ``ragged_dot`` (the
    plain sentinel) equals the padded kernel's twin, and the chunked
    schedule's fields (read only by the overlapped pair) change nothing;
    the ragged weight gradient runs, and needs its map."""
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(8, 4, generator=g), torch.randn(2, 4, 4, generator=g)
    e = torch.ones(1, dtype=torch.int32)
    want = tgg.group_gemm(a, b, e, config=tgg.GroupGemmConfig(8))
    for cfg in (tgg.GroupGemmConfig(8, backend="ragged_dot"),
                tgg.GroupGemmConfig(8, chunks_per_shard=2),
                tgg.GroupGemmConfig(8, span_policy="window")):
        assert torch.equal(tgg.group_gemm(a, b, e, config=cfg), want), cfg
    # ragged rows are served and trained: the weight gradient takes the map
    with pytest.raises(ValueError, match="valid_rows"):
        tgg.group_gemm_dw(a, a, e, 2, config=tgg.GroupGemmConfig(8, ragged=True))
    full = torch.full((1,), 8, dtype=torch.int32)
    assert torch.equal(tgg.group_gemm_dw(a, a, e, 2, valid_rows=full,
                                         config=tgg.GroupGemmConfig(8, ragged=True)),
                       tgg.group_gemm_dw(a, a, e, 2, config=tgg.GroupGemmConfig(8)))
    with pytest.raises(ValueError, match="block_m"):
        tgg.group_gemm(a, b, e, config=tgg.GroupGemmConfig(4))
    with pytest.raises(ValueError, match="valid_rows"):
        tgg.group_gemm(a, b, e, config=tgg.GroupGemmConfig(8, ragged=True))


@pytest.mark.parametrize("world", [2, 4])
def test_overlap_ops_match_jax(world):
    """K9's and K10's plain versions: the up-projection over the exchanged
    sorted slabs (and the gathered slabs), then the down-projection with
    the per-destination combine and the reduce-scatter."""
    m_loc = 6
    rng = np.random.default_rng(10 + world)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, world * 16)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((E, world * 16, HID)) / 8).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc)
    f_loc = 16

    def jprog(x, w_up, w_down, ids_full, tw_full):
        ral = jmu.moe_align_ranked(ids_full.reshape(world, -1), E, BM, m_loc)
        a_srt = jax_presort(x, ral, "tp")
        h, ag = jax_ag_overlap(a_srt, w_up, None, ral, axis="tp", ragged=False,
                               gather_output=True, out_dtype=jnp.float32)
        dst, wr = jmu.ranked_scatter_meta(ral, tw_full)
        y = jax_moe_rs_overlap(h, w_down, None, ral.expert_ids, dst, wr, axis="tp",
                               ragged=False, valid_rows=None, m_out=m_loc,
                               out_dtype=jnp.float32)
        return h, ag, y

    jh, jag, jy = _shard(
        jprog, world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P(None, None), P(None, None)),
        (P(None, "tp"), P(None, None), P("tp", None)),
    )(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
      jnp.asarray(tw))

    ctx = initialize_distributed(world, device="cpu")
    ral = tmu.moe_align_ranked(_t(ids).reshape(world, -1), E, BM, m_loc)
    dst, wr = tmu.ranked_scatter_meta(ral, _t(tw))
    cfg = tgg.GroupGemmConfig(BM, 16, 16)

    def rank():
        r = ctx.rank
        h, ag = tagg.ag_group_gemm_overlap(
            _t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]), ral,
            ctx=ctx, config=cfg, gather_output=True)
        y = trs.moe_reduce_rs_overlap(
            _t(np.asarray(jh)[:, r * f_loc:(r + 1) * f_loc]),
            _t(w_down[:, r * f_loc:(r + 1) * f_loc]), ral.expert_ids, dst, wr, ctx=ctx,
            m_out=m_loc, config=cfg)
        return h, ag, y

    outs = ctx.run(rank)
    np.testing.assert_allclose(torch.cat([h for h, _, _ in outs], 1).numpy(), np.asarray(jh),
                               rtol=TOL, atol=TOL)
    for _, ag, _ in outs:
        np.testing.assert_array_equal(ag.numpy(), np.asarray(jag))
    np.testing.assert_allclose(torch.cat([y for _, _, y in outs]).numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    assert tagg._ag_overlap_xla.calls > 0 and trs._moe_rs_overlap_xla.calls > 0


@pytest.mark.parametrize("world", [1, 2])
def test_moe_mlp_forward_matches_jax(world):
    m_loc = 8
    rng = np.random.default_rng(20 + world)
    x = rng.standard_normal((world * m_loc, HID)).astype(np.float32)
    w_up = (rng.standard_normal((E, HID, FFN)) / np.sqrt(HID)).astype(np.float32)
    w_down = (rng.standard_normal((E, FFN, HID)) / np.sqrt(FFN)).astype(np.float32)
    ids, tw = _routing(rng, world * m_loc)
    want = _shard(
        lambda *a: _tp_moe_forward_impl(*a, "tp", jax.nn.gelu, JaxGGConfig(BM, 64, 64), None,
                                        True)[0],
        world,
        (P("tp", None), P(None, None, "tp"), P(None, "tp", None), P("tp", None), P("tp", None)),
        P("tp", None),
    )(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down), jnp.asarray(ids),
      jnp.asarray(tw))
    f_loc = FFN // world
    args = lambda r: (  # noqa: E731
        _t(x[r * m_loc:(r + 1) * m_loc]), _t(w_up[:, :, r * f_loc:(r + 1) * f_loc]),
        _t(w_down[:, r * f_loc:(r + 1) * f_loc]), _t(ids[r * m_loc:(r + 1) * m_loc]),
        _t(tw[r * m_loc:(r + 1) * m_loc]))
    cfg = tgg.GroupGemmConfig(BM, 16, 16)
    if world == 1:
        got = tmlp.tp_moe_mlp(*args(0), gg_config=cfg)
    else:
        ctx = initialize_distributed(world, device="cpu")
        got = torch.cat(ctx.run(lambda: tmlp.tp_moe_mlp(*args(ctx.rank), ctx=ctx,
                                                        gg_config=cfg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLP_TOL, atol=MLP_TOL)
