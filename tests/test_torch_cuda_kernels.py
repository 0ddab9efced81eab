"""The PyTorch port's CUDA kernels against their plain PyTorch versions on
the card (GEMM K1, flash decode K2, paged flash decode K3, grouped GEMM K8,
its weight gradient K11, and at world 2 and 4 with every rank on the one
card: barrier K4, full-mesh allgather K5, AG-GEMM K6, GEMM-RS K7,
AG-GroupGEMM K9, MoE-Reduce-RS K10, reduce-scatter K12, plus stuck waits
that must raise with their records), and a world-4 MoE train step that
must finish (each rank's backward meets its peers on the host).
Every test here carries the ``cuda`` marker and skips without a card. The
file imports neither JAX nor the JAX package, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import os

# the rank runtime gives each rank two streams with hardware queues of
# their own; the count is read when the process first touches the card
os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from triton_dist_tpu_torch import config  # noqa: E402
from triton_dist_tpu_torch.ops import allgather as tag  # noqa: E402
from triton_dist_tpu_torch.ops import allgather_gemm as tagg  # noqa: E402
from triton_dist_tpu_torch.ops import allgather_group_gemm as taggg  # noqa: E402
from triton_dist_tpu_torch.ops import common as tcommon  # noqa: E402
from triton_dist_tpu_torch.ops import flash_decode as tfd  # noqa: E402
from triton_dist_tpu_torch.ops import gemm as tgemm  # noqa: E402
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs  # noqa: E402
from triton_dist_tpu_torch.ops import group_gemm as tgg  # noqa: E402
from triton_dist_tpu_torch.ops import moe_reduce_rs as tmrs  # noqa: E402
from triton_dist_tpu_torch.ops import moe_utils as tmu  # noqa: E402
from triton_dist_tpu_torch.ops import reduce_scatter as trs  # noqa: E402
from triton_dist_tpu_torch.models import tp_transformer as ttm  # noqa: E402
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed  # noqa: E402
from triton_dist_tpu_torch.resilience.records import DistTimeoutError  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (33, 9, 17), (100, 40, 72), (257, 100, 130),
                                   (512, 4096, 1024)])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n):
    rng = np.random.default_rng(3)
    ta = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    tb = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)).to(cuda, dtype)
    before = tgemm.matmul.launches
    got = tgemm.matmul(ta, tb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tgemm.matmul.launches == before + 1
    want = tgemm._matmul_plain(ta, tb, torch.float32)
    # both f32 sums of the same products, in another order
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-4, err


CASES = {
    # name: (b, hq, h_kv, s, d, lens, soft_cap)
    "g4_ragged": (3, 8, 2, 32, 16, [0, 13, 32], 0.0),
    "g1_softcap": (2, 2, 2, 32, 16, [32, 5], 3.0),
    "d24_g4": (2, 4, 1, 32, 24, [17, 0], 0.0),
    "g4_d128_long": (2, 8, 2, 640, 128, [640, 333], 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_decode_kernels_match_plain(cuda, dtype, name):
    b, hq, h_kv, s, d, lens, cap = CASES[name]
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, hq, d), (b, h_kv, s, d), (b, h_kv, s, d)))
    page = 8
    pps = s // page
    table = rng.permutation(b * pps).reshape(b, pps).astype(np.int32)
    kp = np.zeros((b * pps, h_kv, page, d), np.float32)
    vp = np.zeros_like(kp)
    for bi in range(b):
        for ci in range(pps):
            kp[table[bi, ci]] = k[bi, :, ci * page:(ci + 1) * page]
            vp[table[bi, ci]] = v[bi, :, ci * page:(ci + 1) * page]
    t = lambda x: torch.from_numpy(x).to(cuda, dtype)  # noqa: E731
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    config = tfd.FlashDecodeConfig(soft_cap=cap)
    got = tfd.flash_decode(t(q), t(k), t(v), tl, config=config, return_lse=True)
    want = tfd._xla_decode(t(q), t(k), t(v), tl, return_lse=True, soft_cap=cap)
    pgot = tfd.paged_flash_decode(t(q), t(kp), t(vp), tl, torch.from_numpy(table).to(cuda),
                                  soft_cap=cap, return_lse=True)
    torch.cuda.synchronize()
    # same inputs on both sides, f32 arithmetic; only the order differs
    for o, lse in (got, pgot):
        torch.testing.assert_close(o, want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, want[1], rtol=1e-4, atol=1e-4)


def _moe_routing(gen, tokens, n_exp, topk, device):
    """Distinct top-k experts per token, skewed towards the low ids."""
    scores = torch.rand((tokens, n_exp), generator=gen, device=device)
    scores += torch.linspace(0.5, 0.0, n_exp, device=device)
    ids = scores.argsort(dim=1, descending=True)[:, :topk].to(torch.int32)
    w = torch.rand((tokens, topk), generator=gen, device=device) + 0.1
    return ids, w / w.sum(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("act", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("tokens,k,n", [(100, 256, 300), (7, 72, 40)])
def test_group_gemm_kernel_matches_plain(cuda, dtype, out_dtype, act, tokens, k, n):
    n_exp, topk, bm = 4, 2, 128
    g = torch.Generator(device="cuda").manual_seed(tokens)
    ids, _ = _moe_routing(g, tokens, n_exp, topk, cuda)
    al = tmu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
    a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g, device=cuda).to(dtype)
    b = (torch.randn((n_exp, k, n), generator=g, device=cuda) / k**0.5).to(dtype)
    act_fn = tgg.gelu if act else None
    before = tgg.group_gemm.launches
    got = tgg.group_gemm(a, b, al.expert_ids, out_dtype=out_dtype, act_fn=act_fn)
    torch.cuda.synchronize()
    assert tgg.group_gemm.launches == before + 1
    want = tgg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act_fn)
    # bf16 inputs: one bf16 ulp of the output scale (the GELU may round an
    # A element the other way too); f32: the sums differ only in order
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want.float())


# ---- world > 1: every rank on the one card, each on its own stream ----


def _tol(dtype, ref):
    """bf16 output: one bf16 ulp of the output scale (both round an f32 sum
    once, in another order); f32: the sums differ only in order."""
    scale = ref.abs().max().item()
    return (2.0**-7 if dtype == torch.bfloat16 else 1e-4) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_barrier_kernel_under_skew(cuda, world):
    ctx = initialize_distributed(world)
    before = tcommon.barrier_all_op.launches

    def body():
        for i in range(200):
            # rank-dependent device skew before every barrier
            tcommon.sleep_on_stream(((ctx.rank + i) % world) * 2000)
            tcommon.barrier_all_op(ctx)

    ctx.run(body)  # raises DistTimeoutError if any wait expired
    assert tcommon.barrier_all_op.launches == before + 200 * world


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_kernel_is_exact(cuda, world):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world)
    for rows, dtype in ((516, torch.float32), (7, torch.bfloat16), (3, torch.float32)):
        shards = [torch.randn((rows, 128), generator=g, device=cuda).to(dtype)
                  for _ in range(world)]
        outs = ctx.run(lambda: [tag.all_gather(shards[ctx.rank] * (i + 1), ctx=ctx)
                                for i in range(3)])
        for per_rank in outs:
            for i, got in enumerate(per_rank):
                assert torch.equal(got, torch.cat(shards) * (i + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ag_gemm_kernel_matches_plain(cuda, world, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(7)
    # two shapes back to back: the workspace grows, epochs rise, and the
    # second call reuses what the first left
    for m_loc, k, n_loc in ((64, 256, 300), (100, 512, 96)):
        a = [torch.randn((m_loc, k), generator=g, device=cuda).to(dtype) for _ in range(world)]
        b = (torch.randn((k, n_loc), generator=g, device=cuda) / k**0.5).to(dtype)
        want = tgemm._matmul_plain(torch.cat(a), b, dtype)
        outs = ctx.run(lambda: tagg.ag_gemm(a[ctx.rank], b, ctx=ctx, gather_output=True))
        for out, ag in outs:
            assert torch.equal(ag, torch.cat(a))
            assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_rs_kernel_matches_plain(cuda, world, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(8)
    for m_loc, k_loc, n in ((64, 256, 300), (40, 128, 520)):
        a = [torch.randn((world * m_loc, k_loc), generator=g, device=cuda).to(dtype)
             for _ in range(world)]
        b = [(torch.randn((k_loc, n), generator=g, device=cuda) / k_loc**0.5).to(dtype)
             for _ in range(world)]
        full = sum(a[r].float() @ b[r].float() for r in range(world))
        outs = ctx.run(lambda: tgrs.gemm_rs(a[ctx.rank], b[ctx.rank], ctx=ctx))
        for r, out in enumerate(outs):
            want = full[r * m_loc:(r + 1) * m_loc]
            # bf16: each partial rounds to bf16 before the epilogue adds it
            tol = _tol(dtype, want) * (2 if dtype == torch.bfloat16 else 1)
            assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_stuck_wait_raises_with_its_record(cuda):
    """Rank 1's stream is held for 2 s of device time before its barrier
    arrival: rank 0's bounded wait (0.2 s) expires and the run raises with a
    record naming rank 0, the barrier family and site 1 (the arrival of
    rank 1) — it does not hang."""
    ctx = initialize_distributed(2)
    ctx.run(lambda: tcommon.barrier_all_op(ctx))  # the flags exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        tcommon.barrier_all_op(ctx)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (0, "barrier", 1, "barrier_all")
    assert rec["expected"] == 2 and rec["observed"] == 1
    with pytest.raises(RuntimeError, match="failed earlier"):
        ctx.run(body)


def _ranked_inputs(gen, world, m_loc, n_exp, topk, bm, device):
    ids, w = _moe_routing(gen, world * m_loc, n_exp, topk, device)
    ral = tmu.moe_align_ranked(ids.reshape(world, -1), n_exp, bm, m_loc)
    return ral, w


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ag_group_gemm_kernel_matches_plain(cuda, world, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world)
    n_exp, topk, bm = 4, 2, 128
    # two shapes back to back: the workspace grows, epochs rise
    for m_loc, k, n_loc in ((40, 256, 300), (100, 128, 96)):
        ral, _ = _ranked_inputs(g, world, m_loc, n_exp, topk, bm, cuda)
        x = [torch.randn((m_loc, k), generator=g, device=cuda).to(dtype) for _ in range(world)]
        b = (torch.randn((n_exp, k, n_loc), generator=g, device=cuda) / k**0.5).to(dtype)
        # every rank's expert-sorted slab, rank-major
        slabs = torch.cat([x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(world)])
        want = tgg._group_gemm_plain(slabs, b, ral.expert_ids.reshape(-1), bm, dtype, None)
        before = taggg.ag_group_gemm_overlap.launches
        outs = ctx.run(lambda: taggg.ag_group_gemm_overlap(x[ctx.rank], b, ral, ctx=ctx,
                                                           gather_output=True))
        assert taggg.ag_group_gemm_overlap.launches == before + world
        for out, ag in outs:
            assert torch.equal(ag, slabs)
            assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_reduce_rs_kernel_matches_plain(cuda, world, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(10 + world)
    n_exp, topk, bm = 4, 2, 128
    for m_loc, f_loc, h in ((40, 256, 300), (100, 128, 520)):
        ral, w = _ranked_inputs(g, world, m_loc, n_exp, topk, bm, cuda)
        dst, w_rows = tmu.ranked_scatter_meta(ral, w)
        inv = tmu.ranked_combine_rows(ral, m_loc, topk)
        rows = world * ral.t_pad_loc
        hs = [torch.randn((rows, f_loc), generator=g, device=cuda).to(dtype)
              for _ in range(world)]
        wd = [(torch.randn((n_exp, f_loc, h), generator=g, device=cuda) / f_loc**0.5).to(dtype)
              for _ in range(world)]

        def body():
            r = ctx.rank
            got = tmrs.moe_reduce_rs_overlap(hs[r], wd[r], ral.expert_ids, dst, w_rows,
                                             ctx=ctx, m_out=m_loc, combine_rows=inv)
            want = tmrs._moe_rs_overlap_xla(hs[r], wd[r], ral.expert_ids, dst, w_rows, ctx,
                                            m_loc, dtype)
            return got, want

        before = tmrs.moe_reduce_rs_overlap.launches
        outs = ctx.run(body)
        assert tmrs.moe_reduce_rs_overlap.launches == before + world
        for got, want in outs:
            # bf16: each peer's partial is rounded to bf16 before the sum
            tol = _tol(dtype, want.float()) * (2 if dtype == torch.bfloat16 else 1)
            assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_moe_reduce_rs_stuck_wait_raises_with_its_record(cuda):
    """Rank 1's stream is held for 2 s before its MoE-Reduce-RS: rank 0's
    entry-barrier wait (0.2 s) expires and the run raises with a record
    naming rank 0, the moe_rs family and site 1 — it does not hang."""
    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(3)
    ral, w = _ranked_inputs(g, 2, 16, 4, 2, 128, cuda)
    dst, w_rows = tmu.ranked_scatter_meta(ral, w)
    inv = tmu.ranked_combine_rows(ral, 16, 2)
    hs = torch.randn((2 * ral.t_pad_loc, 64), generator=g, device=cuda)
    wd = torch.randn((4, 64, 32), generator=g, device=cuda)

    def call():
        return tmrs.moe_reduce_rs_overlap(hs, wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                          m_out=16, combine_rows=inv)

    ctx.run(call)  # the buffers and flags exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return call()

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (0, "moe_rs", 1, "barrier_all")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["sorted", "rank_major", "empty_expert"])
def test_group_gemm_dw_kernel_matches_plain(cuda, dtype, layout):
    """K11: expert-sorted blocks (world 1), the rank-major layout of the
    overlapped pair (world > 1, not sorted), and ids with an expert that
    owns no block (exactly zero) and one beyond the bank (clamped); tile
    edges on both output dims, with and without the 16-byte loads."""
    n_exp, bm = 4, 128
    g = torch.Generator(device="cuda").manual_seed(len(layout))
    if layout == "sorted":
        ids, _ = _moe_routing(g, 300, n_exp, 2, cuda)
        expert_ids = tmu.moe_align_block_size(ids.reshape(-1), n_exp, bm).expert_ids
    elif layout == "rank_major":
        ids, _ = _moe_routing(g, 2 * 150, n_exp, 2, cuda)
        expert_ids = tmu.moe_align_ranked(ids.reshape(2, -1), n_exp, bm, 150).expert_ids
        expert_ids = expert_ids.reshape(-1)
    else:
        expert_ids = torch.tensor([0, 3, 1, 0, 9, 3], dtype=torch.int32, device=cuda)
    t_pad = bm * expert_ids.numel()
    for k, n in ((200, 264), (36, 40)):
        a = torch.randn((t_pad, k), generator=g, device=cuda).to(dtype)
        gr = torch.randn((t_pad, n), generator=g, device=cuda).to(dtype)
        before = tgg.group_gemm_dw.launches
        got = tgg.group_gemm_dw(a, gr, expert_ids, n_exp, config=tgg.GroupGemmConfig(bm))
        torch.cuda.synchronize()
        assert tgg.group_gemm_dw.launches == before + 1
        want = tgg._group_gemm_dw_plain(a, gr, expert_ids.clamp(0, n_exp - 1), n_exp, bm)
        # the same exact products, f32 sums in another order
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        if layout == "empty_expert":
            assert torch.all(got[2] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_reduce_scatter_kernel_matches_plain(cuda, world, dtype):
    """K12 against the plain psum_scatter: two shapes back to back (the
    landing buffer grows, epochs rise); the sums differ only in order (own
    chunk first, then the landing slots, against rank order)."""
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(30 + world)
    for m_loc, n in ((64, 300), (16, 4096)):
        x = [torch.randn((world * m_loc, n), generator=g, device=cuda).to(dtype)
             for _ in range(world)]
        before = trs.reduce_scatter.launches
        outs = ctx.run(lambda: (trs.reduce_scatter(x[ctx.rank], ctx=ctx),
                                trs._reduce_scatter_xla(x[ctx.rank], ctx)))
        assert trs.reduce_scatter.launches == before + world
        for got, want in outs:
            scale = want.float().abs().max().item()
            tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-6) * scale
            assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_reduce_scatter_stuck_wait_raises_with_its_record(cuda):
    """Rank 1's stream is held for 2 s before its reduce-scatter: rank 0's
    entry-barrier wait (0.2 s) expires and the run raises with a record
    naming rank 0, the reduce_scatter family and site 1."""
    ctx = initialize_distributed(2)
    x = torch.randn((32, 64), device=cuda)
    ctx.run(lambda: trs.reduce_scatter(x, ctx=ctx))  # the buffers and flags exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return trs.reduce_scatter(x, ctx=ctx)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (
        0, "reduce_scatter", 1, "barrier_all")


@pytest.mark.cuda
def test_world4_moe_train_step_finishes(cuda):
    """One f32 MoE train step at world 4 on the card (K6, K7, K9, K10
    forward; K6, K7, K8, K11, K12 backward, every rank's backward on its
    own thread) finishes under a 30 s wait timeout and matches the world-1
    step on the card."""
    cfg = ttm.MoETransformerConfig(vocab=512, hidden=256, ffn=512, n_layers=1, n_q_heads=8,
                                   n_kv_heads=4, head_dim=32, batch=2, seq=64, n_experts=4,
                                   topk=2, gg_config=tgg.GroupGemmConfig(128))
    params = ttm.init_moe_params(cfg, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (128,), generator=g, device=cuda)
    targets = torch.randint(0, cfg.vocab, (128,), generator=g, device=cuda)
    want, want_loss = ttm.train_step(ttm.TPMoETransformer(cfg), params, tokens, targets, lr=0.1)
    ctx = initialize_distributed(4)
    shards = ttm.shard_params(params, 4, ctx.devices)
    before = (tgg.group_gemm_dw.launches, trs.reduce_scatter.launches)

    def body():
        r = ctx.rank
        return ttm.train_step(ttm.TPMoETransformer(cfg, ctx=ctx), shards[r],
                              tokens[r * 32:(r + 1) * 32], targets, lr=0.1)

    with config.wait_timeout(30):
        outs = ctx.run(body, grad=True)
    assert tgg.group_gemm_dw.launches >= before[0] + 8
    assert trs.reduce_scatter.launches == before[1] + 4
    for _, loss in outs:
        assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    got = ttm._tree_map(lambda first, dim, *rest: first if dim is None
                        else torch.cat([first, *rest], dim),
                        outs[0][0], ttm.specs_for(cfg), *[o[0] for o in outs[1:]])
    ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5), got, want)
