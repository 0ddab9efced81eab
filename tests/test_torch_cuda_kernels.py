"""The PyTorch port's CUDA kernels against their plain PyTorch versions on
the card (GEMM K1 — its wgmma + TMA engine at every tile and the engine
routing by shape —, flash decode K2 and paged flash decode K3 — their
one-launch kernel bit-equal across calls and under a CUDA-graph replay —,
grouped GEMM K8, its weight gradient K11, the multi-position verify K13 —
its wgmma + TMA engine — and its paged twin K14 — over shared pages, and
chunk calls bit-equal to the whole-range call — and at world 2 and 4 with every rank on the one
card: barrier K4, full-mesh allgather K5, AG-GEMM K6, GEMM-RS K7,
AG-GroupGEMM K9, MoE-Reduce-RS K10, reduce-scatter K12, the scaled
int8 / fp8 formats of the grouped GEMM K24, of K9 (K25) and of K10 (K26),
their ragged-row forms K29-K31 (bit-equal to the padded kernels on the
live rows, dead rows zero, a rank whose blocks are all dead, a stuck
wait, the EP layer), the ragged weight gradient K34 (bit-equal to K11 on
zeroed dead rows, junk in them changes nothing), ring attention K35 at
world 1, 2 and 4 (contiguous and zigzag, causal or not, a stuck wait),
and on a ring
context the ring AG-GEMM K15, the ring GEMM-RS K16/K17, the ring
reduce-scatter K18 and its spans K23 (bit-equal to K18), and the ring
allgathers K19-K22 (bit-exact), the padded-slab all-to-all K27 and its
chunked form K28 (bit-exact, and the expert-parallel MoE MLP over them
against its CPU run), plus stuck waits that must raise with
their records and a race-shaking pass (``config.comm_delay``) whose
outputs must be bit-identical), and world-4 MoE train steps, full mesh and
ring, that must finish (each rank's backward meets its peers on the host);
and over (dp, tp) pairs of a 2-D runtime at 2 x 2, 2 x 4 and 4 x 2 the
hierarchical ring allgather K36 (bit-exact, equal to K19 over the
flattened ring, the swapped pair and three axes too) and the 2-D AG-GEMM
K37 (bit-equal to K15, one ulp of its plain version), and their stuck
waits (every other rank names the late rank's entry-barrier site); and the
one-byte KV caches: the quantized decode K38, its paged twin K39 and the
quantized verify K40 in int8 and fp8 against their plain versions, the
verify's chunk calls bit-equal to the whole-range call, the card's KV
quantizers equal to the CPU's, and the SP entries at world 2 and 4; and
the KV handoff stream: K41 (native wire) and K42 (int8, fp8) at world 2
and 4 with 1, 2 and 4 chunks bit-exact against the plain exchange, the
card's wire quantizers equal to the CPU's, and a stuck wait at the
mirror's first payload chunk. Every test here carries the ``cuda`` marker and skips without a card. The
file imports neither JAX nor the JAX package, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import dataclasses
import os

# the rank runtime gives each rank two streams with hardware queues of
# their own; the count is read when the process first touches the card
os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from triton_dist_tpu_torch import config  # noqa: E402
from triton_dist_tpu_torch.layers import ep_moe_mlp as tepmlp  # noqa: E402
from triton_dist_tpu_torch.ops import all_to_all as ta2a  # noqa: E402
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
from triton_dist_tpu_torch.ops import ring_attention as tra  # noqa: E402
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


# K1's wgmma + TMA engine: the served shape families at reduced sizes
# (M, K, N) and the edges of its tiles
WGMMA_SHAPES = {
    "wqkv": (256, 512, 768), "wo": (256, 512, 512), "gate_up": (256, 512, 3584),
    "down": (256, 1792, 512), "lm_head": (256, 512, 16032), "decode_m8": (8, 512, 768),
    "m1_n8": (1, 64, 8), "m127_n136": (127, 200, 136), "m129_n136": (129, 72, 136),
    "m2049": (2049, 1000, 520),
}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_adds", [0, 1, tgemm.MAX_ADDS])
@pytest.mark.parametrize("name", sorted(WGMMA_SHAPES))
def test_wgmma_gemm_matches_plain(cuda, name, n_adds, out_dtype):
    """K1's wgmma engine (every tile config: 64x64 at M <= 64, 128x128 and
    128x256 above) against the plain version with 0, 1 and MAX_ADDS epilogue
    adds: bf16 out within 2^-7 of the output scale (both round an f32 sum
    once), f32 out within 1e-4 of it (the same products in another order)."""
    m, k, n = WGMMA_SHAPES[name]
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5).bfloat16()
    adds = [torch.randn((m, n), generator=gen, device=cuda).to(out_dtype) for _ in range(n_adds)]
    before = tgemm.matmul.wgmma_launches
    got = tgemm.matmul(a, b, out_dtype=out_dtype, adds=adds).float()
    torch.cuda.synchronize()
    assert tgemm.matmul.wgmma_launches == before + 1
    want = tgemm._matmul_plain(a, b, out_dtype, adds).float()
    tol = (2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-4) * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    for config in (0, 1, 2):  # every tile on the same product
        other = tgemm.matmul(a, b, out_dtype=out_dtype, adds=adds, _config=config).float()
        assert (other - want).abs().max().item() <= tol, config


@pytest.mark.cuda
def test_gemm_engines_routed_by_shape(cuda):
    """The stated rule on the card: aligned bf16 runs the wgmma engine, a K or
    N off a multiple of 8 (or a misaligned view) the mma.sync engine, f32 the
    f32 engine; each counted on its own counter, each right."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    cases = [((64, 72, 40), torch.bfloat16, "wgmma_launches"),
             ((64, 71, 40), torch.bfloat16, "mma_launches"),
             ((64, 72, 41), torch.bfloat16, "mma_launches"),
             ((64, 72, 40), torch.float32, None)]
    for (m, k, n), dtype, counter in cases:
        a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
        counts = {c: getattr(tgemm.matmul, c) for c in ("wgmma_launches", "mma_launches")}
        got = tgemm.matmul(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for c, v in counts.items():
            assert getattr(tgemm.matmul, c) == v + (c == counter), (m, k, n, dtype, c)
        want = tgemm._matmul_plain(a, b, torch.float32)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4
    # a view one element into its storage: A's base is not 16-byte aligned
    a = torch.randn((64 * 72 + 1,), generator=gen, device=cuda).bfloat16()[1:].view(64, 72)
    b = torch.randn((72, 40), generator=gen, device=cuda).bfloat16()
    before = tgemm.matmul.mma_launches
    tgemm.matmul(a, b)
    assert tgemm.matmul.mma_launches == before + 1


# K3's one-launch kernel: (b, hq, h_kv, d, page, pages a sequence, lens, soft cap)
ONEPASS_CASES = {
    "edges_g4_d128": (6, 32, 8, 128, 16, 64, [0, 1, 15, 16, 17, 1024], 0.0),
    "skew_g4_cap": (4, 16, 4, 128, 16, 256, [4096, 3, 1, 2], 30.0),
    "g1_d64": (3, 4, 4, 64, 16, 32, [512, 100, 7], 0.0),
    "g8_d128_cap": (2, 64, 8, 128, 16, 128, [2048, 1500], 5.0),
    "g8_d64_page8": (3, 16, 2, 64, 8, 40, [320, 0, 33], 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONEPASS_CASES))
def test_paged_onepass_decode_matches_plain(cuda, name):
    """K3's one-launch kernel on a bf16 pool with junk table entries past
    every length: within DECODE_TOL of the plain version (f32 scores and
    sums of the same bf16 inputs, another order), kv_len 0 gives out 0 and
    lse -inf, two calls and a CUDA-graph replay give the same bits (the
    spans merge in span order; each call zeroes its arrival counters in
    its stream, and a replay repeats that memset)."""
    b, hq, h_kv, d, page, pps, lens, cap = ONEPASS_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    n_pages = b * pps + 3
    q = torch.randn((b, hq, d), generator=gen, device=cuda).bfloat16()
    kp = torch.randn((n_pages, h_kv, page, d), generator=gen, device=cuda).bfloat16()
    vp = torch.randn((n_pages, h_kv, page, d), generator=gen, device=cuda).bfloat16()
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    table = torch.randperm(n_pages, generator=gen, device=cuda)[:b * pps].reshape(b, pps)
    used = torch.arange(pps, device=cuda)[None, :] < ((tl + page - 1) // page)[:, None]
    junk = torch.randint(0, n_pages, (b, pps), generator=gen, device=cuda)
    table = torch.where(used, table, junk).to(torch.int32).contiguous()
    run = lambda: tfd.paged_flash_decode(q, kp, vp, tl, table, soft_cap=cap,  # noqa: E731
                                         return_lse=True)
    before = tfd.paged_flash_decode.onepass_launches
    out, lse = run()
    again = run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert tfd.paged_flash_decode.onepass_launches == before + 3
    want_o, want_l = tfd._xla_paged_decode(q, kp, vp, tl, table, return_lse=True, soft_cap=cap)
    live = tl > 0
    assert (out - want_o).abs().max().item() <= 1e-3
    assert (lse[live] - want_l[live]).abs().max().item() <= 1e-3
    assert (out[~live] == 0).all() and torch.isneginf(lse[~live]).all()
    for o, l_ in (again, captured):
        assert torch.equal(o, out) and torch.equal(l_, lse)


# K2's one-launch kernel over a contiguous cache: (b, hq, h_kv, d, s, lens, soft cap)
CONTIGUOUS_ONEPASS_CASES = {
    "served_g4_d128": (8, 32, 8, 128, 1024, [0, 1, 17, 300, 513, 777, 1000, 1024], 0.0),
    "g1_d96_cap": (4, 8, 8, 96, 300, [300, 0, 100, 299], 30.0),
    "g8_d128_cap": (3, 64, 8, 128, 1000, [1000, 1, 640], 5.0),
    "g4_d96_long": (2, 16, 4, 96, 4096, [4096, 2500], 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTIGUOUS_ONEPASS_CASES))
def test_contiguous_onepass_decode_matches_plain(cuda, name):
    """K2's one-launch kernel over a bf16 contiguous cache (lengths 0 and
    s_max, caches off the 64-position tile): within DECODE_TOL of the plain
    version, kv_len 0 gives out 0 and lse -inf, the one-launch counter moves
    once a call, and two calls and a CUDA-graph replay give the same bits;
    the split engine (``_engine="split"``) stays within the same tolerance."""
    b, hq, h_kv, d, s, lens, cap = CONTIGUOUS_ONEPASS_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name) + s)
    q = torch.randn((b, hq, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, h_kv, s, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, h_kv, s, d), generator=gen, device=cuda).bfloat16()
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    config = tfd.FlashDecodeConfig(soft_cap=cap)
    run = lambda **kw: tfd.flash_decode(q, k, v, tl, config=config,  # noqa: E731
                                        return_lse=True, **kw)
    before = tfd.flash_decode.onepass_launches
    out, lse = run()
    again = run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    graph.replay()
    split = run(_engine="split")
    torch.cuda.synchronize()
    assert tfd.flash_decode.onepass_launches == before + 3
    want_o, want_l = tfd._xla_decode(q, k, v, tl, return_lse=True, soft_cap=cap)
    live = tl > 0
    for o, l_ in ((out, lse), split):
        assert (o - want_o).abs().max().item() <= 1e-3
        assert (l_[live] - want_l[live]).abs().max().item() <= 1e-3
        assert (o[~live] == 0).all() and torch.isneginf(l_[~live]).all()
    for o, l_ in (again, captured):
        assert torch.equal(o, out) and torch.equal(l_, lse)


VERIFY_CASES = {
    # name: (b, S, hq, h_kv, s, d, soft_cap, page)
    "s5_g4_d128": (2, 5, 8, 2, 200, 128, 0.0, 8),
    "s37_g4_cap": (2, 37, 8, 2, 144, 64, 5.0, 16),
    "s3_g1_d96": (3, 3, 2, 2, 96, 96, 0.0, 8),
    "s70_g8_d8": (1, 70, 8, 1, 64, 8, 0.0, 4),
    # the served widths of K13's wgmma engine: a prefill chunk, a speculative
    # verify (one consumer warpgroup), a one-position chunk
    "s256_g4_d128": (2, 256, 32, 8, 320, 128, 0.0, 16),
    "s8_g4_d64_cap": (3, 8, 32, 8, 256, 64, 30.0, 16),
    "s1_g4_d128": (4, 1, 32, 8, 192, 128, 0.0, 16),
}


def _verify_tol(ref: torch.Tensor, dtype) -> float:
    """bf16: one bf16 ulp of the output scale (the kernel rounds the
    probabilities to bf16 before P.V, as the TPU kernel does); f32: 1e-5 of
    it (the same f32 products in another order)."""
    scale = ref[torch.isfinite(ref)].abs().max().item()
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_kernels_match_plain(cuda, dtype, name):
    """K13/K14 against their plain versions: ragged per-row lengths with
    empty and full rows; the paged pool is shared — every sequence's first
    page is one physical page, as under the prefix cache. A bf16 cache runs
    K13's wgmma engine (its counter moves); the mma.sync engine
    (``_engine="mma"``, the first port's) over the contiguous cache gives
    K14's bits on the pool that holds it — the kernel both share, unchanged."""
    b, S, hq, h_kv, s, d, cap, page = VERIFY_CASES[name]
    assert s % page == 0
    rng = np.random.default_rng(9)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda, dtype)  # noqa: E731
    q = t(rng.standard_normal((b, S, hq, d)))
    k1 = rng.standard_normal((h_kv, s, d))
    v1 = rng.standard_normal((h_kv, s, d))
    kc = np.repeat(k1[None], b, 0) + 0.1 * rng.standard_normal((b, h_kv, s, d))
    vc = np.repeat(v1[None], b, 0) + 0.1 * rng.standard_normal((b, h_kv, s, d))
    kc[:, :, :page], vc[:, :, :page] = k1[:, :page], v1[:, :page]  # a shared first page
    lens = rng.integers(0, s + 1, (b, S)).astype(np.int32)
    lens[0, 0], lens[-1, -1] = 0, s
    tl = torch.from_numpy(lens).to(cuda)
    cfg = tfd.FlashDecodeConfig(soft_cap=cap)
    before = tfd.flash_verify.wgmma_launches
    got = tfd.flash_verify(q, t(kc), t(vc), tl, config=cfg, return_lse=True)
    assert tfd.flash_verify.wgmma_launches == before + (dtype == torch.bfloat16)
    mma = tfd.flash_verify(q, t(kc), t(vc), tl, config=cfg, return_lse=True, _engine="mma")
    want = tfd._xla_verify(q, t(kc), t(vc), tl, return_lse=True, soft_cap=cap)
    # pool: page 0 shared by every sequence, the rest private and shuffled
    pps = s // page
    n_pages = 1 + b * (pps - 1)
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((b, pps), np.int32)
    table[:, 1:] = perm.reshape(b, pps - 1)
    kp, vp = np.zeros((n_pages, h_kv, page, d)), np.zeros((n_pages, h_kv, page, d))
    for bi in range(b):
        for ci in range(pps):
            kp[table[bi, ci]] = kc[bi, :, ci * page:(ci + 1) * page]
            vp[table[bi, ci]] = vc[bi, :, ci * page:(ci + 1) * page]
    pgot = tfd.paged_flash_verify(q, t(kp), t(vp), tl, torch.from_numpy(table).to(cuda),
                                  soft_cap=cap, return_lse=True)
    torch.cuda.synchronize()
    empty = torch.from_numpy(lens == 0).to(cuda)
    assert torch.equal(mma[0], pgot[0]) and torch.equal(mma[1], pgot[1])
    for o, lse in (got, pgot):
        assert (o - want[0]).abs().max().item() <= _verify_tol(want[0], dtype)
        live = ~empty[..., None].expand_as(lse)
        assert (lse[live] - want[1][live]).abs().max().item() <= _verify_tol(want[1], dtype)
        assert (o[empty] == 0).all() and torch.isneginf(lse[empty]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_kernels_compose_bit_for_bit(cuda, dtype, paged):
    """A whole-range ranged-prefill call and the calls over its chunks give
    every row the same (out, lse) bits: a row's result depends on neither S
    nor its neighbours. A bf16 contiguous cache runs K13's wgmma engine (two
    consumer warpgroups on the whole range, one on the 1-position chunk)."""
    b, S, hq, h_kv, s, d, page = 3, 150, 32, 8, 512, 128, 16
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((b, S, hq, d), generator=gen, device=cuda).to(dtype)
    if paged:
        pps = s // page
        k = torch.randn((b * pps, h_kv, page, d), generator=gen, device=cuda).to(dtype)
        v = torch.randn((b * pps, h_kv, page, d), generator=gen, device=cuda).to(dtype)
        table = torch.randperm(b * pps, generator=gen, device=cuda).reshape(b, pps)
        table = table.to(torch.int32)
        run = lambda qq, lens: tfd.paged_flash_verify(  # noqa: E731
            qq, k, v, lens, table, return_lse=True)
    else:
        k = torch.randn((b, h_kv, s, d), generator=gen, device=cuda).to(dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=cuda).to(dtype)
        run = lambda qq, lens: tfd.flash_verify(qq, k, v, lens, return_lse=True)  # noqa: E731
    pos0 = torch.tensor([0, 77, s], device=cuda)  # the last row parked past the cache
    before = tfd.flash_verify.wgmma_launches
    whole = run(q, tfd._ranged_local_lens(pos0, S, 0, s).to(cuda))
    wgmma = not paged and dtype == torch.bfloat16
    assert tfd.flash_verify.wgmma_launches == before + wgmma
    for lo, hi in ((0, 1), (1, 64), (64, 150)):
        part = run(q[:, lo:hi].contiguous(), tfd._ranged_local_lens(pos0 + lo, hi - lo, 0, s))
        assert torch.equal(part[0], whole[0][:, lo:hi]), (lo, hi)
        assert torch.equal(part[1], whole[1][:, lo:hi]), (lo, hi)
    assert tfd.flash_verify.wgmma_launches == before + 4 * wgmma


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


# ---- the scaled weight formats: K24 (K8), K25 (K9), K26 (K10) over int8 /
# fp8 e4m3 banks with per-(expert, out-column) scales ----

QUANTIZERS = {"int8": tgg.quantize_expert_weights, "fp8": tgg.quantize_expert_weights_fp8}


def _quant_bank(gen, shape, fmt, device):
    """A float bank quantized to `fmt`: ``(pool, scale)``, with the scales
    spread over two decades so a misplaced scale column shows."""
    b = torch.randn(shape, generator=gen, device=device) / shape[1]**0.5
    b = b * torch.logspace(-1, 1, shape[2], device=device)
    return QUANTIZERS[fmt](b)


def _scaled_tol(dtype, ref):
    """bf16 activations: one bf16 ulp of the output scale (the weights are
    upcast exactly; the f32 sums differ in order, both round once); f32:
    1e-5 of the scale (FMA sums in another order)."""
    return (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("act", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("tokens,k,n", [(100, 256, 304), (7, 72, 48), (60, 100, 272)])
def test_scaled_group_gemm_kernel_matches_plain(cuda, fmt, dtype, out_dtype, act, tokens, k, n):
    n_exp, topk, bm = 4, 2, 128
    g = torch.Generator(device="cuda").manual_seed(tokens + k)
    ids, _ = _moe_routing(g, tokens, n_exp, topk, cuda)
    al = tmu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
    eids = al.expert_ids.clone()
    eids[-1] = n_exp + 3  # a sentinel block reads the clamped expert's bank and scale
    a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g, device=cuda).to(dtype)
    b, scale = _quant_bank(g, (n_exp, k, n), fmt, cuda)
    act_fn = tgg.gelu if act else None
    before = (tgg.group_gemm.launches, tgg.group_gemm.scaled_launches)
    got = tgg.group_gemm(a, b, eids, scale=scale, out_dtype=out_dtype, act_fn=act_fn)
    torch.cuda.synchronize()
    assert (tgg.group_gemm.launches, tgg.group_gemm.scaled_launches) == (before[0],
                                                                        before[1] + 1)
    want = tgg._group_gemm_plain(a, b, eids, bm, out_dtype, act_fn, scale)
    assert (got.float() - want.float()).abs().max().item() <= _scaled_tol(dtype, want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantizers_on_the_card_equal_the_cpu(cuda, fmt):
    """The card's pools and scales equal the CPU's bit for bit (so a bank
    quantized on the card is the JAX package's): every division in the
    quantizer is exact on both."""
    g = torch.Generator().manual_seed(5)
    b = torch.randn((4, 512, 384), generator=g) * torch.logspace(-4, 3, 384)
    cq, cs = QUANTIZERS[fmt](b)
    gq, gs = QUANTIZERS[fmt](b.to(cuda))
    assert torch.equal(gs.cpu(), cs)
    assert torch.equal(gq.cpu().view(torch.uint8), cq.view(torch.uint8))


@pytest.mark.cuda
def test_scaled_group_gemm_refuses_unaligned_rows(cuda):
    """A one-byte bank's rows ride 16-byte copies: N = 40 is refused, not
    computed some other way."""
    a = torch.zeros((128, 64), device=cuda, dtype=torch.bfloat16)
    b, scale = tgg.quantize_expert_weights(torch.randn((2, 64, 40), device=cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        tgg.group_gemm(a, b, torch.zeros(1, dtype=torch.int32, device=cuda), scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scaled_ag_group_gemm_kernel_matches_plain(cuda, world, fmt, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world + 40)
    n_exp, topk, bm = 4, 2, 128
    for m_loc, k, n_loc in ((40, 256, 304), (100, 128, 96)):
        ral, _ = _ranked_inputs(g, world, m_loc, n_exp, topk, bm, cuda)
        x = [torch.randn((m_loc, k), generator=g, device=cuda).to(dtype) for _ in range(world)]
        b, scale = _quant_bank(g, (n_exp, k, n_loc), fmt, cuda)
        slabs = torch.cat([x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(world)])
        want = tgg._group_gemm_plain(slabs, b, ral.expert_ids.reshape(-1), bm, dtype, None,
                                     scale)
        before = (taggg.ag_group_gemm_overlap.launches,
                  taggg.ag_group_gemm_overlap.scaled_launches)
        outs = ctx.run(lambda: taggg.ag_group_gemm_overlap(x[ctx.rank], b, ral, ctx=ctx,
                                                           scale=scale))
        assert (taggg.ag_group_gemm_overlap.launches,
                taggg.ag_group_gemm_overlap.scaled_launches) == (before[0], before[1] + world)
        for out in outs:
            assert (out.float() - want.float()).abs().max().item() <= _scaled_tol(
                dtype, want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scaled_moe_reduce_rs_kernel_matches_plain(cuda, world, fmt, dtype):
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(50 + world)
    n_exp, topk, bm = 4, 2, 128
    for m_loc, f_loc, h in ((40, 256, 304), (100, 128, 528)):
        ral, w = _ranked_inputs(g, world, m_loc, n_exp, topk, bm, cuda)
        dst, w_rows = tmu.ranked_scatter_meta(ral, w)
        inv = tmu.ranked_combine_rows(ral, m_loc, topk)
        rows = world * ral.t_pad_loc
        hs = [torch.randn((rows, f_loc), generator=g, device=cuda).to(dtype)
              for _ in range(world)]
        banks = [_quant_bank(g, (n_exp, f_loc, h), fmt, cuda) for _ in range(world)]

        def body():
            r = ctx.rank
            wd, sc = banks[r]
            got = tmrs.moe_reduce_rs_overlap(hs[r], wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                             m_out=m_loc, combine_rows=inv, scale=sc)
            want = tmrs._moe_rs_overlap_xla(hs[r], wd, ral.expert_ids, dst, w_rows, ctx,
                                            m_loc, dtype, sc)
            return got, want

        before = (tmrs.moe_reduce_rs_overlap.launches,
                  tmrs.moe_reduce_rs_overlap.scaled_launches)
        outs = ctx.run(body)
        assert (tmrs.moe_reduce_rs_overlap.launches,
                tmrs.moe_reduce_rs_overlap.scaled_launches) == (before[0], before[1] + world)
        for got, want in outs:
            # bf16: each peer's partial is rounded to bf16 before the sum
            tol = _scaled_tol(dtype, want.float()) * (2 if dtype == torch.bfloat16 else 1)
            assert (got.float() - want.float()).abs().max().item() <= tol


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
    want, want_loss = ttm.train_step(ttm.TPMoETransformer(cfg), params, tokens, targets,
                                     lr=0.1, dp_axis=None)
    ctx = initialize_distributed(4)
    shards = ttm.shard_params(params, 4, ctx.devices)
    before = (tgg.group_gemm_dw.launches, trs.reduce_scatter.launches)

    def body():
        r = ctx.rank
        return ttm.train_step(ttm.TPMoETransformer(cfg, ctx=ctx), shards[r],
                              tokens[r * 32:(r + 1) * 32], targets, lr=0.1, dp_axis=None)

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


def _ring_ctx(world):
    ctx = initialize_distributed(world)
    ctx.full_mesh = False
    return ctx


def _ring_tol(dtype, ref):
    """Against the ring's own plain version (the same hop order and
    roundings): one bf16 ulp of the output scale; f32 1e-5 of it."""
    return (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_ag_gemm_kernel_matches_plain(cuda, world, dtype, chunks):
    """K15 on a ring context (spans of ``chunks_per_shard``): two shapes
    back to back (the workspace grows, epochs rise), against the ring's
    plain version; the gathered A bit-exact."""
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(60 + chunks)
    for m_loc, k, n_loc in ((64, 256, 300), (100, 512, 96), (2, 128, 64)):
        cfg = tagg.AGGemmConfig(chunks_per_shard=chunks)
        spans = tcommon.ring_spans(m_loc, chunks, cfg.block_m)
        a = [torch.randn((m_loc, k), generator=g, device=cuda).to(dtype) for _ in range(world)]
        b = (torch.randn((k, n_loc), generator=g, device=cuda) / k**0.5).to(dtype)
        before = tagg._ag_gemm_ring.launches
        outs = ctx.run(lambda: (
            tagg.ag_gemm(a[ctx.rank], b, ctx=ctx, config=cfg, gather_output=True),
            tagg._ag_gemm_ring_plain(a[ctx.rank], b, ctx, False, dtype, spans)))
        assert tagg._ag_gemm_ring.launches == before + world
        for (out, ag), want in outs:
            assert torch.equal(ag, torch.cat(a))
            assert (out.float() - want.float()).abs().max().item() <= _ring_tol(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_gemm_rs_kernel_matches_plain(cuda, world, dtype, chunks):
    """K16 (one span) and K17 (spans) on a ring context against the
    ring's plain version; K17 launched with one span is K16 bit for bit."""
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(70 + chunks)
    for m_loc, k_loc, n in ((64, 256, 300), (40, 128, 520), (2, 64, 128)):
        cfg = tgrs.GemmRSConfig(chunks_per_shard=chunks)
        spans = tcommon.ring_spans(m_loc, chunks, cfg.block_m)
        a = [torch.randn((world * m_loc, k_loc), generator=g, device=cuda).to(dtype)
             for _ in range(world)]
        b = [(torch.randn((k_loc, n), generator=g, device=cuda) / k_loc**0.5).to(dtype)
             for _ in range(world)]
        counter = tgrs._gemm_rs_ring if len(spans) == 1 else tgrs._gemm_rs_ring_chunked
        before = counter.launches
        outs = ctx.run(lambda: (
            tgrs.gemm_rs(a[ctx.rank], b[ctx.rank], ctx=ctx, config=cfg),
            tgrs._gemm_rs_ring_plain(a[ctx.rank], b[ctx.rank], ctx, dtype, spans)))
        assert counter.launches == before + world
        for got, want in outs:
            assert (got.float() - want.float()).abs().max().item() <= _ring_tol(dtype, want)
        if len(spans) == 1:
            one = ctx.run(lambda: tgrs._gemm_rs_ring_chunked(a[ctx.rank], b[ctx.rank], ctx,
                                                             dtype, spans))
            assert all(torch.equal(x, got) for x, (got, _) in zip(one, outs))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_reduce_scatter_kernel_matches_plain(cuda, world, dtype):
    """K18 against the ring's plain version: the same f32 adds in the same
    hop order, so bit for bit; two shapes back to back."""
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(80 + world)
    for m_loc, n in ((64, 300), (16, 4096), (1, 7)):
        x = [torch.randn((world * m_loc, n), generator=g, device=cuda).to(dtype)
             for _ in range(world)]
        before = trs._ring_reduce_scatter.launches
        outs = ctx.run(lambda: (trs.reduce_scatter(x[ctx.rank], ctx=ctx),
                                trs._reduce_scatter_ring_plain(x[ctx.rank], ctx)))
        assert trs._ring_reduce_scatter.launches == before + world
        for got, want in outs:
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("method", ["ring_1d", "ring_bidir"])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_ring_all_gather_kernel_is_exact(cuda, world, method, chunks):
    """K19-K22 on a ring context against the plain gather, bit for bit:
    f32 rows, a 1-D shard of 512 (spans 171/171/170 at chunks 3), bf16
    rows of 200 bytes (no 16-byte alignment: the byte path) and a 2-row
    shard with more chunks than rows, back to back (the workspace grows,
    epochs rise); world 2 sends nothing left, world 3 one step each way."""
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(90 + world)
    for shape, dtype in (((6, 16), torch.float32), ((512,), torch.float32),
                         ((13, 100), torch.bfloat16), ((2, 64), torch.float32)):
        x = [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(world)]
        spans = tcommon.chunk_schedule(shape[0], chunks)
        before = tag._RING_WRAPPERS[method, len(spans) > 1].launches
        outs = ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx, method=method,
                                              chunks_per_shard=chunks))
        assert tag._RING_WRAPPERS[method, len(spans) > 1].launches == before + world
        for got in outs:
            assert torch.equal(got, torch.cat(x))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_reduce_scatter_chunked_kernel_is_k18(cuda, world, dtype, chunks):
    """K23 against K18 and the ring's plain version, bit for bit: the same
    adds in the same hop order, only cut into spans."""
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(100 + world)
    for m_loc, n in ((64, 300), (16, 4096), (3, 7)):
        cfg = trs.ReduceScatterConfig(block_m=8, chunks_per_shard=chunks)
        spans = tcommon.ring_spans(m_loc, chunks, cfg.block_m)
        x = [torch.randn((world * m_loc, n), generator=g, device=cuda).to(dtype)
             for _ in range(world)]
        before = (trs._ring_reduce_scatter_chunked.launches, trs._ring_reduce_scatter.launches)
        outs = ctx.run(lambda: (trs.reduce_scatter(x[ctx.rank], ctx=ctx, config=cfg),
                                trs.reduce_scatter(x[ctx.rank], ctx=ctx),
                                trs._reduce_scatter_ring_plain(x[ctx.rank], ctx)))
        assert trs._ring_reduce_scatter_chunked.launches == before[0] + (
            world if len(spans) > 1 else 0)
        assert trs._ring_reduce_scatter.launches == before[1] + (
            2 * world if len(spans) == 1 else world)
        for chunked, one, want in outs:
            assert torch.equal(chunked, one) and torch.equal(chunked, want)


@pytest.mark.cuda
def test_ring_kernels_under_jitter_are_bit_identical(cuda):
    """Every ring kernel (K15-K23) at world 4 on a ring context, then again
    with the race-shaking delay on (each rank starts each kernel a
    different 1x-8x of the base later): the outputs are bit-identical."""
    world = 4
    ctx = _ring_ctx(world)
    g = torch.Generator(device="cuda").manual_seed(110)
    a = [torch.randn((64, 256), generator=g, device=cuda).bfloat16() for _ in range(world)]
    b = (torch.randn((256, 96), generator=g, device=cuda) / 16).bfloat16()
    a_rs = [torch.randn((world * 64, 128), generator=g, device=cuda).bfloat16()
            for _ in range(world)]
    b_rs = (torch.randn((128, 200), generator=g, device=cuda) / 12).bfloat16()
    x = [torch.randn((96, 40), generator=g, device=cuda) for _ in range(world)]
    two = dict(chunks_per_shard=2)

    def calls():
        r = ctx.rank
        return (
            tagg.ag_gemm(a[r], b, ctx=ctx),
            tagg.ag_gemm(a[r], b, ctx=ctx, config=tagg.AGGemmConfig(**two)),
            tgrs.gemm_rs(a_rs[r], b_rs, ctx=ctx),
            tgrs.gemm_rs(a_rs[r], b_rs, ctx=ctx, config=tgrs.GemmRSConfig(**two)),
            trs.reduce_scatter(x[r], ctx=ctx),
            trs.reduce_scatter(x[r], ctx=ctx, config=trs.ReduceScatterConfig(8, **two)),
            *[tag.all_gather(x[r], ctx=ctx, method=m, chunks_per_shard=c)
              for m in ("ring_1d", "ring_bidir") for c in (1, 2)],
        )

    want = ctx.run(calls)
    with config.comm_delay(20_000):
        got = ctx.run(calls)
    for w_rank, g_rank in zip(want, got):
        assert len(w_rank) == 10
        assert all(torch.equal(u, v) for u, v in zip(w_rank, g_rank))


@pytest.mark.cuda
def test_ring_bidir_stuck_wait_raises_with_its_record(cuda):
    """World 3, the bidirectional ring allgather: rank 1's stream is held
    2 s, the wait timeout is 0.2 s. Its two neighbours record the same
    fixed site, rank 1's arrival: rank 0 (whose right neighbour it is)
    and rank 2 (whose left neighbour it is); the run raises, not hangs."""
    ctx = _ring_ctx(3)
    x = torch.randn((64, 32), device=cuda)
    ctx.run(lambda: tag.all_gather(x, ctx=ctx, method="ring_bidir"))  # buffers and flags

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return tag.all_gather(x, ctx=ctx, method="ring_bidir")

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    got = sorted((r["pe"], r["family"], r["site"], r["kind"]) for r in err.value.records)
    assert got == [(0, "all_gather_ring_bidir", 1, "barrier_all"),
                   (2, "all_gather_ring_bidir", 1, "barrier_all")]


@pytest.mark.cuda
def test_ring_stuck_wait_raises_with_its_record(cuda):
    """Rank 1's stream is held for 2 s before its ring GEMM-RS: rank 0's
    wait for its right neighbour's arrival (0.2 s) expires and the run
    raises with a record naming rank 0, the gemm_rs_ring family and site
    1 — it does not hang."""
    ctx = _ring_ctx(2)
    a, b = torch.randn((64, 128), device=cuda), torch.randn((128, 256), device=cuda)
    ctx.run(lambda: tgrs.gemm_rs(a, b, ctx=ctx))  # the buffers and flags exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return tgrs.gemm_rs(a, b, ctx=ctx)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (
        0, "gemm_rs_ring", 1, "barrier_all")


@pytest.mark.cuda
def test_world4_ring_moe_train_step_finishes(cuda):
    """The world-4 MoE train step of the full-mesh test on a ring context:
    K15/K16 forward and backward, K18 for the MoE backward's dx; it
    finishes under a 30 s wait timeout and matches the world-1 step."""
    cfg = ttm.MoETransformerConfig(vocab=512, hidden=256, ffn=512, n_layers=1, n_q_heads=8,
                                   n_kv_heads=4, head_dim=32, batch=2, seq=64, n_experts=4,
                                   topk=2, gg_config=tgg.GroupGemmConfig(128))
    params = ttm.init_moe_params(cfg, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (128,), generator=g, device=cuda)
    targets = torch.randint(0, cfg.vocab, (128,), generator=g, device=cuda)
    want, want_loss = ttm.train_step(ttm.TPMoETransformer(cfg), params, tokens, targets,
                                     lr=0.1, dp_axis=None)
    ctx = _ring_ctx(4)
    shards = ttm.shard_params(params, 4, ctx.devices)
    before = (tagg._ag_gemm_ring.launches, tgrs._gemm_rs_ring.launches,
              trs._ring_reduce_scatter.launches, tagg.ag_gemm.launches)

    def body():
        r = ctx.rank
        return ttm.train_step(ttm.TPMoETransformer(cfg, ctx=ctx), shards[r],
                              tokens[r * 32:(r + 1) * 32], targets, lr=0.1, dp_axis=None)

    with config.wait_timeout(30):
        outs = ctx.run(body, grad=True)
    assert tagg._ag_gemm_ring.launches > before[0]
    assert tgrs._gemm_rs_ring.launches > before[1]
    assert trs._ring_reduce_scatter.launches == before[2] + 4
    assert tagg.ag_gemm.launches == before[3]
    for _, loss in outs:
        assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    got = ttm._tree_map(lambda first, dim, *rest: first if dim is None
                        else torch.cat([first, *rest], dim),
                        outs[0][0], ttm.specs_for(cfg), *[o[0] for o in outs[1:]])
    ttm._tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5), got, want)


def _a2a_inputs(world, max_m, hidden, dtype, g, cuda):
    """Every rank's send slabs [world, max_m, hidden], counts and a payload
    of int32 metadata."""
    if dtype == torch.int8:
        slabs = [torch.randint(-127, 128, (world, max_m, hidden), generator=g, device=cuda,
                               dtype=torch.int32).to(torch.int8) for _ in range(world)]
    else:
        slabs = [torch.randn((world, max_m, hidden), generator=g, device=cuda).to(dtype)
                 for _ in range(world)]
    splits = [torch.randint(0, max_m + 1, (world,), generator=g, device=cuda)
              for _ in range(world)]
    meta = [torch.randint(-9, 9, (world, 2 * max_m), generator=g, device=cuda,
                          dtype=torch.int32) for _ in range(world)]
    return slabs, splits, meta


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("world", [2, 4])
def test_all_to_all_kernel_is_exact(cuda, world, chunks):
    """K27 (one chunk) and K28 (spans) against the plain host exchange, bit
    for bit, with and without the payload's metadata, bf16, f32 and the
    one-byte wire, at three shapes back to back (the workspace grows, the
    epochs and their parity alternate), one of them cut into several
    pieces a chunk; the launch counts show which kernel ran."""
    ctx = initialize_distributed(world)
    g = torch.Generator(device=cuda).manual_seed(60 + world + chunks)
    cfg = ta2a.A2AConfig(puts_per_slab=2, chunks_per_shard=chunks)
    wrapper = ta2a._a2a if chunks == 1 else ta2a._a2a_chunked
    for max_m, hidden, dtype in ((5, 48, torch.bfloat16), (64, 4096, torch.bfloat16),
                                 (7, 40, torch.float32), (4, 4096, torch.int8)):
        slabs, splits, meta = _a2a_inputs(world, max_m, hidden, dtype, g, cuda)
        for with_meta in (False, True):
            before = wrapper.launches

            def body():
                r = ctx.rank
                m = meta[r] if with_meta else None
                return (ta2a.fast_all_to_all(slabs[r], splits[r], meta=m, ctx=ctx, config=cfg),
                        ta2a._fast_all_to_all_xla(slabs[r], splits[r], ctx, meta=m))

            for got, want in ctx.run(body):
                assert len(got) == len(want) == 2 + with_meta
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
            assert wrapper.launches == before + world


@pytest.mark.cuda
def test_all_to_all_under_jitter_is_bit_identical(cuda):
    """World 4, K27 and K28 with the race-shaking delay on: the same bytes."""
    ctx = initialize_distributed(4)
    g = torch.Generator(device=cuda).manual_seed(70)
    slabs, splits, meta = _a2a_inputs(4, 32, 512, torch.bfloat16, g, cuda)
    for chunks in (1, 2):
        cfg = ta2a.A2AConfig(chunks_per_shard=chunks)

        def body():
            r = ctx.rank
            return ta2a.fast_all_to_all(slabs[r], splits[r], meta=meta[r], ctx=ctx, config=cfg)

        calm = ctx.run(body)
        with config.comm_delay(100_000):
            shaken = ctx.run(body)
        for a, b in zip(calm, shaken):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3])
def test_all_to_all_stuck_wait_raises_with_its_record(cuda, chunks):
    """Rank 1's stream is held 2 s before its push: rank 0's collect waits
    (0.2 s) for rank 1's slab — chunk 0 of it with spans — expire, and the
    run raises with a record naming that site; it does not hang."""
    ctx = initialize_distributed(2)
    x, s = torch.randn((2, 48, 64), device=cuda), torch.tensor([3, 48], device=cuda)
    cfg = ta2a.A2AConfig(chunks_per_shard=chunks)
    ctx.run(lambda: ta2a.fast_all_to_all(x, s, ctx=ctx, config=cfg))  # buffers and flags

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return ta2a.fast_all_to_all(x, s, ctx=ctx, config=cfg)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    family = "all_to_all" if chunks == 1 else "all_to_all_chunked"
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (
        0, family, 2 + 1 * 16 + 0, "signal_wait_until")
    assert "rank 1" in rec["waits_for"]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "int8"])
def test_ep_moe_mlp_on_the_card_matches_the_cpu(cuda, wire):
    """``EPMoEMLP`` at world 4 on the card (K27, K8) against the same layer
    on the CPU (the plain versions), f32, on the f32 and the int8 wire:
    within 1e-5 of the output's scale (the wire quantizer rounds alike on
    both)."""
    world, m_loc, hid, ffn, n_exp, topk = 4, 48, 256, 512, 8, 2
    g = np.random.default_rng(71)
    x = torch.from_numpy(g.standard_normal((world * m_loc, hid)).astype(np.float32))
    w_up = torch.from_numpy((g.standard_normal((n_exp, hid, ffn)) / 16).astype(np.float32))
    w_down = torch.from_numpy((g.standard_normal((n_exp, ffn, hid)) / 22).astype(np.float32))
    ids = torch.from_numpy(np.argsort(g.random((world * m_loc, n_exp)), 1)[:, :topk]
                           .astype(np.int32))
    tw = torch.softmax(torch.from_numpy(g.standard_normal((world * m_loc, topk))
                                        .astype(np.float32)), -1)
    epr = n_exp // world
    outs = {}
    for dev in ("cpu", "cuda"):
        ctx = initialize_distributed(world, device=dev)

        def body():
            r = ctx.rank
            rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
            layer = tepmlp.EPMoEMLP(n_exp, topk, m_loc * topk, ctx, quant=wire,
                                    gg_config=tgg.GroupGemmConfig(128))
            return layer(*(t.to(dev) for t in (x[rows], w_up[ex], w_down[ex], ids[rows],
                                               tw[rows]))).cpu()

        before = (ta2a._a2a.launches, tgg.group_gemm.launches)
        outs[dev] = torch.cat(ctx.run(body))
        if dev == "cuda":
            assert ta2a._a2a.launches == before[0] + 2 * world
            assert tgg.group_gemm.launches == before[1] + 2 * world
    scale = outs["cpu"].abs().max().item()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-5 * scale


# ---- the ragged-row policy: K29 (K8/K24), K30 (K9/K25), K31 (K10/K26) ----

def _banks(gen, shape, fmt, dtype, device):
    """A float bank in `dtype`, or a one-byte one with its scale."""
    if fmt is None:
        return (torch.randn(shape, generator=gen, device=device) / shape[1]**0.5).to(dtype), None
    return _quant_bank(gen, shape, fmt, device)


def _dead_rows(valid, bm):
    """Rows at or past their block's live count, as a mask over the layout."""
    rows = torch.arange(valid.numel() * bm, device=valid.device)
    return rows % bm >= valid.reshape(-1).repeat_interleave(bm)


def _ragged_counts(fn):
    return (fn.launches, fn.scaled_launches, fn.ragged_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"], ids=["float", "int8", "fp8"])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("bm", [128, 256])
def test_ragged_group_gemm_kernel_matches_plain(cuda, fmt, dtype, out_dtype, bm):
    """K29 against its plain twin (an expert with no rows, tails of one row
    and more, the trailing dead blocks; a 256-row block skips its second
    tile): dead rows exact zeros, live rows bit-equal to K8/K24 on the same
    inputs, the GELU fused."""
    n_exp, tokens, k, n = 4, 150, 256, 304
    g = torch.Generator(device="cuda").manual_seed(bm + k)
    ids, _ = _moe_routing(g, tokens, n_exp, 2, cuda)
    ids[ids == 1] = 2  # expert 1 gets no rows
    ids[0, 0] = 3
    al = tmu.moe_align_block_size(ids.reshape(-1), n_exp, bm, ragged=True)
    assert (al.valid_rows == 0).any() and ((al.valid_rows > 0) & (al.valid_rows < bm)).any()
    a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g, device=cuda).to(dtype)
    b, scale = _banks(g, (n_exp, k, n), fmt, dtype, cuda)
    cfg = tgg.GroupGemmConfig(bm, ragged=True)
    for act_fn in (None, tgg.gelu):
        before = _ragged_counts(tgg.group_gemm)
        got = tgg.group_gemm(a, b, al.expert_ids, valid_rows=al.valid_rows, scale=scale,
                             config=cfg, out_dtype=out_dtype, act_fn=act_fn)
        padded = tgg.group_gemm(a, b, al.expert_ids, scale=scale,
                                config=tgg.GroupGemmConfig(bm), out_dtype=out_dtype,
                                act_fn=act_fn)
        torch.cuda.synchronize()
        after = _ragged_counts(tgg.group_gemm)
        assert after[2] == before[2] + 1 and after[0] + after[1] == before[0] + before[1] + 1
        want = tgg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act_fn, scale,
                                     al.valid_rows)
        dead = _dead_rows(al.valid_rows, bm)
        assert not got[dead].any()
        assert torch.equal(got[~dead], padded[~dead])
        tol = _tol(dtype, want.float()) if fmt is None else _scaled_tol(dtype, want.float())
        assert (got.float() - want.float()).abs().max().item() <= tol


def _all_dead(ral, rank):
    """`ral` with every block of `rank` dead."""
    valid = ral.valid_rows.clone()
    valid[rank] = 0
    return dataclasses.replace(ral, valid_rows=valid)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"], ids=["float", "int8", "fp8"])
def test_ragged_ag_group_gemm_kernel_matches_plain(cuda, world, fmt):
    """K30 (bf16 slabs) against its plain twin, live rows bit-equal to K9/K25,
    dead rows zero; then with every block of rank 1 dead: the gathered
    slabs are still whole (each tile waits for its slab before it skips)."""
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world + 60)
    n_exp, topk, bm, m_loc, k, n_loc = 4, 2, 128, 100, 256, 304
    ids, _ = _moe_routing(g, world * m_loc, n_exp, topk, cuda)
    ral = tmu.moe_align_ranked(ids.reshape(world, -1), n_exp, bm, m_loc, ragged=True)
    x = [torch.randn((m_loc, k), generator=g, device=cuda).bfloat16() for _ in range(world)]
    b, scale = _banks(g, (n_exp, k, n_loc), fmt, torch.bfloat16, cuda)
    slabs = torch.cat([x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(world)])
    cfg = tgg.GroupGemmConfig(bm, ragged=True)
    for al in (ral, _all_dead(ral, 1)):
        valid = al.valid_rows.reshape(-1)
        want = tgg._group_gemm_plain(slabs, b, al.expert_ids.reshape(-1), bm, torch.bfloat16,
                                     None, scale, valid)
        before = _ragged_counts(taggg.ag_group_gemm_overlap)
        outs = ctx.run(lambda: taggg.ag_group_gemm_overlap(
            x[ctx.rank], b, al, ctx=ctx, config=cfg, scale=scale, gather_output=True))
        padded = ctx.run(lambda: taggg.ag_group_gemm_overlap(x[ctx.rank], b, al, ctx=ctx,
                                                             scale=scale))
        after = _ragged_counts(taggg.ag_group_gemm_overlap)
        assert after[2] == before[2] + world
        dead = _dead_rows(valid, bm)
        for (out, ag), pad in zip(outs, padded):
            assert torch.equal(ag, slabs)
            assert not out[dead].any() and torch.equal(out[~dead], pad[~dead])
            tol = _tol(torch.bfloat16, want.float()) if fmt is None else _scaled_tol(
                torch.bfloat16, want.float())
            assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"], ids=["float", "int8", "fp8"])
def test_ragged_moe_reduce_rs_kernel_matches_k10(cuda, world, fmt):
    """K31 (bf16) bit-equal to K10/K26 under the alignment's own map (the
    combine reads only live rows); with every block of rank 1's chunk dead
    it still finishes (the push and flag go out) and matches its plain
    twin."""
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(70 + world)
    n_exp, topk, bm, m_loc, f_loc, h = 4, 2, 128, 100, 256, 528
    ids, w = _moe_routing(g, world * m_loc, n_exp, topk, cuda)
    ral = tmu.moe_align_ranked(ids.reshape(world, -1), n_exp, bm, m_loc, ragged=True)
    dst, w_rows = tmu.ranked_scatter_meta(ral, w)
    inv = tmu.ranked_combine_rows(ral, m_loc, topk)
    hs = [torch.randn((world * ral.t_pad_loc, f_loc), generator=g, device=cuda).bfloat16()
          for _ in range(world)]
    banks = [_banks(g, (n_exp, f_loc, h), fmt, torch.bfloat16, cuda) for _ in range(world)]
    cfg = tgg.GroupGemmConfig(bm, ragged=True)

    def run(valid, config):
        def body():
            r = ctx.rank
            wd, sc = banks[r]
            got = tmrs.moe_reduce_rs_overlap(hs[r], wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                             m_out=m_loc, combine_rows=inv, valid_rows=valid,
                                             config=config, scale=sc)
            want = tmrs._moe_rs_overlap_xla(hs[r], wd, ral.expert_ids, dst, w_rows, ctx,
                                            m_loc, torch.bfloat16, sc, valid)
            return got, want
        return ctx.run(body)

    before = _ragged_counts(tmrs.moe_reduce_rs_overlap)
    ragged = run(ral.valid_rows, cfg)
    assert _ragged_counts(tmrs.moe_reduce_rs_overlap)[2] == before[2] + world
    padded = run(None, tgg.GroupGemmConfig(bm))
    for (got, _), (pad, _) in zip(ragged, padded):
        assert torch.equal(got, pad)
    for got, want in run(_all_dead(ral, 1).valid_rows, cfg):
        tol = 2 * (_tol(torch.bfloat16, want.float()) if fmt is None else _scaled_tol(
            torch.bfloat16, want.float()))
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_ragged_ag_group_gemm_stuck_wait_raises_with_its_record(cuda):
    """K30 with every block of rank 1 dead and rank 1's stream held 2 s:
    rank 0 still waits for rank 1 (its entry barrier, then the slab) and
    the run raises with records naming rank 1 — it does not hang, and it
    does not finish before the slab it skips has landed."""
    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(8)
    ids, _ = _moe_routing(g, 32, 4, 2, cuda)
    ral = _all_dead(tmu.moe_align_ranked(ids.reshape(2, -1), 4, 128, 16, ragged=True), 1)
    x = torch.randn((16, 64), generator=g, device=cuda)
    b = torch.randn((4, 64, 32), generator=g, device=cuda)
    cfg = tgg.GroupGemmConfig(128, ragged=True)

    def call():
        return taggg.ag_group_gemm_overlap(x, b, ral, ctx=ctx, config=cfg)

    ctx.run(call)  # the workspace and flags exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return call()

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    recs = err.value.records
    assert recs and all(r["pe"] == 0 and r["family"] == "ag_group_gemm" for r in recs)
    assert {r["site"] for r in recs} <= {1, 2 + 1} and all("rank 1" in r["waits_for"]
                                                          for r in recs)


@pytest.mark.cuda
def test_ragged_ep_moe_mlp_on_the_card_matches_the_cpu(cuda):
    """``EPMoEMLP`` at world 4 on the card with a ragged config (K27, K29)
    against the same layer on the CPU, f32, within 1e-5 of the output's
    scale; fewer rows computed than the layout holds."""
    world, m_loc, hid, ffn, n_exp, topk = 4, 48, 256, 512, 8, 2
    g = np.random.default_rng(72)
    x = torch.from_numpy(g.standard_normal((world * m_loc, hid)).astype(np.float32))
    w_up = torch.from_numpy((g.standard_normal((n_exp, hid, ffn)) / 16).astype(np.float32))
    w_down = torch.from_numpy((g.standard_normal((n_exp, ffn, hid)) / 22).astype(np.float32))
    ids = torch.from_numpy(np.argsort(g.random((world * m_loc, n_exp)), 1)[:, :topk]
                           .astype(np.int32))
    tw = torch.softmax(torch.from_numpy(g.standard_normal((world * m_loc, topk))
                                        .astype(np.float32)), -1)
    epr = n_exp // world
    outs = {}
    for dev in ("cpu", "cuda"):
        ctx = initialize_distributed(world, device=dev)
        tepmlp.EPMoEMLP.rows, tepmlp.EPMoEMLP.live_rows = 0, {}

        def body():
            r = ctx.rank
            rows, ex = slice(r * m_loc, (r + 1) * m_loc), slice(r * epr, (r + 1) * epr)
            layer = tepmlp.EPMoEMLP(n_exp, topk, m_loc * topk, ctx,
                                    gg_config=tgg.GroupGemmConfig(128, ragged=True))
            return layer(*(t.to(dev) for t in (x[rows], w_up[ex], w_down[ex], ids[rows],
                                               tw[rows]))).cpu()

        before = tgg.group_gemm.ragged_launches
        outs[dev] = torch.cat(ctx.run(body))
        if dev == "cuda":
            assert tgg.group_gemm.ragged_launches == before + 2 * world
            assert 0 < tepmlp.EPMoEMLP.live_row_count() < tepmlp.EPMoEMLP.rows
    scale = outs["cpu"].abs().max().item()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-5 * scale


# ---- the chunked schedules: K32 (K9/K25/K30 with spans), K33 (K10/K26/K31
# with spans), bit-equal to their one-span kernels ----

# name: (format, ragged, chunks, policy)
CHUNK_CASES = {"bf16-c2": (None, False, 2, "contig"),
               "int8-ragged-c3-window": ("int8", True, 3, "window"),
               "fp8-c2-torus2d": ("fp8", False, 2, "torus2d"),
               "bf16-ragged-c3-interleave": (None, True, 3, "interleave")}


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [c for c in CHUNK_CASES if "interleave" not in c])
def test_chunked_ag_group_gemm_kernel_matches_one_span(cuda, world, case):
    """K32 (bf16 slabs, 128-row gather groups: two or three spans a slab)
    bit-equal to K9/K25/K30 on the same inputs, its gathered slabs whole,
    and within the one-span kernel's tolerance of the plain twin."""
    fmt, ragged, chunks, policy = CHUNK_CASES[case]
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world + 80)
    n_exp, topk, bm, m_loc, k, n_loc = 4, 2, 128, 160, 256, 304
    ids, _ = _moe_routing(g, world * m_loc, n_exp, topk, cuda)
    ral = tmu.moe_align_ranked(ids.reshape(world, -1), n_exp, bm, m_loc, ragged=ragged)
    spans = tcommon.resolve_spans(ral.t_pad_loc, chunks, bm, policy=policy, world=world,
                                  side="ag")
    assert len(spans) > 1
    x = [torch.randn((m_loc, k), generator=g, device=cuda).bfloat16() for _ in range(world)]
    b, scale = _banks(g, (n_exp, k, n_loc), fmt, torch.bfloat16, cuda)
    slabs = torch.cat([x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(world)])
    one = tgg.GroupGemmConfig(bm, ragged=ragged)
    cfg = dataclasses.replace(one, chunks_per_shard=chunks, span_policy=policy)

    def call(config):
        return lambda: taggg.ag_group_gemm_overlap(x[ctx.rank], b, ral, ctx=ctx, config=config,
                                                   scale=scale, gather_output=True,
                                                   gather_group_blocks=1)

    before = taggg.ag_group_gemm_overlap.chunked_launches
    outs = ctx.run(call(cfg))
    assert taggg.ag_group_gemm_overlap.chunked_launches == before + world
    ones = ctx.run(call(one))
    want = tgg._group_gemm_plain(slabs, b, ral.expert_ids.reshape(-1), bm, torch.bfloat16,
                                 None, scale, ral.valid_rows.reshape(-1) if ragged else None)
    for (out, ag), (ref, _) in zip(outs, ones):
        assert torch.equal(ag, slabs) and torch.equal(out, ref)
        tol = _tol(torch.bfloat16, want.float()) if fmt is None else _scaled_tol(
            torch.bfloat16, want.float())
        assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [c for c in CHUNK_CASES if "torus2d" not in c])
def test_chunked_moe_reduce_rs_kernel_matches_one_span(cuda, world, case):
    """K33 (bf16; 256 or 384 tokens out a rank: two or three 128-row spans,
    or more under a policy) bit-equal to K10/K26/K31 on the same inputs."""
    fmt, ragged, chunks, policy = CHUNK_CASES[case]
    ctx = initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world + 90)
    n_exp, topk, bm, f_loc, h = 4, 2, 128, 256, 528
    m_loc = 128 * chunks
    ids, w = _moe_routing(g, world * m_loc, n_exp, topk, cuda)
    ral = tmu.moe_align_ranked(ids.reshape(world, -1), n_exp, bm, m_loc, ragged=ragged)
    assert len(tcommon.resolve_spans(m_loc, chunks, 128, policy=policy, world=world)) > 1
    dst, w_rows = tmu.ranked_scatter_meta(ral, w)
    inv = tmu.ranked_combine_rows(ral, m_loc, topk)
    hs = [torch.randn((world * ral.t_pad_loc, f_loc), generator=g, device=cuda).bfloat16()
          for _ in range(world)]
    banks = [_banks(g, (n_exp, f_loc, h), fmt, torch.bfloat16, cuda) for _ in range(world)]
    one = tgg.GroupGemmConfig(bm, ragged=ragged)
    cfg = dataclasses.replace(one, chunks_per_shard=chunks, span_policy=policy)

    def call(config):
        def body():
            r = ctx.rank
            wd, sc = banks[r]
            return tmrs.moe_reduce_rs_overlap(hs[r], wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                              m_out=m_loc, combine_rows=inv,
                                              valid_rows=ral.valid_rows, config=config,
                                              scale=sc)
        return body

    before = tmrs.moe_reduce_rs_overlap.chunked_launches
    got = ctx.run(call(cfg))
    assert tmrs.moe_reduce_rs_overlap.chunked_launches == before + world
    for out, ref in zip(got, ctx.run(call(one))):
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ag_group_gemm", "moe_rs"])
def test_chunked_stuck_wait_names_chunk_zero(cuda, kernel, monkeypatch):
    """K32 / K33 at world 2, two spans, with rank 1 held 2 s just after its
    entry barrier (so the barrier passes and its chunks are late): the
    waits on rank 1's spans expire (0.2 s) and every record names chunk 0
    of rank 1 (site 2 + 1 * 16 + 0), whichever block's clock ran out."""
    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(9)
    ids, w = _moe_routing(g, 512, 4, 2, cuda)
    ral = tmu.moe_align_ranked(ids.reshape(2, -1), 4, 128, 256)
    cfg = tgg.GroupGemmConfig(128, chunks_per_shard=2)
    if kernel == "ag_group_gemm":
        module = tagg  # push_shards' entry barrier
        x = torch.randn((256, 64), generator=g, device=cuda)
        b = torch.randn((4, 64, 32), generator=g, device=cuda)

        def call():
            return taggg.ag_group_gemm_overlap(x, b, ral, ctx=ctx, config=cfg,
                                               gather_group_blocks=1)
    else:
        module = tmrs
        dst, w_rows = tmu.ranked_scatter_meta(ral, w)
        inv = tmu.ranked_combine_rows(ral, 256, 2)
        hs = torch.randn((2 * ral.t_pad_loc, 64), generator=g, device=cuda)
        wd = torch.randn((4, 64, 32), generator=g, device=cuda)

        def call():
            return tmrs.moe_reduce_rs_overlap(hs, wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                              m_out=256, combine_rows=inv, config=cfg)

    ctx.run(call)  # the buffers and flags exist
    barrier = module.launch_barrier

    def late(ctx_, launch, flags, stream):
        barrier(ctx_, launch, flags, stream)
        if ctx_.rank == 1:
            with torch.cuda.stream(stream):
                tcommon.sleep_on_stream(2_000_000_000)

    monkeypatch.setattr(module, "launch_barrier", late)
    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(call)
    recs = err.value.records
    assert recs and all((r["family"], r["site"]) == (f"{kernel}_chunked", 2 + 16)
                        for r in recs), recs
    assert all(r["waits_for"] == f"chunk 0 of rank 1's "
               f"{'sorted slab' if kernel == 'ag_group_gemm' else 'partial'}" for r in recs)
    assert 0 in {r["pe"] for r in recs}


# ---------------------------------- the ragged dW K34, ring attention K35 ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bm", [128, 256])
def test_ragged_group_gemm_dw_kernel(cuda, dtype, bm):
    """K34 on a ragged alignment (an expert with no rows, tails of one row
    and more, trailing dead blocks): within K11's tolerance of the plain
    version, bit-equal to K11 on the same A and G with their dead rows
    zeroed (an f32 acc + 0 is exact), and NaN in the dead rows of A and G
    changes nothing; an expert whose blocks are all dead is exactly zero."""
    n_exp, tokens, k, n = 4, 300, 200, 264
    g = torch.Generator(device="cuda").manual_seed(bm + 3)
    ids, _ = _moe_routing(g, tokens, n_exp, 2, cuda)
    ids[ids == 1] = 2  # expert 1 gets no rows
    ids[0, 0] = 3
    al = tmu.moe_align_block_size(ids.reshape(-1), n_exp, bm, ragged=True)
    assert ((al.valid_rows > 0) & (al.valid_rows < bm)).any()
    t_pad = al.sorted_token_ids.shape[0]
    live = (torch.arange(t_pad, device=cuda) % bm) < al.valid_rows.long().repeat_interleave(bm)
    a = torch.randn((t_pad, k), generator=g, device=cuda).to(dtype)
    gr = torch.randn((t_pad, n), generator=g, device=cuda).to(dtype)
    cfg = tgg.GroupGemmConfig(bm, ragged=True)
    before = (tgg.group_gemm_dw.launches, tgg.group_gemm_dw.ragged_launches)
    got = tgg.group_gemm_dw(a, gr, al.expert_ids, n_exp, valid_rows=al.valid_rows, config=cfg)
    torch.cuda.synchronize()
    assert (tgg.group_gemm_dw.launches, tgg.group_gemm_dw.ragged_launches) == (
        before[0], before[1] + 1)
    want = tgg._group_gemm_dw_plain(a, gr, al.expert_ids, n_exp, bm, al.valid_rows)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    zeroed = [torch.where(live[:, None], x, 0) for x in (a, gr)]
    padded = tgg.group_gemm_dw(*zeroed, al.expert_ids, n_exp, config=tgg.GroupGemmConfig(bm))
    assert torch.equal(got, padded)
    junk = [torch.where(live[:, None], x, float("nan")) for x in (a, gr)]
    assert torch.equal(tgg.group_gemm_dw(*junk, al.expert_ids, n_exp, valid_rows=al.valid_rows,
                                         config=cfg), got)
    assert torch.all(got[1] == 0)
    dead = torch.zeros_like(al.valid_rows)
    assert torch.all(tgg.group_gemm_dw(a, gr, al.expert_ids, n_exp, valid_rows=dead,
                                       config=cfg) == 0)


def _ring_attention_inputs(g, world, b, h, s_loc, d, dtype, device):
    return [[torch.randn((b, h, s_loc, d), generator=g, device=device).to(dtype)
             for _ in range(3)] for _ in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.float32, 40)])
@pytest.mark.parametrize("layout,causal", [("contig", True), ("zigzag", True),
                                           ("contig", False)])
def test_ring_attention_kernel_matches_plain(cuda, world, dtype, d, layout, causal):
    """K35 against its plain version (the ring-order online softmax) on
    the same shards: out within one bf16 ulp of its scale (f32: 1e-5 of
    it), lse within 1e-5 x its scale; a shard of 200 rows (stripes of 100)
    leaves partial query and key tiles, and 20 heads give a persistent
    block several query tiles a step (a rank runs at most 31 blocks); two
    calls back to back (the landing buffer and the epochs are reused)."""
    ctx = None if world == 1 else initialize_distributed(world)
    g = torch.Generator(device="cuda").manual_seed(world * 7 + d)
    h = 20
    for s_loc in (200, 64):
        xs = _ring_attention_inputs(g, world, 1, h, s_loc, d, dtype, cuda)

        def body():
            r = 0 if ctx is None else ctx.rank
            got = tra.ring_attention(*xs[r], ctx=ctx, causal=causal, layout=layout,
                                     return_lse=True)
            q3, k3, v3 = (x.reshape(h, s_loc, d) for x in xs[r])
            out, m, l = tra._ring_attention_plain(q3, k3, v3, ctx, causal, layout)
            return got, (out.reshape(xs[r][0].shape), tra.lse_of(m, l).reshape(1, h, s_loc))

        before = tra.ring_attention.launches
        outs = [body()] if ctx is None else ctx.run(body)
        assert tra.ring_attention.launches == before + world
        for (out, lse), (want, want_lse) in outs:
            scale = want.float().abs().max().item()
            tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * scale
            assert (out.float() - want.float()).abs().max().item() <= tol
            assert (lse - want_lse).abs().max().item() <= 1e-5 * want_lse.abs().max().item()


@pytest.mark.cuda
def test_ring_attention_stuck_wait_raises_with_its_record(cuda):
    """Rank 1's stream is held for 2 s before its ring attention at world
    2: rank 0's every block waits first for its right neighbour's arrival
    (0.2 s), and the run raises with that record: rank 0, the
    ring_attention family, site 1."""
    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = _ring_attention_inputs(g, 2, 1, 2, 128, 64, torch.bfloat16, cuda)
    ctx.run(lambda: tra.ring_attention(*xs[ctx.rank], ctx=ctx))  # the buffers exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return tra.ring_attention(*xs[ctx.rank], ctx=ctx)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (
        0, "ring_attention", 1, "barrier_all")


GRIDS_2D = [(2, 2), (2, 4), (4, 2)]


def _pair_ctx(n_o, n_i, names=("dp", "tp")):
    return initialize_distributed(mesh_shape={names[0]: n_o, names[1]: n_i})


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS_2D, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ring_2d_all_gather_kernel_is_exact(cuda, grid):
    """K36 over a (dp, tp) pair against the plain gather, bit for bit, and
    equal to K19 over the flattened ring of the same ranks: f32 rows, a
    1-D shard, bf16 rows of 200 bytes (the byte path) and a 1-row shard,
    back to back (the workspace grows, epochs rise); rings of 4 in either
    axis name a wrong neighbour that rings of 2 would hide. The swapped
    pair ("tp", "dp") gathers in its own order."""
    n_o, n_i = grid
    n = n_o * n_i
    ctx = _pair_ctx(n_o, n_i)
    flat = _ring_ctx(n)
    g = torch.Generator(device="cuda").manual_seed(300 + n_o)
    for shape, dtype in (((6, 16), torch.float32), ((512,), torch.float32),
                         ((13, 100), torch.bfloat16), ((1, 64), torch.float32)):
        x = [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(n)]
        before = tag._all_gather_ring_2d.launches
        outs = ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx))
        assert tag._all_gather_ring_2d.launches == before + n
        ring = flat.run(lambda: tag.all_gather(x[flat.rank], ctx=flat, method="ring_1d"))
        for got, k19 in zip(outs, ring):
            assert torch.equal(got, torch.cat(x)) and torch.equal(got, k19)
        swapped = ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx, axis=("tp", "dp")))
        order = [o * n_i + i for i in range(n_i) for o in range(n_o)]
        assert all(torch.equal(got, torch.cat([x[r] for r in order])) for got in swapped)


@pytest.mark.cuda
def test_ring_2d_all_gather_over_three_axes(cuda):
    """The 2-D ring over the two innermost axes of a 2 x 2 x 2 runtime (two
    pair groups at once), then the staged gather over the outermost."""
    ctx = initialize_distributed(mesh_shape={"pp": 2, "dp": 2, "tp": 2})
    g = torch.Generator(device="cuda").manual_seed(310)
    x = [torch.randn((5, 32), generator=g, device=cuda) for _ in range(8)]
    outs = ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx))
    assert all(torch.equal(got, torch.cat(x)) for got in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS_2D, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_2d_ag_gemm_kernel_matches_plain(cuda, grid, dtype):
    """K37 over a (dp, tp) pair: every output tile bit-equal to K15's over
    the flattened ring (the same K loop over the same rows), within one
    bf16 ulp of the output scale (f32: 1e-5) of its 2-D-order plain
    version, and the gathered A bit-exact; two shapes back to back."""
    n_o, n_i = grid
    n = n_o * n_i
    ctx = _pair_ctx(n_o, n_i)
    flat = _ring_ctx(n)
    g = torch.Generator(device="cuda").manual_seed(320 + n_o)
    for m_loc, k, n_loc in ((64, 256, 300), (100, 512, 96), (2, 128, 64)):
        a = [torch.randn((m_loc, k), generator=g, device=cuda).to(dtype) for _ in range(n)]
        b = (torch.randn((k, n_loc), generator=g, device=cuda) / k**0.5).to(dtype)
        before = tagg._ag_gemm_ring_2d.launches
        outs = ctx.run(lambda: (
            tagg.ag_gemm(a[ctx.rank], b, ctx=ctx, gather_output=True),
            tagg._ag_gemm_2d_plain(a[ctx.rank], b, ctx, False, dtype)))
        assert tagg._ag_gemm_ring_2d.launches == before + n
        k15 = flat.run(lambda: tagg.ag_gemm(a[flat.rank], b, ctx=flat))
        for ((out, ag), want), ring in zip(outs, k15):
            assert torch.equal(ag, torch.cat(a))
            assert torch.equal(out, ring)
            assert (out.float() - want.float()).abs().max().item() <= _ring_tol(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["all_gather_2d", "ag_gemm_2d"])
def test_ring_2d_stuck_wait_raises_with_its_record(cuda, family):
    """Rank 1's stream is held for 2 s before its K36 / K37 at 2 x 2: every
    other rank's entry barrier waits for the group's ranks in rank order,
    so each records site 1 (the arrival of rank 1), with its global rank
    and the group."""
    ctx = _pair_ctx(2, 2)
    g = torch.Generator(device="cuda").manual_seed(330)
    a = [torch.randn((64, 128), generator=g, device=cuda) for _ in range(4)]
    b = torch.randn((128, 64), generator=g, device=cuda)
    op = ((lambda r: tag.all_gather(a[r], ctx=ctx)) if family == "all_gather_2d"
          else (lambda r: tagg.ag_gemm(a[r], b, ctx=ctx)))
    ctx.run(lambda: op(ctx.rank))  # the buffers exist

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return op(ctx.rank)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    got = sorted((r["pe"], r["family"], r["site"], r["kind"], r["rank"], r["group"])
                 for r in err.value.records)
    assert got == [(p, family, 1, "barrier_all", p, "dp,tp") for p in (0, 2, 3)]


# ---- one-byte KV caches: K38 (decode), K39 (paged decode), K40 (verify) ----

KV_QUANTIZERS = {"int8": tfd.quantize_kv, "fp8": tfd.quantize_kv_fp8}

QUANT_DECODE_CASES = {
    # name: (b, hq, h_kv, s, d, lens, soft_cap)
    **CASES,
    "d96_g4_cap": (3, 16, 4, 400, 96, [400, 0, 131], 20.0),
}


def _quant_tol(ref: torch.Tensor) -> float:
    """One bf16 ulp of the output scale: the kernel rounds ``p * v_scale``
    to bf16 at each 64-position tile's running max, the plain version at
    the row's final max, so single terms round apart by up to a bf16 ulp."""
    scale = ref[torch.isfinite(ref)].abs().max().item()
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _skewed_cache(rng, shape):
    """Cache rows whose magnitudes span three decades across positions, so a
    row scale read at the wrong position shows."""
    x = rng.standard_normal(shape)
    return (x * np.logspace(-1.5, 1.5, shape[-2])[rng.permutation(shape[-2])][:, None]
            ).astype(np.float32)


def _check_quant(got, want, empty):
    """out within :func:`_quant_tol`; lse within 1e-5 of its scale (the same
    unrounded sums, f32 order only); rows with no cache out 0, lse -inf."""
    o, lse = got
    assert (o - want[0]).abs().max().item() <= _quant_tol(want[0])
    live = ~empty
    scale = want[1][live].abs().max().item()
    assert (lse[live] - want[1][live]).abs().max().item() <= 1e-5 * scale
    assert (o[empty] == 0).all() and torch.isneginf(lse[empty]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(QUANT_DECODE_CASES))
def test_quant_decode_kernels_match_plain(cuda, fmt, name):
    """K38 and K39 against their plain versions: lengths 0 / partial / full,
    g 1 and 4, the soft cap, head dims 16, 24 (one-byte rows not a multiple
    of 16 bytes: value-by-value loads), 96 and 128; the pool behind a
    shuffled table with junk entries past each length."""
    b, hq, h_kv, s, d, lens, cap = QUANT_DECODE_CASES[name]
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(_skewed_cache(rng, (b, h_kv, s, d))).to(cuda)
    v = torch.from_numpy(_skewed_cache(rng, (b, h_kv, s, d))).to(cuda)
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kq, vq, ks, vs = KV_QUANTIZERS[fmt](k, v)
    before = tfd.flash_decode_quant.launches
    got = tfd.flash_decode_quant(q, kq, vq, ks, vs, tl, return_lse=True,
                                 config=tfd.FlashDecodeConfig(soft_cap=cap))
    want = tfd._plain_decode_quant(q, kq, vq, ks, vs, tl, return_lse=True, soft_cap=cap)
    page = 8
    pps = s // page
    perm = torch.from_numpy(rng.permutation(b * pps)).to(cuda)
    pool = lambda x: x.reshape(b, h_kv, pps, page, -1).transpose(1, 2).reshape(  # noqa: E731
        b * pps, h_kv, page, -1)[torch.argsort(perm)].contiguous()
    table = perm.reshape(b, pps).to(torch.int32)
    junk = torch.from_numpy(rng.integers(0, b * pps, (b, pps))).to(cuda, torch.int32)
    used = torch.arange(pps, device=cuda)[None, :] < ((tl + page - 1) // page)[:, None]
    table = torch.where(used, table, junk).contiguous()
    kpq, kps, vpq, vps = (pool(x) for x in (kq, ks.transpose(2, 3), vq, vs.transpose(2, 3)))
    kps, vps = kps.transpose(2, 3).contiguous(), vps.transpose(2, 3).contiguous()
    pbefore = tfd.paged_flash_decode.quant_launches
    pgot = tfd.paged_flash_decode(q, kpq, vpq, tl, table, k_scales=kps, v_scales=vps,
                                  soft_cap=cap, return_lse=True)
    pwant = tfd._plain_paged_decode_quant(q, kpq, vpq, kps, vps, tl, table, return_lse=True,
                                          soft_cap=cap)
    torch.cuda.synchronize()
    assert tfd.flash_decode_quant.launches == before + 1
    assert tfd.paged_flash_decode.quant_launches == pbefore + 1
    empty = tl == 0
    _check_quant(got, want, empty[:, None].expand(b, hq))
    _check_quant(pgot, pwant, empty[:, None].expand(b, hq))
    # the pool read through its table is the contiguous cache, bit for bit
    assert torch.equal(pwant[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_quant_verify_kernel_matches_plain(cuda, fmt, name):
    """K40 against its plain version: ragged per-row lengths with empty and
    full rows, the soft cap, head dims 8 (value-by-value loads), 64, 96 and
    128, groups of 1, 4 and 8."""
    b, S, hq, h_kv, s, d, cap, _ = VERIFY_CASES[name]
    rng = np.random.default_rng(19)
    q = torch.from_numpy(rng.standard_normal((b, S, hq, d)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(_skewed_cache(rng, (b, h_kv, s, d))).to(cuda)
    v = torch.from_numpy(_skewed_cache(rng, (b, h_kv, s, d))).to(cuda)
    lens = rng.integers(0, s + 1, (b, S)).astype(np.int32)
    lens[0, 0], lens[-1, -1] = 0, s
    tl = torch.from_numpy(lens).to(cuda)
    kq, vq, ks, vs = KV_QUANTIZERS[fmt](k, v)
    before = tfd.flash_verify.quant_launches
    got = tfd.flash_verify(q, kq, vq, tl, config=tfd.FlashDecodeConfig(soft_cap=cap),
                           return_lse=True, scales=(ks, vs))
    want = tfd._plain_verify_quant(q, kq, vq, ks, vs, tl, return_lse=True, soft_cap=cap)
    torch.cuda.synchronize()
    assert tfd.flash_verify.quant_launches == before + 1
    _check_quant(got, want, torch.from_numpy(lens == 0).to(cuda)[..., None].expand(b, S, hq))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_verify_composes_bit_for_bit(cuda, fmt):
    """A whole-range quantized ranged-prefill call and the calls over its
    chunks give every row the same (out, lse) bits."""
    b, S, hq, h_kv, s, d = 3, 150, 32, 8, 512, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, S, hq, d), generator=gen, device=cuda)
    kq, vq, ks, vs = KV_QUANTIZERS[fmt](
        torch.randn((b, h_kv, s, d), generator=gen, device=cuda),
        torch.randn((b, h_kv, s, d), generator=gen, device=cuda))
    run = lambda qq, lens: tfd.flash_verify_fp8(  # noqa: E731
        qq, kq, vq, ks, vs, lens, return_lse=True)
    pos0 = torch.tensor([0, 77, s], device=cuda)
    whole = run(q, tfd._ranged_local_lens(pos0, S, 0, s))
    for lo, hi in ((0, 1), (1, 64), (64, 150)):
        part = run(q[:, lo:hi].contiguous(), tfd._ranged_local_lens(pos0 + lo, hi - lo, 0, s))
        assert torch.equal(part[0], whole[0][:, lo:hi]), (lo, hi)
        assert torch.equal(part[1], whole[1][:, lo:hi]), (lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_kv_quantizers_on_the_card_equal_the_cpu(cuda, fmt):
    """The card's one-byte cache and scales equal the CPU quantizer's (which
    the CPU tests hold equal to the JAX package's), rows over ten decades."""
    g = torch.Generator().manual_seed(7)
    k = torch.randn((2, 4, 96, 128), generator=g) * torch.logspace(-6, 4, 96)[:, None]
    v = torch.randn((2, 4, 96, 128), generator=g)
    for got, want in zip(KV_QUANTIZERS[fmt](k.to(cuda), v.to(cuda)), KV_QUANTIZERS[fmt](k, v)):
        got = got.cpu()
        if got.element_size() == 1:
            got, want = got.view(torch.uint8), want.view(torch.uint8)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_quant_sp_entries_match_world1(cuda, world):
    """The SP entries with every rank on the one card: int8 and fp8 decode
    and the fp8 ranged prefill over each rank's sequence shard, merged by
    the full-mesh allgather (and a ring gather), against the world-1 plain
    path over the whole cache; ``flash_decode_op`` against the world-1
    bf16 decode."""
    b, hq, h_kv, d, s = 4, 16, 4, 128, 256 * world
    s_loc = s // world
    gen = torch.Generator(device=cuda).manual_seed(8 + world)
    q = torch.randn((b, hq, d), generator=gen, device=cuda)
    k = torch.randn((b, h_kv, s, d), generator=gen, device=cuda)
    v = torch.randn((b, h_kv, s, d), generator=gen, device=cuda)
    lens = torch.tensor([s, 0, s_loc + 3, s - 5], dtype=torch.int32, device=cuda)
    ctx = initialize_distributed(world)
    sl = lambda x, r: x[..., r * s_loc:(r + 1) * s_loc, :].contiguous()  # noqa: E731
    sl_scale = lambda x, r: x[..., r * s_loc:(r + 1) * s_loc].contiguous()  # noqa: E731
    for fmt, entry in (("int8", tfd.flash_decode_quant_distributed),
                       ("fp8", tfd.flash_decode_fp8_distributed)):
        kq, vq, ks, vs = KV_QUANTIZERS[fmt](k, v)
        want = tfd._plain_decode_quant(q, kq, vq, ks, vs, lens, return_lse=False)
        for method in ("full_mesh_push", "ring_bidir"):
            def body():
                r = ctx.rank
                local = torch.clamp(lens - r * s_loc, 0, s_loc).to(torch.int32)
                return entry(q, sl(kq, r), sl(vq, r), sl_scale(ks, r), sl_scale(vs, r), local,
                             ctx=ctx, ag_method=method)
            for got in ctx.run(body):
                assert (got - want).abs().max().item() <= 2 * _quant_tol(want), (fmt, method)
    # the fp8 ranged prefill: 40 rows from pos0 straddling a shard boundary
    S = 40
    qr = torch.randn((b, S, hq, d), generator=gen, device=cuda)
    kq, vq, ks, vs = tfd.quantize_kv_fp8(k, v)
    pos0 = torch.tensor([0, s_loc - 7, s - S, 3], device=cuda)
    want = tfd._plain_verify_quant(qr, kq, vq, ks, vs, tfd._ranged_local_lens(pos0, S, 0, s),
                                   return_lse=False)
    got = ctx.run(lambda: tfd.flash_ranged_prefill_fp8_distributed(
        qr, sl(kq, ctx.rank), sl(vq, ctx.rank), sl_scale(ks, ctx.rank),
        sl_scale(vs, ctx.rank), pos0, ctx=ctx))
    for g_ in got:
        assert (g_ - want).abs().max().item() <= 2 * _quant_tol(want)
    kb, vb, qb = k.to(torch.bfloat16), v.to(torch.bfloat16), q.to(torch.bfloat16)
    want = tfd._xla_decode(qb, kb, vb, lens, return_lse=False)
    got = tfd.flash_decode_op(qb, kb, vb, lens, ctx=ctx)
    assert (got - want).abs().max().item() <= 1e-3


# ------------------------------------------------ the KV handoff stream ----

from triton_dist_tpu_torch.ops import kv_stream as tkv  # noqa: E402


def _kv_slabs(world, m, w, dtype, device, seed):
    """Each rank's slab (rows over six decades) and its wire forms."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((world * m, w), generator=g, device=device)
    x = (x * torch.logspace(-3, 3, world * m, device=device)[:, None]).to(dtype)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("wire", ["native", "int8", "fp8"])
def test_kv_stream_kernels_are_exact(cuda, world, chunks, wire):
    """K41 (native) and K42 (int8, fp8) at world 2 and 4 with every rank on
    the one card: the landed slab and scales bit-equal to the plain
    exchange (the mirror's rows; a copy), rows of 1 KiB and a 1000-row slab
    whose chunk spans cut pieces off 16-byte boundaries, run twice (the
    flags' epochs rise)."""
    ctx = initialize_distributed(world)
    cfg = tkv.KVStreamConfig(chunks_per_shard=chunks, wire=wire)
    for m, w, dtype in ((1000, 512, torch.bfloat16), (64, 1024, torch.float32)):
        x = _kv_slabs(world, m, w, dtype, cuda, 11 + world + chunks)
        if wire == "native":
            parts = [(x[r * m:(r + 1) * m].contiguous(), None) for r in range(world)]
        else:
            q, s = tkv.quantize_kv_wire_for(wire, x)
            parts = [(q[r * m:(r + 1) * m].contiguous(), s[r * m:(r + 1) * m].contiguous())
                     for r in range(world)]
        for _ in range(2):
            before = (tkv._kv_stream.launches, tkv._kv_stream_w8.launches)
            outs = ctx.run(lambda: tkv.kv_stream(*parts[ctx.rank], ctx=ctx, config=cfg))
            torch.cuda.synchronize()
            after = (tkv._kv_stream.launches, tkv._kv_stream_w8.launches)
            assert after[wire != "native"] - before[wire != "native"] == world
            for r, got in enumerate(outs):
                mirror = parts[tkv.mirror_peer(r, world)]
                if wire == "native":
                    assert torch.equal(got.view(torch.uint8), mirror[0].view(torch.uint8))
                    continue
                assert torch.equal(got[0].view(torch.uint8), mirror[0].view(torch.uint8))
                assert torch.equal(got[1], mirror[1])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_kv_wire_quantizers_on_the_card_equal_the_cpu(cuda, wire):
    """The card's wire payload and scales equal the CPU quantizer's (which
    the CPU tests hold equal to the JAX package's), rows over ten decades,
    an all-zero row included."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((512, 1024), generator=g) * torch.logspace(-6, 4, 512)[:, None]
    x[5] = 0.0
    for src in (x, x.to(torch.bfloat16)):
        (gq, gs), (wq, ws) = (tkv.quantize_kv_wire_for(wire, src.to(cuda)),
                              tkv.quantize_kv_wire_for(wire, src))
        assert torch.equal(gq.cpu().view(torch.uint8), wq.view(torch.uint8))
        assert torch.equal(gs.cpu(), ws)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_kv_stream_stuck_wait_raises_with_its_record(cuda, wire):
    """Rank 1's stream is held for 2 s before its push at world 2: rank 0's
    wait names its first chunk's payload site (world + 0), in the wire's
    family, whatever the chunk count."""
    ctx = initialize_distributed(2)
    cfg = tkv.KVStreamConfig(chunks_per_shard=4, wire=wire)
    x = _kv_slabs(2, 256, 512, torch.bfloat16, cuda, 9)
    if wire == "native":
        parts = [(x[r * 256:(r + 1) * 256].contiguous(), None) for r in range(2)]
    else:
        q, s = tkv.quantize_kv_wire(x)
        parts = [(q[r * 256:(r + 1) * 256].contiguous(), s[r * 256:(r + 1) * 256].contiguous())
                 for r in range(2)]
    ctx.run(lambda: tkv.kv_stream(*parts[ctx.rank], ctx=ctx, config=cfg))

    def body():
        if ctx.rank == 1:
            tcommon.sleep_on_stream(2_000_000_000)
        return tkv.kv_stream(*parts[ctx.rank], ctx=ctx, config=cfg)

    with config.wait_timeout(0.2):
        with pytest.raises(DistTimeoutError) as err:
            ctx.run(body)
    (rec,) = err.value.records
    family = "kv_stream" if wire == "native" else "kv_stream_w8"
    assert (rec["pe"], rec["family"], rec["site"], rec["kind"]) == (
        0, family, 2, "signal_wait_until")
