"""The PyTorch port's flash decode (``triton_dist_tpu_torch/ops/
flash_decode.py``) against the JAX package's ``flash_decode`` and
``paged_flash_decode`` (Pallas kernels in interpret mode, as the JAX tests
run them on the CPU), same numpy inputs: lengths 0 / partial / full, GQA
groups of 1 and 4, a non-power-of-2 head dim, the soft cap, and a shuffled
block table with junk entries past each length; and the sequence-parallel
entries at world 2 and 4 (the port's ranks threads of one CPU
``DistContext``, the JAX side under ``shard_map``). The CUDA kernels are
held against the plain versions in ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_dist_tpu.ops.flash_decode import (
    FlashDecodeConfig as JaxFDConfig,
    _kernel_head_dim as jax_kernel_head_dim,
    combine_partials as jax_combine,
    flash_decode as jax_flash_decode,
    flash_decode_distributed as jax_fd_distributed,
    paged_flash_decode as jax_paged_flash_decode,
    paged_flash_decode_distributed as jax_paged_fd_distributed,
)
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

# f32 caches on both sides; the Pallas kernel's chunked online softmax and
# the plain single-pass softmax differ only in summation order
TOL = 2e-5


def _case(seed, b, hq, h_kv, s, d, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _paginate(rng, k, v, page, lens):
    """Shuffled page pool + block table; entries past each sequence's valid
    pages point at arbitrary in-range pages."""
    b, h_kv, s, d = k.shape
    pps = s // page
    n_pages = b * pps
    table = rng.permutation(n_pages).reshape(b, pps).astype(np.int32)
    kp = np.zeros((n_pages, h_kv, page, d), np.float32)
    vp = np.zeros_like(kp)
    for bi in range(b):
        for ci in range(pps):
            kp[table[bi, ci]] = k[bi, :, ci * page:(ci + 1) * page]
            vp[table[bi, ci]] = v[bi, :, ci * page:(ci + 1) * page]
    junk = rng.integers(0, n_pages, table.shape).astype(np.int32)
    used = np.arange(pps)[None, :] < -(-lens // page)[:, None]
    return kp, vp, np.where(used, table, junk)


def _assert_out_lse(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)


CASES = {
    # name: (b, hq, h_kv, s, d, lens, soft_cap)
    "g4_ragged": (3, 8, 2, 32, 16, [0, 13, 32], 0.0),
    "g1_softcap": (2, 2, 2, 32, 16, [32, 5], 3.0),
    "d24_g4": (2, 4, 1, 32, 24, [17, 0], 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_decode_matches_jax(name):
    b, hq, h_kv, s, d, lens, cap = CASES[name]
    q, k, v, lens = _case(0, b, hq, h_kv, s, d, lens)
    want = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        config=JaxFDConfig(block_s=16, soft_cap=cap), return_lse=True,
    )
    got = tfd.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), config=tfd.FlashDecodeConfig(soft_cap=cap),
        return_lse=True,
    )
    _assert_out_lse(got, want)
    empty = lens == 0
    assert (got[0].numpy()[empty] == 0).all() and np.isneginf(got[1].numpy()[empty]).all()


@pytest.mark.parametrize("name", ["g4_ragged", "g1_softcap"])
def test_paged_flash_decode_matches_jax(name):
    b, hq, h_kv, s, d, lens, cap = CASES[name]
    q, k, v, lens = _case(1, b, hq, h_kv, s, d, lens)
    kp, vp, table = _paginate(np.random.default_rng(2), k, v, 8, lens)
    want = jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table), soft_cap=cap, return_lse=True,
    )
    got = tfd.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(table), soft_cap=cap,
        return_lse=True,
    )
    _assert_out_lse(got, want)
    # the paged pool read through its table is the contiguous cache
    contiguous = tfd.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), config=tfd.FlashDecodeConfig(soft_cap=cap),
        return_lse=True,
    )
    np.testing.assert_array_equal(got[0].numpy(), contiguous[0].numpy())


def test_combine_partials_matches_jax():
    rng = np.random.default_rng(3)
    outs = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    lses = rng.standard_normal((3, 2, 4)).astype(np.float32)
    lses[1, 0, :] = -np.inf      # an empty partial weighs 0
    lses[:, 1, 2] = -np.inf      # every partial empty: output 0
    want = jax_combine(jnp.asarray(outs), jnp.asarray(lses))
    got = tfd.combine_partials(torch.from_numpy(outs), torch.from_numpy(lses))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_head_dim_rule_and_world1_entries():
    for d in (1, 3, 16, 24, 100, 128):
        assert tfd._kernel_head_dim(d) == jax_kernel_head_dim(d)
    q, k, v, lens = (torch.from_numpy(x) for x in _case(4, 2, 4, 2, 16, 8, [3, 16]))
    np.testing.assert_array_equal(
        tfd.flash_decode_distributed(q, k, v, lens).numpy(),
        tfd.flash_decode(q, k, v, lens).numpy(),
    )
    # world 2 (no longer refused): each rank holds half the sequence, and
    # the SP combine of the two partials is the whole-cache decode
    ctx = initialize_distributed(2, device="cpu")

    def rank_half():
        r = ctx.rank
        lens_r = torch.clamp(lens - 8 * r, 0, 8).to(torch.int32)
        return tfd.flash_decode_distributed(
            q, k[:, :, 8 * r:8 * r + 8].contiguous(), v[:, :, 8 * r:8 * r + 8].contiguous(),
            lens_r, ctx=ctx)

    for got in ctx.run(rank_half):
        np.testing.assert_allclose(got.numpy(), tfd.flash_decode(q, k, v, lens).numpy(),
                                   rtol=TOL, atol=TOL)
    table = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    pages = k.reshape(2, 2, 2, 8, 8).transpose(1, 2).reshape(4, 2, 8, 8)
    vpages = v.reshape(2, 2, 2, 8, 8).transpose(1, 2).reshape(4, 2, 8, 8)
    np.testing.assert_array_equal(
        tfd.paged_flash_decode_distributed(q, pages, vpages, lens, table).numpy(),
        tfd.flash_decode(q, k, v, lens).numpy(),
    )


@pytest.mark.parametrize("world", [2, 4])
def test_sp_decode_distributed_matches_jax(world):
    """``flash_decode_distributed`` and ``paged_flash_decode_distributed``
    at world 2 and 4 against the JAX package's under ``shard_map``: each
    rank holds an 8-position sequence shard (contiguous, and as its own page
    pool behind a shuffled block table); sequence 0 fills every shard,
    sequence 1 ends 3 positions into rank 1's, so later ranks hold none of
    it. The partials meet through the full-mesh push allgather and merge."""
    b, hq, h_kv, d, s_loc, page = 2, 4, 2, 8, 8, 4
    pps = s_loc // page
    rng = np.random.default_rng(40 + world)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((world, b, h_kv, s_loc, d)).astype(np.float32)
            for _ in range(2))
    total = np.array([world * s_loc, s_loc + 3])
    lens = np.stack([np.clip(total - r * s_loc, 0, s_loc) for r in range(world)]).astype(np.int32)
    perm = rng.permutation(b * pps)
    table = np.stack([perm.reshape(b, pps)] * world).astype(np.int32)

    def paginate(x):  # [world, b, h_kv, s_loc, d] -> each rank's pool, pages at perm
        pages = x.reshape(world, b, h_kv, pps, page, d).transpose(0, 1, 3, 2, 4, 5)
        pool = np.empty((world, b * pps, h_kv, page, d), np.float32)
        pool[:, perm] = pages.reshape(world, b * pps, h_kv, page, d)
        return pool

    kp, vp = paginate(k), paginate(v)

    def jprogram(q, k, v, lens, kp, vp, table):
        c = jax_fd_distributed(q, k[0], v[0], lens[0], axis="tp",
                               config=JaxFDConfig(block_s=s_loc))
        p = jax_paged_fd_distributed(q, kp[0], vp[0], lens[0], table[0], axis="tp")
        return c[None], p[None]

    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    want_c, want_p = jax.jit(jax.shard_map(
        jprogram, mesh=mesh, in_specs=(P(None),) + (P("tp"),) * 6,
        out_specs=(P("tp"), P("tp")), check_vma=False,
    ))(*(jnp.asarray(x) for x in (q, k, v, lens, kp, vp, table)))
    ctx = initialize_distributed(world, device="cpu")
    tq = torch.from_numpy(q)
    tk, tv, tl, tkp, tvp, tt = (torch.from_numpy(x) for x in (k, v, lens, kp, vp, table))

    def rank():
        r = ctx.rank
        return (tfd.flash_decode_distributed(tq, tk[r], tv[r], tl[r], ctx=ctx),
                tfd.paged_flash_decode_distributed(tq, tkp[r], tvp[r], tl[r], tt[r], ctx=ctx))

    for r, (c, p) in enumerate(ctx.run(rank)):
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c)[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p)[r], rtol=TOL, atol=TOL)


# ------------------------- K2/K3's one-launch span plan (pure, on the host) ----

@pytest.mark.parametrize("lens,page,width,b_hkv,sms", [
    ([1024, 0, 16, 17, 255, 600, 999, 1], 16, 64, (8, 8), 132),   # the served lengths
    ([0, 1, 15, 16, 17, 64, 65, 4096], 16, 256, (8, 2), 132),      # edges and a full table
    ([5, 3, 0], 4, 8, (3, 2), 4),                                  # small pages, few SMs
    ([2000, 9], 64, 40, (2, 1), 132),                              # one page a tile
    # contiguous caches (page None, width = s): K2's served lengths, and an s
    # off the 64-position tile with lengths past it
    ([0, 1, 17, 300, 513, 777, 1000, 1024], None, 1024, (8, 8), 132),
    ([0, 64, 65, 299, 300, 5000], None, 300, (6, 2), 8),
])
def test_onepass_span_plan_matches_brute_force(lens, page, width, b_hkv, sms):
    """The (sequence, span) rows the one-launch kernel computes equal a
    brute-force grouping of every valid position by its span, each position
    exactly once; spans are whole tiles; the grid's span count covers the
    table; no span reaches a page at or past ceil(len / page) (junk). A page
    pool has `width` pages; a contiguous cache of `width` positions is
    ceil(width / 64) "pages" of one 64-position tile."""
    b, h_kv = b_hkv
    if page is None:
        s_len, page, max_pages = width, tfd._TILE, -(-width // tfd._TILE)
    else:
        s_len, max_pages = None, width
    cap = page * max_pages if s_len is None else s_len
    span_pages, splits = tfd._onepass_plan(b, h_kv, page, max_pages, sms)
    assert span_pages % (tfd._TILE // page) == 0 and splits * span_pages >= max_pages
    rows = tfd._onepass_rows(lens, page, max_pages, span_pages, s_len=s_len)
    want = {}
    for bi, n in enumerate(lens):
        for pos in range(min(n, cap)):
            lo, hi = want.get((bi, pos // (span_pages * page)), (pos, pos))
            want[(bi, pos // (span_pages * page))] = (min(lo, pos), max(hi, pos + 1))
    assert {(bi, sp): (p0, p1) for bi, sp, p0, p1 in rows} == want
    assert len(rows) == len(want) and all(sp < splits for _, sp, _, _ in rows)
    for bi, sp, p0, p1 in rows:
        assert p0 < p1 <= min(lens[bi], cap) and (p1 - 1) // page < -(-lens[bi] // page)


@pytest.mark.parametrize("dtype,d,page,g,aligned,engine", [
    (torch.bfloat16, 128, 16, 4, True, "onepass"),
    (torch.bfloat16, 24, 4, 1, True, "onepass"),
    (torch.bfloat16, 256, 64, 16, True, "onepass"),
    (torch.float32, 128, 16, 4, True, "split"),     # f32 pools keep the split kernel
    (torch.bfloat16, 20, 16, 4, True, "split"),     # rows not whole 16-byte chunks
    (torch.bfloat16, 128, 48, 4, True, "split"),    # a page that does not divide 64
    (torch.bfloat16, 128, 16, 4, False, "split"),
    (torch.bfloat16, 96, None, 8, True, "onepass"),  # K2: a contiguous bf16 cache
])
def test_paged_decode_engine_choice(dtype, d, page, g, aligned, engine):
    assert tfd._decode_engine(dtype, d, page, g, aligned) == engine


@pytest.mark.parametrize("dtype,d,paged,aligned,engine", [
    (torch.bfloat16, 128, False, True, "wgmma"),   # K13 on the wgmma + TMA kernel
    (torch.bfloat16, 128, True, True, "mma"),      # K14's page pool keeps mma.sync
    (torch.int8, 128, False, True, "mma"),         # K40: one-byte tiles raised to bf16
    (torch.bfloat16, 20, False, False, "mma"),     # rows not whole 16-byte chunks, unaligned
    (torch.float32, 64, False, True, "fma"),
])
def test_verify_engine_choice(dtype, d, paged, aligned, engine):
    assert tfd._verify_engine(dtype, d, paged, aligned) == engine
