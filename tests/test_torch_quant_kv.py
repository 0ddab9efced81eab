"""The PyTorch port's quantized KV caches against the JAX package on the CPU.

- **Quantizers**: ``quantize_kv``, ``quantize_kv_fp8`` and their page-pool
  twins give bytes and f32 scales equal to the JAX package's (fp8 bytes
  compared through a ``uint8`` view).
- **Kernels' plain versions** (what the CPU runs; the CUDA kernels K38-K40
  are held to them in ``test_torch_cuda_kernels.py``): the int8 and fp8
  contiguous decode, the paged decode (a shuffled block table with junk
  entries past each length), ``flash_verify(scales=)`` in int8 and
  ``flash_verify_fp8``, against the interpreted Pallas kernels on the same
  quantized inputs: lengths 0, partial and full, the soft cap, d = 96.
- **SP entries** at world 2 and 4 (the port's ranks threads of one CPU
  ``DistContext``, the JAX side under ``shard_map``): the int8 and fp8
  decode, the fp8 ranged prefill at world 4, and the host-level
  ``flash_decode_op``.

Tolerances: 1e-5 where the JAX kernel walks the cache in one chunk (the same
f32 products summed in another order, and ``p * v_scale`` rounded to bf16 at
the same max on both sides); where ``block_s`` cuts several chunks the JAX
kernel rounds ``p * v_scale`` to bf16 at each chunk's running max and the
plain version at the row's final max, so single terms may round apart: one
bf16 ulp of the output scale (2^(floor(log2 max|out|) - 7)).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import triton_dist_tpu.ops.flash_decode  # noqa: F401
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

# the JAX package's ops/__init__ re-exports functions under submodule names
jfd = sys.modules["triton_dist_tpu.ops.flash_decode"]

TOL = 1e-5
JAX_QUANTIZERS = {"int8": (jfd.quantize_kv, jfd.quantize_kv_pages),
                  "fp8": (jfd.quantize_kv_fp8, jfd.quantize_kv_pages_fp8)}
PORT_QUANTIZERS = {"int8": (tfd.quantize_kv, tfd.quantize_kv_pages),
                   "fp8": (tfd.quantize_kv_fp8, tfd.quantize_kv_pages_fp8)}


def _to_torch(x):
    """A JAX or numpy array as a torch tensor; fp8 crosses as its bytes."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bits(t):
    """A torch tensor as numpy, one-byte payloads as their bytes."""
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()


def _cache(rng, shape):
    """Cache rows whose magnitudes span three decades across positions, so a
    row scale read at the wrong position shows."""
    x = rng.standard_normal(shape)
    return (x * np.logspace(-1.5, 1.5, shape[-2])[rng.permutation(shape[-2])][:, None]
            ).astype(np.float32)


def _quant_tol(want) -> float:
    """One bf16 ulp of the output scale (see the module docstring)."""
    want = np.asarray(want)
    return 2.0 ** (np.floor(np.log2(np.abs(want[np.isfinite(want)]).max())) - 7)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_out_lse(got, want, tol=TOL):
    _close(got[0].numpy(), want[0], tol)
    lse, wlse = got[1].numpy(), np.asarray(want[1])
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(wlse))
    fin = np.isfinite(wlse)
    _close(lse[fin], wlse[fin], TOL)


def _paginate(rng, x, page, lens):
    """``[b, h_kv, s, e]`` as a shuffled page pool ``[n_pages, h_kv, page,
    e]`` and its block table; entries past each length point at arbitrary
    in-range pages. Scales ride as ``e = 1`` after a transpose."""
    b, h_kv, s, e = x.shape
    pps = s // page
    table = rng.permutation(b * pps).reshape(b, pps)
    pool = np.zeros((b * pps, h_kv, page, e), x.dtype)
    pool[table.reshape(-1)] = x.reshape(b, h_kv, pps, page, e).transpose(0, 2, 1, 3, 4
                                                                          ).reshape(-1, h_kv, page, e)
    junk = rng.integers(0, b * pps, table.shape)
    used = np.arange(pps)[None, :] < -(-lens // page)[:, None]
    return pool, np.where(used, table, junk).astype(np.int32)


@pytest.fixture(scope="module")
def quantized():
    """One seeded cache quantized by the JAX package in each format (the
    inputs every world-1 cell reads), and the port's quantization of it."""
    rng = np.random.default_rng(0)
    k, v = _cache(rng, (3, 2, 64, 96)), _cache(rng, (3, 2, 64, 96))
    out = {}
    for fmt in ("int8", "fp8"):
        jq = JAX_QUANTIZERS[fmt][0](jnp.asarray(k), jnp.asarray(v))
        out[fmt] = dict(jax=jq, port=PORT_QUANTIZERS[fmt][0](torch.from_numpy(k),
                                                             torch.from_numpy(v)),
                        torch=[_to_torch(x) for x in jq])
    return k, v, out


# --------------------------------------------------------------- quantizers


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantizers_match_jax(quantized, fmt):
    """Bytes and scales equal to the JAX package's, contiguous and paged:
    absmax rows over a head dim of 96, rows over three decades, a zero row
    (the 1e-8 floor) and a row at exactly 127 / 448 x its scale."""
    _, _, q = quantized
    for got, want in zip(q[fmt]["port"], q[fmt]["jax"]):
        np.testing.assert_array_equal(_bits(got), np.asarray(want).view(_bits(got).dtype))
        assert got.dtype == _to_torch(want).dtype
    rng = np.random.default_rng(1)
    pages = _cache(rng, (5, 2, 16, 32))
    pages[1, 0, 3] = 0.0
    pages[2, 1, 7] = np.linspace(-1.0, 1.0, 32)
    jq = JAX_QUANTIZERS[fmt][1](jnp.asarray(pages), jnp.asarray(-pages))
    tq = PORT_QUANTIZERS[fmt][1](torch.from_numpy(pages), torch.from_numpy(-pages))
    for got, want in zip(tq, jq):
        np.testing.assert_array_equal(_bits(got), np.asarray(want).view(_bits(got).dtype))
    assert tuple(tq[2].shape) == (5, 2, 1, 16)


# ------------------------------------------------------ world-1 decode/verify

DECODE_CASES = {
    # name: (hq, lens, soft_cap, block_s): cache [3, 2, 64, 96], d = 96
    "g2_lens": (4, [0, 13, 64], 0.0, 64),
    "g1_softcap": (2, [64, 1, 40], 5.0, 64),
    "chunked": (4, [64, 30, 0], 0.0, 16),
}


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_quant_matches_jax(quantized, fmt, name):
    """``flash_decode_quant`` / ``flash_decode_fp8`` (the plain version of
    K38) against the interpreted ``_flash_decode_quant_kernel``."""
    hq, lens, cap, block_s = DECODE_CASES[name]
    _, _, qz = quantized
    q = np.random.default_rng(2).standard_normal((3, hq, 96)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jentry = jfd.flash_decode_quant if fmt == "int8" else jfd.flash_decode_fp8
    want = jentry(jnp.asarray(q), *qz[fmt]["jax"], jnp.asarray(lens),
                  config=jfd.FlashDecodeConfig(block_s=block_s, soft_cap=cap),
                  return_lse=True)
    tentry = tfd.flash_decode_quant if fmt == "int8" else tfd.flash_decode_fp8
    got = tentry(torch.from_numpy(q), *qz[fmt]["torch"], torch.from_numpy(lens),
                 config=tfd.FlashDecodeConfig(soft_cap=cap), return_lse=True)
    _close_out_lse(got, want, TOL if block_s == 64 else _quant_tol(want[0]))
    assert (got[0].numpy()[lens == 0] == 0).all()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_paged_decode_quant_matches_jax(fmt):
    """``paged_flash_decode_quant`` / ``_fp8`` (the plain version of K39)
    over a shuffled pool with junk table entries past each length, against
    the interpreted ``_paged_flash_decode_kernel(quant=True)``; and equal to
    the contiguous entry on the same cache."""
    rng = np.random.default_rng(3)
    b, hq, h_kv, s, d, page = 3, 4, 2, 64, 32, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = _cache(rng, (b, h_kv, s, d)), _cache(rng, (b, h_kv, s, d))
    lens = np.array([s, 0, 21], np.int32)
    kq, vq, ks, vs = (np.asarray(x) for x in JAX_QUANTIZERS[fmt][0](jnp.asarray(k),
                                                                    jnp.asarray(v)))
    kp, table = _paginate(np.random.default_rng(4), kq, page, lens)
    vp, _ = _paginate(np.random.default_rng(4), vq, page, lens)
    ksp, vsp = (_paginate(np.random.default_rng(4), x.transpose(0, 1, 3, 2), page, lens)[0]
                .transpose(0, 1, 3, 2).copy() for x in (ks, vs))
    jentry = jfd.paged_flash_decode_quant if fmt == "int8" else jfd.paged_flash_decode_fp8
    want = jentry(*(jnp.asarray(x) for x in (q, kp, vp, ksp, vsp, lens, table)),
                  soft_cap=3.0, return_lse=True)
    tentry = tfd.paged_flash_decode_quant if fmt == "int8" else tfd.paged_flash_decode_fp8
    got = tentry(*(_to_torch(x) for x in (q, kp, vp, ksp, vsp, lens, table)), soft_cap=3.0,
                 return_lse=True)
    _close_out_lse(got, want)
    contiguous = tfd.flash_decode_quant(*(_to_torch(x) for x in (q, kq, vq, ks, vs, lens)),
                                        config=tfd.FlashDecodeConfig(soft_cap=3.0))
    np.testing.assert_array_equal(got[0].numpy(), contiguous.numpy())


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_verify_quant_matches_jax(quantized, fmt):
    """``flash_verify(scales=)`` (int8) and ``flash_verify_fp8`` (the plain
    version of K40) against the interpreted ``_flash_verify_quant_kernel``
    (``_flash_verify_fused(scales=)``): per-row lengths with an empty and a
    full row, the soft cap, d = 96, groups of 2."""
    _, _, qz = quantized
    rng = np.random.default_rng(5)
    S = 5
    q = rng.standard_normal((3, S, 4, 96)).astype(np.float32)
    lens = rng.integers(1, 65, (3, S)).astype(np.int32)
    lens[0, 0], lens[2, 4] = 0, 64
    cfg = dict(soft_cap=7.0 if fmt == "fp8" else 0.0)
    if fmt == "int8":
        want = jfd._flash_verify_fused(
            jnp.asarray(q), *qz[fmt]["jax"][:2], jnp.asarray(lens),
            cfg=jfd.FlashDecodeConfig(block_s=64, **cfg), return_lse=True, interpret=None,
            scales=qz[fmt]["jax"][2:])
        got = tfd.flash_verify(torch.from_numpy(q), *qz[fmt]["torch"][:2],
                               torch.from_numpy(lens), return_lse=True,
                               scales=qz[fmt]["torch"][2:])
    else:
        want = jfd.flash_verify_fp8(jnp.asarray(q), *qz[fmt]["jax"], jnp.asarray(lens),
                                    config=jfd.FlashDecodeConfig(block_s=64, **cfg),
                                    return_lse=True)
        got = tfd.flash_verify_fp8(torch.from_numpy(q), *qz[fmt]["torch"],
                                   torch.from_numpy(lens),
                                   config=tfd.FlashDecodeConfig(**cfg), return_lse=True)
    _close_out_lse(got, want)
    # each verified row is the single-token decode at its own length
    for i in range(S):
        one = tfd.flash_decode_quant(torch.from_numpy(q[:, i]), *qz[fmt]["torch"],
                                     torch.from_numpy(lens[:, i].copy()),
                                     config=tfd.FlashDecodeConfig(**cfg))
        _close(got[0][:, i].numpy(), one.numpy(), 1e-6)


def test_quant_refusals_and_world1_sp_entries(quantized):
    """``block_s=0`` has no quantized form (the reference's ValueError);
    half a pair of scale pools is refused; at world 1 the SP entries are
    the single-device entries."""
    _, _, qz = quantized
    q = torch.zeros((3, 4, 96))
    lens = torch.tensor([1, 2, 3], dtype=torch.int32)
    args = (q, *qz["int8"]["torch"], lens)
    with pytest.raises(ValueError, match="int8/fp8"):
        tfd.flash_decode_quant(*args, config=tfd.FlashDecodeConfig(block_s=0))
    with pytest.raises(ValueError, match="int8/fp8"):
        tfd.flash_verify_fp8(q[:, None], *qz["fp8"]["torch"], lens[:, None],
                             config=tfd.FlashDecodeConfig(block_s=0))
    with pytest.raises(ValueError, match="both"):
        tfd.paged_flash_decode(q, qz["int8"]["torch"][0], qz["int8"]["torch"][1], lens,
                               torch.zeros((3, 1), dtype=torch.int32),
                               k_scales=qz["int8"]["torch"][2])
    q = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 4, 96)).astype(np.float32))
    args = (q, *qz["fp8"]["torch"], lens)
    np.testing.assert_array_equal(tfd.flash_decode_fp8_distributed(*args).numpy(),
                                  tfd.flash_decode_fp8(*args).numpy())
    np.testing.assert_array_equal(
        tfd.flash_ranged_prefill_fp8_distributed(q[:, None], *qz["fp8"]["torch"],
                                                 np.array([0, 5, 63])).numpy(),
        tfd.flash_verify_fp8(q[:, None], *qz["fp8"]["torch"],
                             torch.tensor([[1], [6], [64]], dtype=torch.int32)).numpy())


# --------------------------------------------------------------- SP entries


def _shard_map(fn, world, n_in, n_rep=1):
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(None),) * n_rep
                                 + (P("tp"),) * (n_in - n_rep),
                                 out_specs=P("tp"), check_vma=False))


def _sp_cache(rng, world, b, h_kv, s_loc, d):
    """Each rank's quantized shard ``[world, ...]`` in both formats (the JAX
    quantizer on the whole cache: rows are quantized one by one, so a shard
    of the quantized cache is the quantized shard)."""
    k, v = _cache(rng, (b, h_kv, world * s_loc, d)), _cache(rng, (b, h_kv, world * s_loc, d))
    out = {}
    for fmt in ("int8", "fp8"):
        kq, vq, ks, vs = (np.asarray(x) for x in JAX_QUANTIZERS[fmt][0](jnp.asarray(k),
                                                                        jnp.asarray(v)))
        out[fmt] = [np.stack(np.split(x, world, axis=ax)) for x, ax in
                    ((kq, 2), (vq, 2), (ks, 3), (vs, 3))]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sp_decode_quant_matches_jax(world):
    """``flash_decode_quant_distributed`` and ``flash_decode_fp8_distributed``
    against the JAX entries under ``shard_map``: sequence 0 fills every
    shard, sequence 1 ends 3 positions into rank 1's (later ranks hold none
    of it, lse -inf there), sequence 2 is empty; the partials meet through
    the full-mesh push allgather (the ring gather at world 4)."""
    b, hq, h_kv, d, s_loc = 3, 4, 2, 32, 16
    rng = np.random.default_rng(40 + world)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    caches = _sp_cache(rng, world, b, h_kv, s_loc, d)
    total = np.array([world * s_loc, s_loc + 3, 0])
    lens = np.stack([np.clip(total - r * s_loc, 0, s_loc) for r in range(world)]
                    ).astype(np.int32)
    method = "ring_bidir" if world == 4 else "full_mesh_push"

    def jprogram(q, lens, i8k, i8v, i8ks, i8vs, f8k, f8v, f8ks, f8vs):
        cfg = jfd.FlashDecodeConfig(block_s=s_loc)
        a = jfd.flash_decode_quant_distributed(q, i8k[0], i8v[0], i8ks[0], i8vs[0], lens[0],
                                               axis="tp", config=cfg)
        f = jfd.flash_decode_fp8_distributed(q, f8k[0], f8v[0], f8ks[0], f8vs[0], lens[0],
                                             axis="tp", config=cfg)
        return jnp.stack([a, f])[None]

    want = np.asarray(_shard_map(jprogram, world, 10)(
        jnp.asarray(q), jnp.asarray(lens), *(jnp.asarray(x) for fmt in ("int8", "fp8")
                                             for x in caches[fmt])))
    ctx = initialize_distributed(world, device="cpu")
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    tc = {fmt: [_to_torch(x) for x in caches[fmt]] for fmt in caches}

    def rank():
        r = ctx.rank
        return [entry(tq, *(x[r] for x in tc[fmt]), tl[r], ctx=ctx, ag_method=method)
                for fmt, entry in (("int8", tfd.flash_decode_quant_distributed),
                                   ("fp8", tfd.flash_decode_fp8_distributed))]

    for r, outs in enumerate(ctx.run(rank)):
        for i, got in enumerate(outs):
            _close(got.numpy(), want[r, i])


def test_ranged_prefill_fp8_matches_jax():
    """``flash_ranged_prefill_fp8_distributed`` at world 4 against the JAX
    entry under ``shard_map``: a range of 6 rows straddling the boundary of
    ranks 1 and 2, a range at the cache's start, and a row parked at the
    cache's end."""
    world, b, S, hq, h_kv, d, s_loc = 4, 3, 6, 4, 2, 32, 8
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, S, hq, d)).astype(np.float32)
    kq, vq, ks, vs = _sp_cache(rng, world, b, h_kv, s_loc, d)["fp8"]
    pos0 = np.array([2 * s_loc - 3, 0, world * s_loc - S], np.int32)

    def jprogram(q, pos0, k, v, ks, vs):
        return jfd.flash_ranged_prefill_fp8_distributed(
            q, k[0], v[0], ks[0], vs[0], pos0, axis="tp",
            config=jfd.FlashDecodeConfig(block_s=s_loc))[None]

    want = np.asarray(_shard_map(jprogram, world, 6, n_rep=2)(
        jnp.asarray(q), jnp.asarray(pos0), *(jnp.asarray(x) for x in (kq, vq, ks, vs))))
    ctx = initialize_distributed(world, device="cpu")
    tc = [_to_torch(x) for x in (kq, vq, ks, vs)]
    got = ctx.run(lambda: tfd.flash_ranged_prefill_fp8_distributed(
        torch.from_numpy(q), *(x[ctx.rank] for x in tc), pos0, ctx=ctx))
    for r, g in enumerate(got):
        _close(g.numpy(), want[r])


def test_flash_decode_op_matches_jax():
    """``flash_decode_op`` (the host-level SP entry: each rank cuts its
    shard and its local lengths from the global ones) at world 4 against the
    JAX package's on a 4-device mesh, f32; and at world 1."""
    b, hq, h_kv, d, s = 3, 8, 2, 16, 64
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h_kv, s, d)).astype(np.float32) for _ in range(2))
    lens = np.array([s, 17, 0], np.int32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    want = np.asarray(jfd.flash_decode_op(*(jnp.asarray(x) for x in (q, k, v, lens)), mesh))
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    _close(tfd.flash_decode_op(*args, ctx=initialize_distributed(4, device="cpu")).numpy(),
           want)
    _close(tfd.flash_decode_op(*args).numpy(), want)
