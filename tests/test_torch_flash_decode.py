"""The PyTorch port's flash decode (``triton_dist_tpu_torch/ops/
flash_decode.py``) against the JAX package's ``flash_decode`` and
``paged_flash_decode`` (Pallas kernels in interpret mode, as the JAX tests
run them on the CPU), same numpy inputs: lengths 0 / partial / full, GQA
groups of 1 and 4, a non-power-of-2 head dim, the soft cap, and a shuffled
block table with junk entries past each length. The CUDA kernels are held
against the plain versions in ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops.flash_decode import (
    FlashDecodeConfig as JaxFDConfig,
    _kernel_head_dim as jax_kernel_head_dim,
    combine_partials as jax_combine,
    flash_decode as jax_flash_decode,
    paged_flash_decode as jax_paged_flash_decode,
)
from triton_dist_tpu_torch.ops import flash_decode as tfd

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
    with pytest.raises(NotImplementedError, match="A3"):
        tfd.flash_decode_distributed(q, k, v, lens, world=2)
    table = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    pages = k.reshape(2, 2, 2, 8, 8).transpose(1, 2).reshape(4, 2, 8, 8)
    vpages = v.reshape(2, 2, 2, 8, 8).transpose(1, 2).reshape(4, 2, 8, 8)
    np.testing.assert_array_equal(
        tfd.paged_flash_decode_distributed(q, pages, vpages, lens, table).numpy(),
        tfd.flash_decode(q, k, v, lens).numpy(),
    )
