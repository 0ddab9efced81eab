"""The PyTorch port's CUDA kernels against their plain PyTorch versions on
the card (GEMM K1, flash decode K2, paged flash decode K3). Every test here
carries the ``cuda`` marker and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.ops import gemm as tgemm


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
