"""The PyTorch port's rank runtime on the CPU, the parts the parity tests
do not reach: the host collectives under many rounds of slot reuse, a
rank that raises, the run guards, the timeout records of the bounded waits
(their layout held to the JAX package's), the launch counters under thread
contention, symmetric views and the method choice off a full mesh.

Everything here is exact: integer-valued f32 sums, copies, counts.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from triton_dist_tpu.resilience import records as jrecords
from triton_dist_tpu.resilience import sites as jsites
from triton_dist_tpu_torch import config
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
from triton_dist_tpu_torch.ops import reduce_scatter as trs
from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
from triton_dist_tpu_torch.resilience import records, sites, watchdog
from triton_dist_tpu_torch.shmem.host import SymmetricTensor
from triton_dist_tpu_torch.utils import count_launch


@pytest.mark.parametrize("world", [2, 4, 8])
def test_host_collectives_under_slot_reuse(world):
    """Every round posts values no other round posts; a rank that read a
    slot before its peers had written it, or after the next round had
    overwritten it, would see another round's values."""
    rounds, rows = 60, 3
    ctx = initialize_distributed(world, device="cpu")

    def rank():
        r, got = ctx.rank, []
        for i in range(rounds):
            x = torch.full((world * rows, 2), float(1000 * i + r))
            got.append((ctx.all_gather(x[:rows], 0), ctx.psum(x), ctx.psum_scatter(x, 0)))
        return got

    outs = ctx.run(rank)
    for r, got in enumerate(outs):
        for i, (gathered, summed, scattered) in enumerate(got):
            want_rows = np.repeat(1000.0 * i + np.arange(world), rows)
            np.testing.assert_array_equal(gathered[:, 0].numpy(), want_rows)
            total = world * 1000.0 * i + world * (world - 1) / 2
            np.testing.assert_array_equal(summed.numpy(), np.full((world * rows, 2), total))
            np.testing.assert_array_equal(scattered.numpy(), np.full((rows, 2), total))


def test_rank_error_reaches_the_caller_and_the_context_refuses():
    ctx = initialize_distributed(4, device="cpu")

    def rank():
        if ctx.rank == 2:
            raise KeyError("rank 2 failed")
        ctx.rendezvous()  # the peers are released, not left waiting
        return ctx.rank

    with pytest.raises(KeyError, match="rank 2 failed"):
        ctx.run(rank)
    with pytest.raises(RuntimeError, match="failed earlier"):
        ctx.run(lambda: ctx.rank)


def test_run_guards():
    ctx = initialize_distributed(2, device="cpu")
    assert ctx.run(lambda: ctx.rank * 10) == [0, 10]
    with pytest.raises(RuntimeError, match="only inside"):
        ctx.rank  # noqa: B018
    with pytest.raises(RuntimeError, match="does not nest"):
        ctx.run(lambda: ctx.run(lambda: 0))
    for world in (0, 9):
        with pytest.raises(ValueError, match="world must be"):
            initialize_distributed(world, device="cpu")
    assert ctx.full_mesh


def test_record_layout_and_kinds_match_the_jax_package():
    for name in ("DIAG_LEN", "F_STATUS", "F_FAMILY", "F_PE", "F_SITE", "F_KIND",
                 "F_EXPECTED", "F_OBSERVED", "F_BUDGET", "STATUS_OK", "STATUS_TIMEOUT"):
        assert getattr(records, name) == getattr(jrecords, name), name
    for code, name in sites.KIND_NAMES.items():
        assert jsites.KIND_NAMES[code] == name
        assert sites.kind_name(code) == jsites.kind_name(code)


@pytest.mark.parametrize("family,site,words", [
    ("barrier", 1, "entry barrier: arrival of rank 1"),
    ("all_gather", 4 + 3, "shard of rank 3"),
    ("ag_gemm", 4 + 2, "shard 2 in the gather workspace"),
    ("gemm_rs", 4 + 0, "landing slot 0"),
])
def test_timeout_record_raises_naming_rank_family_and_site(family, site, words):
    world, rank = 4, 3
    clean = [0] * records.DIAG_LEN
    row = [records.STATUS_TIMEOUT, sites.FAMILIES[family], rank, site, sites.KIND_BARRIER,
           7, 6, 200000]
    watchdog.check([clean] * world, world)  # nothing recorded: no error
    with pytest.raises(records.DistTimeoutError) as err:
        watchdog.check([clean, clean, clean, row], world)
    (rec,) = err.value.records
    assert (rec["pe"], rec["family"], rec["site"], rec["waits_for"]) == (rank, family, site, words)
    assert (rec["expected"], rec["observed"], rec["budget_us"]) == (7, 6, 200000)
    assert f"rank {rank}: {family} barrier_all site {site} ({words})" in str(err.value)


def test_launch_counter_loses_no_update_under_thread_contention():
    def kernel():
        pass

    kernel.launches = 0
    n_threads, per_thread = 16, 2000
    threads = [threading.Thread(target=lambda: [count_launch(kernel) for _ in range(per_thread)])
               for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == n_threads * per_thread


def test_wait_timeout_scope_restores():
    before = config.wait_timeout_s
    with config.wait_timeout(0.25):
        assert config.wait_timeout_ns() == 250_000_000
        assert watchdog.wait_args(torch.zeros(8, dtype=torch.int32), "gemm_rs")[1:] == (
            250_000_000, sites.FAMILIES["gemm_rs"])
    assert config.wait_timeout_s == before


def test_symmetric_views_and_bounds():
    devs = [torch.device("cpu")] * 3
    sym = SymmetricTensor(devs, 64)
    for r in range(3):
        sym.view(r, (2, 4), torch.float32, offset=32).fill_(r)
        assert sym.table[r].tolist() == sym.ptrs
        assert sym.peer_addr(r, 32) == sym.ptrs[r] + 32
    for r in range(3):
        got = sym.view(r, (2, 4), torch.float32, offset=32)
        assert torch.equal(got, torch.full((2, 4), float(r)))
        assert torch.count_nonzero(sym.view(r, (32,), torch.uint8)) == 0
    with pytest.raises(ValueError, match="exceeds 64"):
        sym.view(0, (2, 4), torch.float32, offset=40)


def test_method_choice_off_a_full_mesh_names_the_later_slices():
    """Off a full mesh ``auto`` picks the rings: the ring allgathers
    (``ring_1d`` at two ranks, ``ring_bidir`` beyond; their plain version
    on the CPU) and ``gemm_rs``'s ring (the reduced product)."""
    assert tag.get_auto_all_gather_method(1 << 20, 2, full_mesh=False) == "ring_1d"
    assert tag.get_auto_all_gather_method(1 << 20, 4, full_mesh=False) == "ring_bidir"
    assert trs.get_auto_reduce_scatter_method(1 << 20, 4, full_mesh=False) == "ring"
    ctx = initialize_distributed(2, device="cpu")
    ctx.full_mesh = False
    x = [torch.full((2, 2), float(r)) for r in range(2)]
    calls = tag._all_gather_xla.calls
    for got in ctx.run(lambda: tag.all_gather(x[ctx.rank], ctx=ctx)):
        assert torch.equal(got, torch.cat(x))
    assert tag._all_gather_xla.calls == calls + 2
    ctx = initialize_distributed(2, device="cpu")
    ctx.full_mesh = False
    a = [torch.arange(8.0).reshape(4, 2) + r for r in range(2)]
    b = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    calls = tgrs._gemm_rs_ring_plain.calls
    got = torch.cat(ctx.run(lambda: tgrs.gemm_rs(a[ctx.rank], b, ctx=ctx)))
    assert tgrs._gemm_rs_ring_plain.calls == calls + 2
    assert torch.equal(got, (a[0] + a[1]) @ b)
