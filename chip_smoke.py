#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``triton_dist_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one GPU

Phases, each printed as a JSON line, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. the kernel build (``nvcc``, all sources at once) with its ``-Xptxas -v``
   register / shared-memory / spill report;
3. every kernel at the shapes the served path gives it, held against its
   plain PyTorch version on the same inputs (stated tolerances), timed with
   CUDA events beside its bound, its plain version and one library call;
4. the slice at full width: ``ServingEngine`` serving a Llama-3.1-8B-wide,
   32-layer bf16 model (random seeded weights) with the paged cache and
   bulk prefill — TTFT, tokens/s, peak memory, and the launch counts that
   show the K1 GEMM and K3 paged decode carried it (plain versions: 0);
   then a torch.profiler look at three decode steps (device busy share);
5. the contiguous-cache path (K2 decode) at the same width, 4 layers;
6. parity: f32, 2 layers at full width, greedy tokens of the kernel path on
   the card identical to the plain path (the wrappers' CPU twins);
7. world 4, every rank on the one card (the rank runtime of
   ``parallel/mesh.py``): the barrier K4 (1000 back to back under per-rank
   skew), the full-mesh allgather K5 (bit-exact), AG-GEMM K6 and GEMM-RS K7
   at the per-rank shapes of a 4-way Llama-3.1-70B, each against its plain
   version and timed beside its bound; a stuck wait that must raise with
   its record instead of hanging;
8. ``serve_tp4``: ``ServingEngine`` at world 4 serving a Llama-3.1-70B-wide
   model cut to 8 of its 80 layers (bf16, random seeded weights), paged
   cache, bulk prefill, 8 requests — with the launch counts that show K1,
   K3-K7 carried it (plain versions: 0) — and its prefill logits against
   the world-1 plain-GEMM forward on the same weights;
9. parity at world 4: f32, 2 layers at full 70B width, greedy tokens of the
   kernel path on the card identical to the world-4 plain path (the
   wrappers' CPU twins, the ranks as CPU threads);
10. the MoE kernels at the served Mixtral-8x7B shapes, each against its
   plain version: the grouped GEMM K8 (world-1 prefill of 2048 tokens,
   t_pad 5120: the up-projection and the down-projection with the GELU
   fused), and at world 4 the AG-GroupGEMM K9 and the MoE-Reduce-RS K10
   (512 tokens a rank, F shard 3584), with a stuck K10 wait that must raise;
11. ``serve_moe``: ``ServingEngine`` at world 1 serving Mixtral-8x7B widths
   (8 experts, top-2) cut to 8 of 32 layers, the same traffic as phase 4 —
   launch counts show K8, K1 and K3 carried it — and its bf16 prefill
   logits against the world-1 plain-kernel forward;
12. ``serve_moe_tp4``: the same model at world 4 on the one card (per-rank
   F shard 3584, 8 q / 2 kv heads) — K9, K10, K6, K7, K4, K5, K3 — and its
   logits against the same world-1 plain forward; a torch.profiler look at
   one admission step and three decode steps at both worlds;
13. ``f32_parity_moe``: f32, 2 MoE layers at full width, greedy tokens on the
   card identical to the CPU plain path at world 1 and at world 4;
14. the training kernels, each against its plain version: the grouped-GEMM
   weight gradient K11 at the shapes of the Mixtral backward (t_pad 5120,
   dw_up and dw_down; a world-4 rank's shard on the rank-major layout) and,
   at world 4, the reduce-scatter K12 ([2048, 4096] f32 a rank, and bf16),
   with a stuck K12 wait that must raise;
15. ``train_moe``: ``train_step`` on Mixtral-8x7B widths cut to 8 of 32
   layers (bf16, batch 2 x 1024, SGD): a warm-up and 3 timed steps with
   falling losses, K1, K8 and K11 launched and no plain version, the step-1
   loss against the plain path's, a profiled step; then ``train_moe_tp4``,
   the same at world 4 on the one card (K4, K6-K12);
16. ``train_dense``: Llama-3.1-8B widths, 2 layers, world 1 (K1 forward and
   backward);
17. ``f32_parity_train``: f32, 2 MoE layers at full width, one train step at
   world 1 and at world 4 against the plain path differentiated by PyTorch
   (loss, every gradient shard, every updated parameter).

The line before the last lists every kernel with its readings; the last is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
port beside it, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

# the world-4 rank runtime gives each rank two streams with hardware queues
# of their own; the count is read when the process first touches the card
os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core peak


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph and replayed between two CUDA events, so the host's launch cost
    (Python wrapper, allocation, ctypes) is not what gets measured."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def event_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Time of one call of `fn` between two CUDA events on the current
    stream, without a graph: for the plain versions that cross to the host
    (expert counts), which a CUDA graph cannot hold."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bf16 operations at the
    tensor-core peak or bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Counters:
    """Launch counts of every kernel wrapper and call counts of the plain
    versions, reset just before a main-path run and read just after it."""

    def __init__(self):
        from triton_dist_tpu_torch.ops import allgather, allgather_gemm, common, gemm
        from triton_dist_tpu_torch.ops import flash_decode as fd
        from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
        from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
        from triton_dist_tpu_torch.ops import group_gemm as gg
        from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
        from triton_dist_tpu_torch.ops import reduce_scatter as rs

        self.kernels = {
            "gemm": gemm.matmul,
            "flash_decode": fd.flash_decode,
            "paged_flash_decode": fd.paged_flash_decode,
            "barrier": common.barrier_all_op,
            "all_gather": allgather.all_gather,
            "ag_gemm": allgather_gemm.ag_gemm,
            "gemm_rs": grs.gemm_rs,
            "group_gemm": gg.group_gemm,
            "ag_group_gemm": aggg.ag_group_gemm_overlap,
            "moe_reduce_rs": mrs.moe_reduce_rs_overlap,
            "group_gemm_dw": gg.group_gemm_dw,
            "reduce_scatter": rs.reduce_scatter,
        }
        self.plain = {
            "gemm": gemm._matmul_plain, "decode": fd._xla_decode,
            "barrier": common._barrier_plain, "all_gather": allgather._all_gather_xla,
            "ag_gemm": allgather_gemm._ag_gemm_xla, "gemm_rs": grs._gemm_rs_xla,
            "group_gemm": gg._group_gemm_plain, "ag_group_gemm": aggg._ag_overlap_xla,
            "moe_reduce_rs": mrs._moe_rs_overlap_xla,
            "group_gemm_dw": gg._group_gemm_dw_plain, "reduce_scatter": rs._reduce_scatter_xla,
        }

    def reset(self) -> None:
        for fn in self.kernels.values():
            fn.launches = 0
        for fn in self.plain.values():
            fn.calls = 0

    def read(self) -> dict:
        return {
            "launches": {k: fn.launches for k, fn in self.kernels.items()},
            "plain_calls": {k: fn.calls for k, fn in self.plain.items()},
        }


# ---------------------------------------------------------------- phases ----

def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build() -> None:
    from triton_dist_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    report = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": report})


def phase_gemm() -> dict:
    """K1 on the five projection shapes of one Llama-3.1-8B prefill at
    M = 8 x 256 rows, plus ragged shapes and the f32 route."""
    import torch
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain, matmul

    g = torch.Generator(device="cuda").manual_seed(1)

    def operands(m, n, k, dtype):
        a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        b = (torch.randn((k, n), generator=g, device="cuda") / math.sqrt(k)).to(dtype)
        return a, b

    # ragged edges (both load paths) and the f32 kernel: max |kernel - plain|
    # over max |plain| — f32 products and sums in both, only the order
    # differs, so 1e-4 holds with a wide margin
    for m, n, k, dtype in ((1, 1, 1, torch.bfloat16), (33, 17, 9, torch.bfloat16),
                           (100, 72, 40, torch.bfloat16), (257, 130, 100, torch.bfloat16),
                           (33, 17, 9, torch.float32), (300, 500, 700, torch.float32)):
        a, b = operands(m, n, k, dtype)
        got = matmul(a, b, out_dtype=torch.float32)
        ref = _matmul_plain(a, b, torch.float32)
        rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        if not rel <= 1e-4:
            raise AssertionError(f"gemm {m}x{n}x{k} {dtype}: rel err {rel}")

    m = 8 * 256
    shapes = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    rows, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                           flops=0.0, bytes=0.0)
    worst = 0.0
    for name, (k, n) in shapes.items():
        a, b = operands(m, n, k, torch.bfloat16)
        got, ref = matmul(a, b).float(), _matmul_plain(a, b, torch.bfloat16).float()
        err = (got - ref).abs().max().item()
        # bf16 output: both round an f32 sum to bf16 (2^-8 relative), and the
        # sums differ in order, so a result may land one ulp apart
        tol = 2.0**-7 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"gemm {name}: max abs err {err} > {tol}")
        worst = max(worst, err)
        flops, nbytes = 2.0 * m * n * k, 2.0 * (m * k + k * n + m * n)
        b_ms, _ = bound(flops, nbytes)
        row = dict(
            shape=[m, k, n], max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: matmul(a, b), iters=10),
            plain_ms=cuda_ms(lambda: _matmul_plain(a, b, torch.bfloat16), iters=5),
            library_ms=cuda_ms(lambda: torch.matmul(a, b), iters=10),
            bound_ms=b_ms,
        )
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b, got, ref
    emit({"phase": "kernel", "kernel": "gemm", "per_shape": rows})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="gemm", route="cuda", source="triton_dist_tpu_torch/csrc/gemm.cu",
        replaces="triton_dist_tpu/ops/common.py:523",
        max_abs_err=worst, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=b_ms, bound_by=by, library_ms=total["library_ms"],
        shapes="one layer's four projections + lm_head at M=2048 (summed)",
    )


def _decode_inputs(b, hq, h_kv, d, s, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h_kv, s, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h_kv, s, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def _check_decode(name, got, ref, lens, tol):
    """max |out| and |lse| differences over rows with a cache; rows with
    kv_len == 0 must give out = 0 and lse = -inf exactly."""
    import torch

    (o, l), (ro, rl) = got, ref
    live = (lens > 0)
    empty = ~live
    err = max((o - ro).abs().max().item(), (l[live] - rl[live]).abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    if empty.any() and not (o[empty].abs().max().item() == 0.0
                            and torch.isneginf(l[empty]).all().item()):
        raise AssertionError(f"{name}: kv_len == 0 must give out 0, lse -inf")
    return err


# f32 scores and sums from the same bf16 inputs on both sides; only the
# summation order (split spans, warp reductions) differs
DECODE_TOL = 1e-3


def phase_flash_decode() -> dict:
    """K2 at the served shapes: batch 8, 32 query / 8 kv heads (g = 4),
    d = 128, s_max = 1024, ragged lengths including 0 and s_max."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s = 8, 32, 8, 128, 1024
    lens = torch.tensor([0, 1, 17, 300, 513, 777, 1000, 1024], dtype=torch.int32,
                        device="cuda")
    q, k, v = _decode_inputs(b, hq, h_kv, d, s, torch.bfloat16, seed=2)
    got = fd.flash_decode(q, k, v, lens, return_lse=True)
    ref = fd._xla_decode(q, k, v, lens, return_lse=True)
    err = _check_decode("flash_decode", got, ref, lens, DECODE_TOL)
    cfg_fh = fd.FlashDecodeConfig(fuse_heads=True)
    got_fh = fd.flash_decode(q, k, v, lens, config=cfg_fh, return_lse=True)
    err_fh = _check_decode("flash_decode fuse_heads", got_fh, ref, lens, DECODE_TOL)
    # soft cap, g = 1, a non-power-of-2 head dim, and an f32 cache
    for (bb, qh, kh, dd, ss, dtype, cap) in ((4, 8, 8, 96, 300, torch.bfloat16, 0.0),
                                             (4, 16, 4, 80, 257, torch.float32, 30.0),
                                             (3, 8, 2, 128, 1000, torch.bfloat16, 5.0)):
        l2 = torch.tensor([ss, 0, ss // 3, ss - 1, 1][:bb], dtype=torch.int32, device="cuda")
        q2, k2, v2 = _decode_inputs(bb, qh, kh, dd, ss, dtype, seed=3)
        c2 = fd.FlashDecodeConfig(soft_cap=cap)
        _check_decode(f"flash_decode d={dd} g={qh // kh} cap={cap}",
                      fd.flash_decode(q2, k2, v2, l2, config=c2, return_lse=True),
                      fd._xla_decode(q2, k2, v2, l2, return_lse=True, soft_cap=cap),
                      l2, DECODE_TOL)

    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    n_valid = int(lens.sum().item())
    flops = 4.0 * hq * d * n_valid
    nbytes = 2 * (b * hq * d) + 2 * 2 * n_valid * h_kv * d + 4 * b + 4 * b * hq * (d + 1)
    b_ms, by = bound(flops, nbytes)
    entry = dict(
        name="flash_decode", route="cuda",
        source="triton_dist_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_dist_tpu/ops/flash_decode.py:284",
        max_abs_err=max(err, err_fh),
        ms=cuda_ms(lambda: fd.flash_decode(q, k, v, lens, return_lse=True), iters=50),
        plain_ms=cuda_ms(lambda: fd._xla_decode(q, k, v, lens, return_lse=True), iters=20),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True), iters=50),
        shapes=f"b={b} hq={hq} h_kv={h_kv} d={d} s_max={s} lens={lens.tolist()}",
    )
    emit({"phase": "kernel", "kernel": "flash_decode", "fuse_heads_err": err_fh,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "shapes")}})
    return entry


def phase_paged_flash_decode() -> dict:
    """K3 at the served shapes: the engine's pool of 16-token pages, a
    shuffled block table, junk (in-range) entries past each length."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s, page = 8, 32, 8, 128, 1024, 16
    pps = s // page
    g = torch.Generator(device="cuda").manual_seed(4)
    lens = torch.tensor([1024, 0, 16, 17, 255, 600, 999, 1], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
    kp = torch.randn((b * pps, h_kv, page, d), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((b * pps, h_kv, page, d), generator=g, device="cuda").to(torch.bfloat16)
    table = torch.randperm(b * pps, generator=g, device="cuda").reshape(b, pps)
    junk = torch.randint(0, b * pps, (b, pps), generator=g, device="cuda")
    used = torch.arange(pps, device="cuda")[None, :] < ((lens + page - 1) // page)[:, None]
    table = torch.where(used, table, junk).to(torch.int32).contiguous()
    got = fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True)
    ref = fd._xla_paged_decode(q, kp, vp, lens, table, return_lse=True)
    err = _check_decode("paged_flash_decode", got, ref, lens, DECODE_TOL)

    kc, vc = fd._paged_to_contiguous(kp, table), fd._paged_to_contiguous(vp, table)
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    n_valid = int(lens.sum().item())
    flops = 4.0 * hq * d * n_valid
    pages_read = int(((lens + page - 1) // page).sum().item())
    nbytes = (2 * b * hq * d + 2 * 2 * n_valid * h_kv * d + 4 * b + 4 * pages_read
              + 4 * b * hq * (d + 1))
    b_ms, by = bound(flops, nbytes)
    entry = dict(
        name="paged_flash_decode", route="cuda",
        source="triton_dist_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_dist_tpu/ops/flash_decode.py:1414",
        max_abs_err=err,
        ms=cuda_ms(lambda: fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True),
                   iters=50),
        plain_ms=cuda_ms(lambda: fd._xla_paged_decode(q, kp, vp, lens, table,
                                                      return_lse=True), iters=20),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, enable_gqa=True), iters=50),
        shapes=f"b={b} hq={hq} h_kv={h_kv} d={d} page={page} pages/seq={pps} "
               f"lens={lens.tolist()}",
    )
    emit({"phase": "kernel", "kernel": "paged_flash_decode",
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "shapes")}})
    return entry


def _requests(vocab, lengths, max_new, seed):
    import numpy as np
    from triton_dist_tpu_torch.models.decode import Request

    rng = np.random.default_rng(seed)
    return [
        Request([int(t) for t in rng.integers(0, vocab, n)], max_new_tokens=max_new,
                uid=f"r{i}")
        for i, n in enumerate(lengths)
    ]


def phase_serve(counters: Counters) -> dict:
    """The slice at full width: Llama-3.1-8B shapes, 32 layers, bf16, batch
    8, paged cache (16-token pages), bulk prefill, 8 requests."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import (
        TPTransformer, init_params,
    )
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain
    from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine

    cfg = presets.preset("llama-3.1-8b", n_layers=32, batch=8, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    s_max, max_new = 1024, 32
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, max_new, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, s_max=s_max, page_size=16, prefill=True,
                        serving=ServingConfig(max_queue=64))
    counters.reset()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    if sorted(done) != sorted(r.uid for r in reqs):
        raise AssertionError(f"serve finished {sorted(done)}")
    for uid, res in done.items():
        if len(res.tokens) != max_new or not all(0 <= t < cfg.vocab for t in res.tokens):
            raise AssertionError(f"{uid}: bad tokens {res.tokens}")
    launches, plain = counts["launches"], counts["plain_calls"]
    if launches["gemm"] <= 0 or launches["paged_flash_decode"] <= 0:
        raise AssertionError(f"served path skipped a kernel: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    n_tok = sum(len(r.tokens) for r in done.values())
    ttft = sorted(r.ttft_ms for r in done.values())
    snap = eng.snapshot()
    emit({"phase": "serve_paged", "model": "llama-3.1-8b", "n_layers": 32,
          "batch": 8, "s_max": s_max, "page_size": 16, "prompt_lens": lengths,
          "max_new_tokens": max_new, "wall_s": wall, "tokens": n_tok,
          "tokens_per_s": n_tok / wall, "ttft_ms": ttft,
          "decode_steps": snap["requests"]["steps"],
          "peak_mem_gb": peak / 1e9, **counts})

    # prefill last-row logits of the kernel path against the plain-GEMM
    # forward on the same card, same weights, same prompts (bf16)
    L = 128
    tokens = torch.zeros((cfg.batch, L), dtype=torch.long, device="cuda")
    for i, r in enumerate(reqs):
        n = min(L, len(r.prompt))
        tokens[i, :n] = torch.tensor(r.prompt[:n])

    class PlainTransformer(TPTransformer):
        def _col(self, x, w):
            return _matmul_plain(x, w, x.dtype)

        _row = _col

    pcfg = dataclasses.replace(cfg, seq=L)
    rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
    with torch.inference_mode():
        got = TPTransformer(pcfg)(tokens.reshape(-1), params)[rows].float()
        ref = PlainTransformer(pcfg)(tokens.reshape(-1), params)[rows].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    # bf16 rounds each of the ~7 stored activations per layer at 2^-9
    # relative; 32 layers of such roundings in two summation orders drift
    # by a few percent of the logit scale at most
    if not (torch.isfinite(got).all().item() and rel <= 5e-2):
        raise AssertionError(f"prefill logits vs plain: rel L2 err {rel}")
    emit({"phase": "serve_paged_logits", "rows": cfg.batch, "prompt_len": L,
          "rel_l2_err": rel, "max_abs_err": (got - ref).abs().max().item(),
          "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
          "tol_rel_l2": 5e-2})
    phase_decode_profile(cfg, params)
    return launches


def phase_decode_profile(cfg, params) -> None:
    """Where a full-depth decode step's time goes: torch.profiler over three
    steady decode steps of the paged batcher (8 requests, 64-token
    prompts): device busy time per step against the median wall time of
    eight unprofiled steps, kernel launches per step, and the kernels that
    took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher

    batcher = ContinuousBatcher(cfg, params, s_max=1024, page_size=16, prefill=True)
    for r in _requests(cfg.vocab, [64] * cfg.batch, 24, seed=8):
        batcher.submit(r)
    for _ in range(3):  # admission + warm decode steps
        batcher.step()
    walls = []
    for _ in range(8):  # host wall time per step, profiler off
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batcher.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "decode_profile", "steps": steps, "step_wall_ms_median": wall_ms,
          "step_wall_ms_min_max": [min(walls), max(walls)],
          "device_busy_ms_per_step": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
          "kernel_launches_per_step": launches,
          "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                      for e in top}})


def phase_contiguous(counters: Counters) -> dict:
    """The contiguous cache (K2 decode) at full width, 4 layers."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_params

    cfg = presets.preset("llama-3.1-8b", n_layers=4, batch=8, dtype=torch.bfloat16)
    params = init_params(cfg, seed=1)
    batcher = ContinuousBatcher(cfg, params, s_max=1024, prefill=True)
    reqs = _requests(cfg.vocab, [16, 40, 64, 90, 128, 33, 77, 120], 16, seed=6)
    counters.reset()
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    done = dict(batcher.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    launches, plain = counts["launches"], counts["plain_calls"]
    if len(done) != len(reqs) or any(len(t) != 16 for t in done.values()):
        raise AssertionError("contiguous serve did not finish every request")
    if launches["flash_decode"] <= 0 or launches["gemm"] <= 0 or any(plain.values()):
        raise AssertionError(f"contiguous path: {counts}")
    emit({"phase": "serve_contiguous", "n_layers": 4, "wall_s": wall,
          "tokens": sum(len(t) for t in done.values()), **counts})
    return launches


def phase_f32_parity() -> None:
    """f32, 2 layers at full width: greedy tokens of the kernel path (card,
    paged and contiguous) identical to the plain path (the wrappers' CPU
    twins), TF32 off on the card."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset("llama-3.1-8b", n_layers=2, batch=4, dtype=torch.float32)
    params = init_params(cfg, seed=2)
    params_cpu = {
        "embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
        "lm_head": params["lm_head"].cpu(),
        "layers": [{k: v.cpu() for k, v in p.items()} for p in params["layers"]],
    }
    lengths, max_new = [12, 20, 33, 40], 8

    def run(p, device, **kw):
        b = ContinuousBatcher(cfg, p, s_max=256, prefill=True, device=device, **kw)
        for r in _requests(cfg.vocab, lengths, max_new, seed=7):
            b.submit(r)
        return dict(b.run())

    t0 = time.perf_counter()
    want = run(params_cpu, "cpu", page_size=16)
    t_cpu = time.perf_counter() - t0
    for kw in (dict(page_size=16), dict()):
        got = run(params, "cuda", **kw)
        if got != want:
            raise AssertionError(f"f32 greedy tokens differ ({kw}): {got} vs {want}")
    emit({"phase": "f32_parity", "n_layers": 2, "requests": len(lengths),
          "max_new_tokens": max_new, "identical": True, "cpu_reference_s": t_cpu})


# --------------------------------------------------- world 4 on one card ----

WORLD = 4
TP_MODEL = "llama-3.1-70b"


def dist_ms(ctx, fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of `fn` on every rank at once: CUDA events
    on each rank's stream around `iters` calls, the slowest rank's span
    over `iters`. The ranks' kernels wait on each other through device
    flags and the host meets them between a signal and its wait, so this
    is a time per call with the host's rendezvous in it (no CUDA graph can
    hold the ranks' cross-stream waits)."""
    import torch

    ctx.run(lambda: [fn() for _ in range(warmup)])

    def body():
        stream = torch.cuda.current_stream()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        for _ in range(iters):
            fn()
        t1.record(stream)
        return t0, t1

    spans = ctx.run(body)
    return max(t0.elapsed_time(t1) for t0, t1 in spans) / iters


def host_ms(ctx, fn, iters: int) -> float:
    """Host time of one call of `fn` on every rank (for the plain barrier,
    which is a host rendezvous)."""
    ctx.run(fn)
    t0 = time.perf_counter()
    ctx.run(lambda: [fn() for _ in range(iters)])
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_barrier(ctx) -> dict:
    """K4: 1000 back-to-back barriers, every rank's stream held for a
    rank- and round-dependent 0-6 µs of device time before each, no wait
    may expire; then the time of one barrier with no skew."""
    from triton_dist_tpu_torch.ops import common

    def stress():
        for i in range(1000):
            common.sleep_on_stream(((ctx.rank * 7 + i) % WORLD) * 2000)
            common.barrier_all_op(ctx)

    t0 = time.perf_counter()
    ctx.run(stress)  # raises DistTimeoutError if any wait expired
    stress_s = time.perf_counter() - t0
    nbytes = 2.0 * WORLD * WORLD * 4  # each flag written once, read once
    b_ms, by = bound(0.0, nbytes)
    entry = dict(
        name="barrier", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/common.py:918",
        max_abs_err=0.0,
        ms=dist_ms(ctx, lambda: common.barrier_all_op(ctx), iters=100),
        plain_ms=host_ms(ctx, lambda: common._barrier_plain(ctx), iters=100),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        shapes=f"world {WORLD} on one card, int32[{WORLD}] epoch flags",
    )
    emit({"phase": "kernel", "kernel": "barrier", "stress_barriers": 1000,
          "stress_s": stress_s, "timeouts": 0,
          **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "shapes")}})
    return entry


def phase_all_gather(ctx) -> dict:
    """K5 at the SP combine's payload of the world-4 decode: [b*hq +
    ceil(b*hq/d), d] f32 = [516, 128] a rank (b 8, hq 64, d 128);
    bit-exact against torch.cat of the ranks' shards."""
    import torch
    from triton_dist_tpu_torch.ops import allgather

    g = torch.Generator(device="cuda").manual_seed(11)
    rows, d = 8 * 64 + math.ceil(8 * 64 / 128), 128
    shards = [torch.randn((rows, d), generator=g, device="cuda") for _ in range(WORLD)]
    want = torch.cat(shards)
    for got in ctx.run(lambda: allgather.all_gather(shards[ctx.rank], ctx=ctx)):
        if not torch.equal(got, want):
            raise AssertionError("all_gather: not bit-exact")
    nbytes = WORLD * (rows * d * 4) * (1 + WORLD)
    b_ms, by = bound(0.0, nbytes)
    entry = dict(
        name="all_gather", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/allgather.py:258", max_abs_err=0.0,
        ms=dist_ms(ctx, lambda: allgather.all_gather(shards[ctx.rank], ctx=ctx), iters=50),
        plain_ms=dist_ms(ctx, lambda: allgather._all_gather_xla(shards[ctx.rank], ctx), iters=50),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(lambda: [torch.cat(shards) for _ in range(WORLD)], iters=20),
        shapes=f"world {WORLD}, [{rows}, {d}] f32 a rank",
    )
    emit({"phase": "kernel", "kernel": "all_gather",
          **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "shapes")}})
    return entry


def _check_bf16(name, got, ref, factor=1.0):
    """bf16 output: one bf16 ulp of the output scale (both round an f32
    sum once, in another order); `factor` 2 where the kernel also rounds
    each peer's partial to bf16 before its f32 epilogue adds it."""
    err = (got.float() - ref.float()).abs().max().item()
    tol = factor * 2.0**-7 * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err, tol


def phase_ag_gemm(ctx) -> dict:
    """K6 at the per-rank shapes of a 4-way Llama-3.1-70B prefill (8
    sequences x 256 tokens = 2048 rows, 512 a rank): the column
    projections wqkv (n_loc 2560), gate/up (14336) and the LM head (32064)."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_gemm, gemm

    g = torch.Generator(device="cuda").manual_seed(12)
    m_loc, k = 512, 8192
    rows, worst, total = [], 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                                       bytes=0.0)
    for name, n_loc in (("wqkv", 2560), ("gate_up", 14336), ("lm_head", 32064)):
        a = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16()
             for _ in range(WORLD)]
        b = [(torch.randn((k, n_loc), generator=g, device="cuda") / k**0.5).bfloat16()
             for _ in range(WORLD)]
        a_full = torch.cat(a)
        outs = ctx.run(lambda: allgather_gemm.ag_gemm(a[ctx.rank], b[ctx.rank], ctx=ctx))
        errs = [_check_bf16(f"ag_gemm {name} rank {r}", out,
                            gemm._matmul_plain(a_full, b[r], torch.bfloat16))
                for r, out in enumerate(outs)]
        err, tol = max(errs)
        worst = max(worst, err)
        flops = WORLD * 2.0 * WORLD * m_loc * k * n_loc
        nbytes = 2.0 * (WORLD * m_loc * k + WORLD * k * n_loc + WORLD * WORLD * m_loc * n_loc)
        row = dict(
            shape=[m_loc, k, n_loc], max_abs_err=err, tol=tol,
            ms=dist_ms(ctx, lambda: allgather_gemm.ag_gemm(a[ctx.rank], b[ctx.rank], ctx=ctx),
                       iters=5),
            plain_ms=dist_ms(ctx, lambda: gemm._matmul_plain(torch.cat(a), b[ctx.rank],
                                                             torch.bfloat16), iters=2),
            library_ms=cuda_ms(lambda: [torch.matmul(torch.cat(a), b[r]) for r in range(WORLD)],
                               iters=3),
            bound_ms=bound(flops, nbytes)[0],
        )
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b, a_full, outs
    emit({"phase": "kernel", "kernel": "ag_gemm", "world": WORLD, "per_shape": rows})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="ag_gemm", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/allgather_gemm.py:69", max_abs_err=worst,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"],
        shapes=f"world {WORLD}: a [512, 8192] a rank; n_loc 2560, 14336, 32064 (summed)",
    )


def phase_gemm_rs(ctx) -> dict:
    """K7 at the per-rank shapes of a 4-way Llama-3.1-70B prefill (2048
    rows): the row projections wo (k_loc 2048) and down (7168), N 8192."""
    import torch
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs

    g = torch.Generator(device="cuda").manual_seed(13)
    m_tot, n = 2048, 8192
    m_loc = m_tot // WORLD
    rows, worst, total = [], 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                                       bytes=0.0)
    for name, k_loc in (("wo", 2048), ("down", 7168)):
        a = [torch.randn((m_tot, k_loc), generator=g, device="cuda").bfloat16()
             for _ in range(WORLD)]
        b = [(torch.randn((k_loc, n), generator=g, device="cuda") / (WORLD * k_loc)**0.5)
             .bfloat16() for _ in range(WORLD)]

        def plain():
            # f32 product per rank, summed over ranks, split
            return sum(a[r].float() @ b[r].float() for r in range(WORLD)).bfloat16()

        full = plain()
        outs = ctx.run(lambda: grs.gemm_rs(a[ctx.rank], b[ctx.rank], ctx=ctx))
        errs = [_check_bf16(f"gemm_rs {name} rank {r}", out, full[r * m_loc:(r + 1) * m_loc],
                            factor=2.0)
                for r, out in enumerate(outs)]
        err, tol = max(errs)
        worst = max(worst, err)
        flops = WORLD * 2.0 * m_tot * k_loc * n
        nbytes = 2.0 * (WORLD * m_tot * k_loc + WORLD * k_loc * n + m_tot * n)
        row = dict(
            shape=[m_tot, k_loc, n], max_abs_err=err, tol=tol,
            ms=dist_ms(ctx, lambda: grs.gemm_rs(a[ctx.rank], b[ctx.rank], ctx=ctx), iters=5),
            plain_ms=cuda_ms(plain, iters=2),
            library_ms=cuda_ms(lambda: sum(torch.matmul(a[r], b[r]) for r in range(WORLD)),
                               iters=3),
            bound_ms=bound(flops, nbytes)[0],
        )
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b, full, outs
    emit({"phase": "kernel", "kernel": "gemm_rs", "world": WORLD, "per_shape": rows})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="gemm_rs", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/gemm_reduce_scatter.py:99", max_abs_err=worst,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"],
        shapes=f"world {WORLD}: a [2048, k_loc] a rank, k_loc 2048 and 7168, N 8192 (summed)",
    )


def phase_stuck_wait() -> None:
    """A peer that arrives far too late: rank 1's stream is held 2 s before
    its barrier arrival, the wait timeout is 0.2 s. The run must raise
    with a record naming rank 0, the barrier and site 1 — not hang."""
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(2)
    ctx.run(lambda: common.barrier_all_op(ctx))

    def body():
        if ctx.rank == 1:
            common.sleep_on_stream(2_000_000_000)
        common.barrier_all_op(ctx)

    t0 = time.perf_counter()
    try:
        with config.wait_timeout(0.2):
            ctx.run(body)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck wait did not raise")
    if [(r["pe"], r["family"], r["site"]) for r in recs] != [(0, "barrier", 1)]:
        raise AssertionError(f"stuck wait: unexpected records {recs}")
    emit({"phase": "stuck_wait", "raised_after_s": time.perf_counter() - t0,
          "records": recs})
    ctx.close()


def phase_serve_tp4(counters: Counters) -> dict:
    """World 4 on one card: Llama-3.1-70B widths (hidden 8192, ffn 28672,
    64 q / 8 kv heads, head dim 128, vocab 128256) cut to 8 of 80 layers,
    bf16, batch 8, s_max 1024 (256 positions a rank), 16-token pages, bulk
    prefill, 8 requests of 32-256 prompt tokens and 32 new tokens."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import (
        TPTransformer, init_params, shard_params,
    )
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine

    n_layers, s_max, max_new = 8, 1024, 32
    cfg = presets.preset(TP_MODEL, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
    params = init_params(cfg, seed=10)
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, max_new, seed=15)
    ctx = initialize_distributed(WORLD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, s_max=s_max, page_size=16, prefill=True, ctx=ctx,
                        serving=ServingConfig(max_queue=64))
    counters.reset()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    if sorted(done) != sorted(r.uid for r in reqs):
        raise AssertionError(f"serve_tp4 finished {sorted(done)}")
    for uid, res in done.items():
        if len(res.tokens) != max_new or not all(0 <= t < cfg.vocab for t in res.tokens):
            raise AssertionError(f"{uid}: bad tokens {res.tokens}")
    launches, plain = counts["launches"], counts["plain_calls"]
    used = ("gemm", "ag_gemm", "gemm_rs", "all_gather", "paged_flash_decode", "barrier")
    if any(launches[k] <= 0 for k in used):
        raise AssertionError(f"serve_tp4 skipped a kernel: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    n_tok = sum(len(r.tokens) for r in done.values())
    snap = eng.snapshot()
    emit({"phase": "serve_tp4", "model": TP_MODEL, "n_layers": n_layers, "world": WORLD,
          "world_size": snap["engine"]["world_size"], "batch": 8, "s_max": s_max,
          "page_size": 16, "prompt_lens": lengths, "max_new_tokens": max_new,
          "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
          "ttft_ms": sorted(r.ttft_ms for r in done.values()),
          "decode_steps": snap["requests"]["steps"], "peak_mem_gb": peak / 1e9, **counts})
    del eng

    # prefill last-row logits at world 4 (K6/K7) against the world-1
    # plain-GEMM forward on the same card, same weights, same prompts (bf16)
    L = 128
    tokens = torch.zeros((cfg.batch, L), dtype=torch.long, device="cuda")
    for i, r in enumerate(reqs):
        n = min(L, len(r.prompt))
        tokens[i, :n] = torch.tensor(r.prompt[:n])
    pcfg = dataclasses.replace(cfg, seq=L)
    flat = tokens.reshape(-1)
    rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
    shards = shard_params(params, WORLD, ctx.devices)
    m_loc = flat.numel() // WORLD

    def rank_logits():
        r = ctx.rank
        out = TPTransformer(pcfg, ctx=ctx)(flat[r * m_loc:(r + 1) * m_loc], shards[r])
        return out[rows].float()

    got = torch.cat(ctx.run(rank_logits), dim=1)
    del shards

    class PlainTransformer(TPTransformer):
        def _col(self, x, w):
            return _matmul_plain(x, w, x.dtype)

        _row = _col

    with torch.inference_mode():
        ref = PlainTransformer(pcfg)(flat, params)[rows].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    # bf16 rounds each of the ~7 stored activations per layer at 2^-9
    # relative, in two summation orders (and K7 rounds each rank's partial)
    if not (torch.isfinite(got).all().item() and rel <= 5e-2):
        raise AssertionError(f"world-4 prefill logits vs world-1 plain: rel L2 err {rel}")
    emit({"phase": "serve_tp4_logits", "rows": cfg.batch, "prompt_len": L,
          "rel_l2_err": rel, "max_abs_err": (got - ref).abs().max().item(),
          "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
          "tol_rel_l2": 5e-2, "reference": "world 1, plain GEMMs"})
    phase_decode_profile_tp4(cfg, params, ctx)
    ctx.close()
    return launches


def phase_decode_profile_tp4(cfg, params, ctx) -> None:
    """Where a world-4 decode step's time goes: host wall per step (eight
    steps, profiler off), torch.profiler over three steps (kernel time
    summed over the four ranks' streams, launches per step, top kernels),
    and the cost of one bare host rendezvous of the four rank threads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher

    batcher = ContinuousBatcher(cfg, params, s_max=1024, page_size=16, prefill=True, ctx=ctx)
    for r in _requests(cfg.vocab, [64] * cfg.batch, 24, seed=18):
        batcher.submit(r)
    for _ in range(3):  # admission + warm decode steps
        batcher.step()
    walls = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batcher.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    n = 200
    t0 = time.perf_counter()
    ctx.run(lambda: [ctx.rendezvous() for _ in range(n)])
    rendezvous_us = (time.perf_counter() - t0) * 1e6 / n
    emit({"phase": "decode_profile_tp4", "world": WORLD, "steps": steps,
          "step_wall_ms_median": wall_ms, "step_wall_ms_min_max": [min(walls), max(walls)],
          "kernel_ms_per_step_all_ranks": busy_ms,
          "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
          "rendezvous_us": rendezvous_us,
          "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                      for e in top}})
    del batcher


def phase_f32_parity_tp4() -> None:
    """f32, 2 layers at full 70B width, world 4: greedy tokens of the kernel
    path on the card (K6/K7 f32 engines, K3, K5) identical to the world-4
    plain path (the wrappers' CPU twins, ranks as CPU threads)."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(TP_MODEL, n_layers=2, batch=4, dtype=torch.float32)
    params = init_params(cfg, seed=3)
    params_cpu = {
        "embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
        "lm_head": params["lm_head"].cpu(),
        "layers": [{k: v.cpu() for k, v in p.items()} for p in params["layers"]],
    }
    lengths, max_new = [12, 20, 33, 40], 8

    def run(p, device):
        ctx = initialize_distributed(WORLD, device=device)
        b = ContinuousBatcher(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                              ctx=ctx)
        for r in _requests(cfg.vocab, lengths, max_new, seed=17):
            b.submit(r)
        out = dict(b.run())
        ctx.close()
        return out

    t0 = time.perf_counter()
    want = run(params_cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    del params_cpu
    t0 = time.perf_counter()
    got = run(params, "cuda")
    t_card = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"world-4 f32 greedy tokens differ: {got} vs {want}")
    emit({"phase": "f32_parity_tp4", "model": TP_MODEL, "n_layers": 2, "world": WORLD,
          "requests": len(lengths), "max_new_tokens": max_new, "identical": True,
          "cpu_reference_s": t_cpu, "card_s": t_card})


# ------------------------------------------------------------ MoE (slice 3) ----

MOE_MODEL = "mixtral-8x7b"
MOE_BLOCK = 128  # the alignment block = the grouped GEMMs' M tile


def _moe_route(gen, tokens, n_exp, topk):
    """Top-k routing of random router logits (the port's select_experts)."""
    import torch
    from triton_dist_tpu_torch.ops.moe_utils import select_experts

    return select_experts(torch.randn((tokens, n_exp), generator=gen, device="cuda"), topk)


def _grouped_mm_library(a, b, expert_ids, act, out_dtype):
    """One library call for the grouped GEMM over expert-sorted row blocks
    (nondecreasing `expert_ids`): ``torch._grouped_mm`` with the experts' row
    offsets where this torch has it for bf16, else a ``torch.matmul`` per
    expert's run of rows. Returns ``(fn, name)``; the offsets are computed
    once, outside the timed call."""
    import torch

    n_exp = b.shape[0]
    bm = a.shape[0] // expert_ids.numel()
    counts = torch.bincount(expert_ids.long(), minlength=n_exp) * bm
    offs = torch.cumsum(counts, 0).to(torch.int32)

    def act_a():
        return a if act is None else act(a.float()).to(a.dtype)

    tries = (
        ("torch._grouped_mm", lambda: torch._grouped_mm(act_a(), b, offs=offs,
                                                        out_dtype=out_dtype)),
        ("torch._grouped_mm (then a cast)",
         lambda: torch._grouped_mm(act_a(), b, offs=offs).to(out_dtype)),
    )
    for name, fn in tries:
        try:
            fn()
            torch.cuda.synchronize()
            return fn, name
        except Exception:  # noqa: BLE001 — this torch lacks it: next candidate
            continue
    ends = offs.tolist()

    def per_expert():
        x = act_a()
        return torch.cat([torch.matmul(x[lo:hi], b[e]).to(out_dtype)
                          for e, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)) if hi > lo])

    return per_expert, "torch.matmul per expert"


def phase_group_gemm() -> dict:
    """K8 at the world-1 MoE prefill shapes: 2048 tokens (8 x 256) routed
    top-2 over 8 experts, t_pad 5120 rows: the up-projection [5120, 4096] x
    [8, 4096, 14336] and the down-projection with the GELU fused [5120,
    14336] x [8, 14336, 4096] to f32; first a few ragged shapes and the f32
    engine."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(21)
    n_exp, topk, bm = 8, 2, MOE_BLOCK
    bf16, f32 = torch.bfloat16, torch.float32
    for tokens, k, n, dtype, out_dtype, act in ((7, 72, 40, bf16, bf16, gg.gelu),
                                                (100, 256, 300, f32, f32, gg.gelu),
                                                (33, 128, 520, bf16, f32, None)):
        _, ids = _moe_route(g, tokens, n_exp, topk)
        al = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
        a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g, device="cuda").to(dtype)
        b = (torch.randn((n_exp, k, n), generator=g, device="cuda") / k**0.5).to(dtype)
        got = gg.group_gemm(a, b, al.expert_ids, out_dtype=out_dtype, act_fn=act)
        ref = gg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act)
        if dtype == bf16:
            _check_bf16(f"group_gemm {tokens}x{k}x{n}", got, ref)
        elif not (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item():
            raise AssertionError(f"group_gemm f32 {tokens}x{k}x{n}")

    tokens = 8 * 256
    _, ids = _moe_route(g, tokens, n_exp, topk)
    al = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
    t_pad = al.sorted_token_ids.shape[0]
    used = int((torch.bincount(ids.reshape(-1).long(), minlength=n_exp) > 0).sum().item())
    rows, worst = [], 0.0
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    libs = set()
    for name, (k, n, act, out_dtype) in {"up": (4096, 14336, None, bf16),
                                         "down_gelu": (14336, 4096, gg.gelu, f32)}.items():
        a = torch.randn((t_pad, k), generator=g, device="cuda").to(bf16)
        b = (torch.randn((n_exp, k, n), generator=g, device="cuda") / k**0.5).to(bf16)
        got = gg.group_gemm(a, b, al.expert_ids, out_dtype=out_dtype, act_fn=act)
        ref = gg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act)
        err, tol = _check_bf16(f"group_gemm {name}", got, ref)
        worst = max(worst, err)
        del got, ref
        flops = 2.0 * t_pad * k * n
        nbytes = 2.0 * t_pad * k + 2.0 * used * k * n + t_pad * n * (4 if out_dtype == f32 else 2)
        lib_fn, lib_name = _grouped_mm_library(a, b, al.expert_ids, act, out_dtype)
        libs.add(lib_name)
        row = dict(
            shape=[t_pad, k, n], gelu=act is not None, max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: gg.group_gemm(a, b, al.expert_ids, out_dtype=out_dtype,
                                             act_fn=act), iters=10),
            plain_ms=event_ms(lambda: gg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype,
                                                           act), iters=2),
            library_ms=event_ms(lib_fn, iters=10), library=lib_name,
            bound_ms=bound(flops, nbytes)[0],
        )
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b
    emit({"phase": "kernel", "kernel": "group_gemm", "t_pad": t_pad, "experts_used": used,
          "per_shape": rows})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="group_gemm", route="cuda", source="triton_dist_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_dist_tpu/ops/gg_pipeline.py:87", max_abs_err=worst,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"], library=" + ".join(sorted(libs)),
        shapes=f"t_pad {t_pad} (2048 tokens, top-2 of 8): up 4096->14336, down 14336->4096 "
               f"with GELU, f32 out (summed)",
    )


def _moe_tp4_inputs(g, m_loc):
    """The world-4 routing: 4 x m_loc tokens top-2 over 8 experts, aligned
    per rank."""
    from triton_dist_tpu_torch.ops import moe_utils as mu

    tw, ids = _moe_route(g, WORLD * m_loc, 8, 2)
    ral = mu.moe_align_ranked(ids.reshape(WORLD, -1), 8, MOE_BLOCK, m_loc)
    return ral, tw


def phase_ag_group_gemm(ctx) -> dict:
    """K9 at the per-rank shapes of the world-4 MoE prefill: 2048 tokens,
    512 a rank, top-2 over 8 experts (t_pad_loc 2048 a rank), H 4096 ->
    F shard 3584, bf16."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import group_gemm as gg

    g = torch.Generator(device="cuda").manual_seed(22)
    m_loc, k, n_loc, n_exp = 512, 4096, 3584, 8
    ral, _ = _moe_tp4_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    x = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16() for _ in range(WORLD)]
    b = [(torch.randn((n_exp, k, n_loc), generator=g, device="cuda") / k**0.5).bfloat16()
         for _ in range(WORLD)]
    slabs = [x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(WORLD)]
    gathered = torch.cat(slabs)
    ids_flat = ral.expert_ids.reshape(-1)
    outs = ctx.run(lambda: aggg.ag_group_gemm_overlap(x[ctx.rank], b[ctx.rank], ral, ctx=ctx))
    err, tol = max(_check_bf16(f"ag_group_gemm rank {r}", out,
                               gg._group_gemm_plain(gathered, b[r], ids_flat, MOE_BLOCK,
                                                    torch.bfloat16, None))
                   for r, out in enumerate(outs))
    del outs
    libs = [[_grouped_mm_library(slabs[c], b[r], ral.expert_ids[c], None, torch.bfloat16)
             for c in range(WORLD)] for r in range(WORLD)]

    def library():
        for r in range(WORLD):
            torch.cat(slabs)
            for fn, _ in libs[r]:
                fn()

    rows = WORLD * t_pad_loc
    flops = WORLD * 2.0 * rows * k * n_loc
    nbytes = 2.0 * (rows * k + WORLD * n_exp * k * n_loc + WORLD * rows * n_loc)
    b_ms, by = bound(flops, nbytes)
    entry = dict(
        name="ag_group_gemm", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/gg_pipeline.py:288", max_abs_err=err,
        ms=dist_ms(ctx, lambda: aggg.ag_group_gemm_overlap(x[ctx.rank], b[ctx.rank], ral,
                                                           ctx=ctx), iters=5),
        plain_ms=dist_ms(ctx, lambda: aggg._ag_overlap_xla(
            aggg.presort_local_rows(x[ctx.rank], ral, ctx), b[ctx.rank], ral, ctx, False,
            torch.bfloat16), iters=2),
        bound_ms=b_ms, bound_by=by, library_ms=event_ms(library, iters=3),
        library="torch.cat + " + libs[0][0][1] + " per source slab",
        shapes=f"world {WORLD}: [{m_loc}, {k}] tokens a rank, t_pad_loc {t_pad_loc}, "
               f"w_up shard [{n_exp}, {k}, {n_loc}]",
    )
    entry["tflops"] = flops / entry["ms"] / 1e9
    emit({"phase": "kernel", "kernel": "ag_group_gemm", "world": WORLD, "tol": tol,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "library", "tflops", "shapes")}})
    return entry


def phase_moe_reduce_rs(ctx) -> dict:
    """K10 at the per-rank shapes of the world-4 MoE prefill: the rank-major
    rows [4 x 2048, F shard 3584] bf16 against w_down [8, 3584, 4096], 512
    tokens out a rank."""
    import torch
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(23)
    m_loc, f_loc, h, n_exp = 512, 3584, 4096, 8
    ral, tw = _moe_tp4_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, m_loc, 2)
    hs = [torch.randn((WORLD * t_pad_loc, f_loc), generator=g, device="cuda").bfloat16()
          for _ in range(WORLD)]
    wd = [(torch.randn((n_exp, f_loc, h), generator=g, device="cuda") / f_loc**0.5).bfloat16()
          for _ in range(WORLD)]

    def kernel():
        r = ctx.rank
        return mrs.moe_reduce_rs_overlap(hs[r], wd[r], ral.expert_ids, dst, w_rows, ctx=ctx,
                                         m_out=m_loc, combine_rows=inv)

    def plain():
        r = ctx.rank
        return mrs._moe_rs_overlap_xla(hs[r], wd[r], ral.expert_ids, dst, w_rows, ctx, m_loc,
                                       torch.bfloat16)

    outs = ctx.run(lambda: (kernel(), plain()))
    err, tol = max(_check_bf16(f"moe_reduce_rs rank {r}", got, want, factor=2.0)
                   for r, (got, want) in enumerate(outs))
    del outs
    libs = [[_grouped_mm_library(hs[r][c * t_pad_loc:(c + 1) * t_pad_loc], wd[r],
                                 ral.expert_ids[c], None, torch.float32)[0]
             for c in range(WORLD)] for r in range(WORLD)]
    dst_l = dst.reshape(WORLD, -1).long()
    w_l = w_rows.reshape(WORLD, -1, 1)

    def library():
        parts = [[torch.zeros((m_loc, h), device="cuda").index_add_(0, dst_l[c], libs[r][c]()
                                                                    * w_l[c])
                  for c in range(WORLD)] for r in range(WORLD)]
        return [sum(parts[r][c] for r in range(WORLD)).bfloat16() for c in range(WORLD)]

    rows = WORLD * t_pad_loc
    flops = WORLD * 2.0 * rows * f_loc * h
    nbytes = 2.0 * (WORLD * rows * f_loc + WORLD * n_exp * f_loc * h + WORLD * m_loc * h)
    b_ms, by = bound(flops, nbytes)
    entry = dict(
        name="moe_reduce_rs", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/gg_pipeline.py:576", max_abs_err=err,
        ms=dist_ms(ctx, kernel, iters=5), plain_ms=dist_ms(ctx, plain, iters=2),
        bound_ms=b_ms, bound_by=by, library_ms=event_ms(library, iters=3),
        library="_grouped_mm_library per (rank, destination) + index_add_ + a sum",
        shapes=f"world {WORLD}: h [{rows}, {f_loc}] a rank, w_down shard "
               f"[{n_exp}, {f_loc}, {h}], {m_loc} tokens out a rank",
    )
    entry["tflops"] = flops / entry["ms"] / 1e9
    emit({"phase": "kernel", "kernel": "moe_reduce_rs", "world": WORLD, "tol": tol,
          "combine": "gather form, k order, one launch a destination; reduce in rank order",
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "tflops", "shapes")}})
    return entry


def phase_stuck_wait_moe() -> None:
    """K10's entry barrier with a peer far too late (rank 1's stream held 2
    s, timeout 0.2 s): the run must raise with rank 0's record for the
    moe_rs family, site 1."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(24)
    tw, ids = _moe_route(g, 32, 8, 2)
    ral = mu.moe_align_ranked(ids.reshape(2, -1), 8, MOE_BLOCK, 16)
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, 16, 2)
    hs = torch.randn((2 * ral.t_pad_loc, 64), generator=g, device="cuda")
    wd = torch.randn((8, 64, 32), generator=g, device="cuda")

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return mrs.moe_reduce_rs_overlap(hs, wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                         m_out=16, combine_rows=inv)

    stuck = False
    ctx.run(call)
    stuck = True
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck K10 wait did not raise")
    if [(r["pe"], r["family"], r["site"]) for r in recs] != [(0, "moe_rs", 1)]:
        raise AssertionError(f"stuck K10 wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_moe", "records": recs})
    ctx.close()


def _moe_models():
    """The two forwards of the MoE logits check, each keeping its layers'
    routing ``(weights, ids)`` in ``.routes``:

    - the served forward (``TPMoETransformer``, kernels), unchanged: each
      layer's routing is recomputed after the layer from the same input by
      the same operations, so it is bitwise the routing the layer used;
    - the world-1 reference: plain GEMMs for the projections and the plain
      grouped GEMMs for the experts (the sequential composition of
      ``ops/moe_mlp.py`` with every kernel replaced by its plain version).
      Given ``replay`` (one ``(weights, ids)`` a layer), it takes those
      expert choices instead of its own.
    """
    import torch
    from triton_dist_tpu_torch.models.tp_transformer import TPMoETransformer, rmsnorm
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain

    def route(cfg, x, p):
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        return h, mu.select_experts(h.float() @ p["router"].float(), cfg.topk)

    class Served(TPMoETransformer):
        def _mlp(self, x, p):
            out = super()._mlp(x, p)
            self.routes.append(route(self.cfg, x, p)[1])
            return out

    class Plain(TPMoETransformer):
        replay = None

        def _col(self, x, w):
            return _matmul_plain(x, w, x.dtype)

        _row = _col

        def _mlp(self, x, p):
            c = self.cfg
            h, (tw, ids) = route(c, x, p)
            if self.replay is not None:
                tw, ids = self.replay[len(self.routes)]
            self.routes.append((tw, ids))
            al = mu.moe_align_block_size(ids.reshape(-1), c.n_experts, MOE_BLOCK)
            hs = gg._group_gemm_plain(mu.gather_sorted_rows(h, al, c.topk), p["w_up"],
                                      al.expert_ids, MOE_BLOCK, h.dtype, None)
            y = gg._group_gemm_plain(hs, p["w_down"], al.expert_ids, MOE_BLOCK, torch.float32,
                                     gg.gelu)
            return mu.scatter_add_unsorted(y, al, tw, h.shape[0]).to(x.dtype)

    def make(cls, cfg, replay=None, ctx=None):
        model = cls(cfg, ctx=ctx)
        model.routes, model.replay = [], replay
        return model

    return (lambda cfg, ctx=None: make(Served, cfg, ctx=ctx),
            lambda cfg, replay=None: make(Plain, cfg, replay))


def _serve(cfg, params, reqs, counters, ctx=None):
    """One ServingEngine serve of `reqs` (paged, 16-token pages, bulk
    prefill, s_max 1024) with the launch counts reset just before it and
    read just after."""
    import torch
    from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, s_max=1024, page_size=16, prefill=True, ctx=ctx,
                        serving=ServingConfig(max_queue=64))
    counters.reset()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    if sorted(done) != sorted(r.uid for r in reqs):
        raise AssertionError(f"serve finished {sorted(done)}")
    for uid, res in done.items():
        if len(res.tokens) != reqs[0].max_new_tokens or not all(
                0 <= t < cfg.vocab for t in res.tokens):
            raise AssertionError(f"{uid}: bad tokens {res.tokens}")
    if any(counts["plain_calls"].values()):
        raise AssertionError(f"plain versions ran on the card path: {counts['plain_calls']}")
    n_tok = sum(len(r.tokens) for r in done.values())
    snap = eng.snapshot()
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                ttft_ms=sorted(r.ttft_ms for r in done.values()),
                decode_steps=snap["requests"]["steps"],
                world_size=snap["engine"]["world_size"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **counts)


def _prompt_tokens(reqs, batch, length):
    import torch

    tokens = torch.zeros((batch, length), dtype=torch.long, device="cuda")
    for i, r in enumerate(reqs):
        n = min(length, len(r.prompt))
        tokens[i, :n] = torch.tensor(r.prompt[:n])
    return tokens.reshape(-1)


def _check_moe_logits(name, got, routes, make_plain, cfg, flat, params, rows):
    """The bf16 prefill logits of the served MoE forward (`got`, its layers'
    routing `routes`) against the world-1 plain forward on the same tokens
    and weights.

    Top-2 routing is discontinuous: where a token's second and third expert
    scores lie within the bf16 rounding of the two paths, the two pick
    different experts, and every later layer carries that difference, so
    two correct paths drift apart. The checked comparison therefore gives
    the plain forward the served path's expert choices: relative L2 within
    5e-2, and every row's argmax the same unless the reference's two
    largest logits lie closer than twice that row's largest difference (a
    tie within the measured rounding). The free-running comparison (each
    path routing on its own) is reported beside it with the share of tokens
    whose expert pair differs at each layer."""
    import torch

    with torch.inference_mode():
        free = make_plain(cfg)
        free_logits = free(flat, params)[rows].float()
        ref = make_plain(cfg, replay=routes)(flat, params)[rows].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    row_err = (got - ref).abs().amax(-1)
    top2 = ref.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * row_err
    agree = got.argmax(-1) == ref.argmax(-1)
    flips = [(torch.sort(a[1], 1).values != torch.sort(b[1], 1).values).any(1)
             .float().mean().item() for a, b in zip(routes, free.routes)]
    emit({"phase": name, "rows": got.shape[0],
          "reference": "world 1, plain kernels, the served path's expert choices",
          "rel_l2_err": rel, "max_abs_err": row_err.max().item(),
          "argmax_agree": agree.float().mean().item(),
          "rows_disagreeing_within_a_tie": int((~agree & tie).sum().item()),
          "tol_rel_l2": 5e-2,
          "free_running": {
              "rel_l2_err": ((got - free_logits).norm() / free_logits.norm()).item(),
              "argmax_agree": (got.argmax(-1) == free_logits.argmax(-1)).float().mean().item(),
              "routing_flip_share_per_layer": flips}})
    if not (got.isfinite().all().item() and rel <= 5e-2 and bool((agree | tie).all())):
        raise AssertionError(f"{name}: rel L2 {rel}, argmax {agree.tolist()}, "
                             f"within a tie {tie.tolist()}")


def phase_moe_profile(cfg, params, ctx=None) -> None:
    """Where an MoE cell's time goes, at world 1 (`ctx` None) or on the
    ranks of `ctx`: torch.profiler over the batcher step that admits one
    256-token request (its bulk prefill over the batch's 8 x 256 rows, then
    one decode round) and over three decode steps; each against its host
    wall time (synchronised), with the kernel time summed over every stream
    (at world 4, the four ranks'), the launches and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher

    batcher = ContinuousBatcher(cfg, params, s_max=1024, page_size=16, prefill=True, ctx=ctx)
    warm, req = _requests(cfg.vocab, [256, 256], 24, seed=34)
    batcher.submit(warm)
    for _ in range(2):  # admission + decode warm-up
        batcher.step()

    def window(fn, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        return {"wall_ms": wall, "kernel_ms_all_streams": busy,
                "launches": sum(e.count for e in kernels) / steps,
                "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                   for e in top}}

    batcher.submit(req)
    admit = window(batcher.step, 1)
    decode = window(batcher.step, 3)
    emit({"phase": "moe_profile", "world": 1 if ctx is None else ctx.world,
          "admission_step": admit, "decode_step": decode,
          "note": "admission step = one bulk prefill (8 x 256 rows) + one decode round"})
    del batcher


def phase_serve_moe(counters: Counters) -> tuple[dict, dict]:
    """World 1: Mixtral-8x7B widths (hidden 4096, ffn 14336, 8 experts,
    top-2, 32 q / 8 kv heads, head dim 128, vocab 32000) cut to 8 of 32
    layers, bf16, batch 8, s_max 1024, 16-token pages, bulk prefill, the 8
    requests of phase 4; then world 4 on the one card (phase 12) on the
    same weights, and both serves' prefill logits against the world-1
    plain-kernel forward."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params, shard_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers = 8
    cfg = presets.preset(MOE_MODEL, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
    params = init_moe_params(cfg, seed=30)
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, 32, seed=31)
    one = _serve(cfg, params, reqs, counters)
    launches = one["launches"]
    if any(launches[k] <= 0 for k in ("group_gemm", "gemm", "paged_flash_decode")):
        raise AssertionError(f"serve_moe skipped a kernel: {launches}")
    emit({"phase": "serve_moe", "model": MOE_MODEL, "n_layers": n_layers, "world": 1,
          "batch": 8, "s_max": 1024, "page_size": 16, "prompt_lens": lengths,
          "max_new_tokens": 32, **one})

    L = 128
    flat = _prompt_tokens(reqs, cfg.batch, L)
    pcfg = dataclasses.replace(cfg, seq=L)
    rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
    make_served, make_plain = _moe_models()
    served = make_served(pcfg)
    with torch.inference_mode():
        got = served(flat, params)[rows].float()
    _check_moe_logits("serve_moe_logits", got, served.routes, make_plain, pcfg, flat, params,
                      rows)
    phase_moe_profile(cfg, params)

    ctx = initialize_distributed(WORLD)
    tp4 = _serve(cfg, params, reqs, counters, ctx=ctx)
    launches4 = tp4["launches"]
    used = ("ag_group_gemm", "moe_reduce_rs", "group_gemm", "ag_gemm", "gemm_rs", "gemm",
            "all_gather", "paged_flash_decode", "barrier")
    if any(launches4[k] <= 0 for k in used):
        raise AssertionError(f"serve_moe_tp4 skipped a kernel: {launches4}")
    emit({"phase": "serve_moe_tp4", "model": MOE_MODEL, "n_layers": n_layers, "world": WORLD,
          "batch": 8, "s_max": 1024, "page_size": 16, "prompt_lens": lengths,
          "max_new_tokens": 32, **tp4})
    shards = shard_params(params, WORLD, ctx.devices)
    m_loc = flat.numel() // WORLD

    def rank_logits():
        r = ctx.rank
        model = make_served(pcfg, ctx=ctx)
        out = model(flat[r * m_loc:(r + 1) * m_loc], shards[r])
        return out[rows].float(), model.routes

    outs = ctx.run(rank_logits)
    del shards
    # the ranks route their own token shards: rank order is token order
    routes = [tuple(torch.cat([o[1][li][j] for o in outs]) for j in (0, 1))
              for li in range(n_layers)]
    _check_moe_logits("serve_moe_tp4_logits", torch.cat([o[0] for o in outs], dim=1), routes,
                      make_plain, pcfg, flat, params, rows)
    phase_moe_profile(cfg, params, ctx)
    ctx.close()
    return launches, launches4


def phase_f32_parity_moe() -> None:
    """f32, 2 MoE layers at full Mixtral width: greedy tokens of the kernel
    path on the card (K8 f32 at world 1; K9, K10, K6, K7 f32 at world 4)
    identical to the plain path on the CPU (the wrappers' twins), TF32 off."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(MOE_MODEL, n_layers=2, batch=4, dtype=torch.float32)
    params = init_moe_params(cfg, seed=32)
    params_cpu = {k: v.cpu() for k, v in params.items() if k != "layers"}
    params_cpu["layers"] = [{k: v.cpu() for k, v in p.items()} for p in params["layers"]]
    lengths, max_new = [12, 20, 33, 40], 8

    def run(p, device, world):
        ctx = initialize_distributed(world, device=device) if world > 1 else None
        b = ContinuousBatcher(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                              ctx=ctx)
        for r in _requests(cfg.vocab, lengths, max_new, seed=33):
            b.submit(r)
        out = dict(b.run())
        if ctx is not None:
            ctx.close()
        return out

    times = {}
    for world in (1, WORLD):
        t0 = time.perf_counter()
        want = run(params_cpu, "cpu", world)
        t1 = time.perf_counter()
        got = run(params, "cuda", world)
        times[world] = (t1 - t0, time.perf_counter() - t1)
        if got != want:
            raise AssertionError(f"world-{world} MoE f32 greedy tokens differ: {got} vs {want}")
    emit({"phase": "f32_parity_moe", "model": MOE_MODEL, "n_layers": 2, "worlds": [1, WORLD],
          "requests": len(lengths), "max_new_tokens": max_new, "identical": True,
          "cpu_reference_s": {w: t[0] for w, t in times.items()},
          "card_s": {w: t[1] for w, t in times.items()}})


# ---------------------------------------------------------------- training ----

# SGD step sizes: a 2-layer bf16 MoE probe lowered the loss at 0.1, 0.3 and
# 1.0; the dense model (vocab 128256) overshot at 0.3 (12.29, 8.51, 9.91)
TRAIN_LR = 0.3
DENSE_LR = 0.05
TRAIN_B, TRAIN_S = 2, 1024  # 2048 tokens a step


def phase_group_gemm_dw() -> dict:
    """K11 at the training shapes of the MoE backward: 2048 tokens top-2
    over 8 experts, t_pad 5120, expert-sorted (world 1): dw_up A [5120,
    4096] x G [5120, 14336] and dw_down A [5120, 14336] x G [5120, 4096],
    f32 out; then a rank's dw_up shard at world 4 on the rank-major layout
    (4 x 512 tokens, 8192 gathered rows, not sorted) [8192, 4096] x [8192,
    3584]. Tolerance 1e-4 x max|ref|: the same exact products (bf16 x bf16
    is exact in f32), f32 sums in another order."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(41)
    n_exp, bm, bf16 = 8, MOE_BLOCK, torch.bfloat16
    _, ids = _moe_route(g, TRAIN_B * TRAIN_S, n_exp, 2)
    expert_ids = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm).expert_ids
    ral, _ = _moe_tp4_inputs(g, TRAIN_B * TRAIN_S // WORLD)
    cases = {"dw_up": (expert_ids, 4096, 14336), "dw_down": (expert_ids, 14336, 4096),
             "dw_up_tp4_rank_major": (ral.expert_ids.reshape(-1), 4096, 14336 // WORLD)}
    rows = {}
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for name, (eids, k, n) in cases.items():
        t_pad = eids.numel() * bm
        a = torch.randn((t_pad, k), generator=g, device="cuda").to(bf16)
        gr = torch.randn((t_pad, n), generator=g, device="cuda").to(bf16)
        got = gg.group_gemm_dw(a, gr, eids, n_exp)
        ref = gg._group_gemm_dw_plain(a, gr, eids, n_exp, bm)
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"group_gemm_dw {name}: max abs err {err} > {tol}")
        del got, ref
        host_ids = eids.tolist()
        counts = [host_ids.count(e) for e in range(n_exp)]
        rows_of = [torch.tensor([i * bm + j for i, e_ in enumerate(host_ids) if e_ == e
                                 for j in range(bm)], device="cuda")
                   for e in range(n_exp) if counts[e]]
        a_e, g_e = [a[r] for r in rows_of], [gr[r] for r in rows_of]

        def library():  # one matmul per expert over its rows (gathered outside)
            return [torch.matmul(x.t(), y) for x, y in zip(a_e, g_e)]

        flops = 2.0 * t_pad * k * n
        nbytes = 2.0 * t_pad * (k + n) + 4.0 * n_exp * k * n
        row = dict(shape=[t_pad, k, n], blocks_per_expert=counts, max_abs_err=err, tol=tol,
                   ms=cuda_ms(lambda: gg.group_gemm_dw(a, gr, eids, n_exp), iters=5),
                   plain_ms=event_ms(lambda: gg._group_gemm_dw_plain(a, gr, eids, n_exp, bm),
                                     iters=1),
                   library_ms=event_ms(library, iters=5), bound_ms=bound(flops, nbytes)[0])
        row["tflops"] = flops / row["ms"] / 1e9
        rows[name] = row
        if name != "dw_up_tp4_rank_major":
            for key in ("ms", "plain_ms", "library_ms"):
                total[key] += row[key]
            total["flops"] += flops
            total["bytes"] += nbytes
        del a, gr, a_e, g_e
    emit({"phase": "kernel", "kernel": "group_gemm_dw", "per_shape": rows,
          "tol": "1e-4 x max|ref|"})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="group_gemm_dw", route="cuda", source="triton_dist_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_dist_tpu/ops/gg_pipeline.py:159",
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"], library="torch.matmul(a_e^T, g_e) per expert",
        shapes="t_pad 5120 (2048 tokens, top-2 of 8), sorted: dw_up [8, 4096, 14336] + "
               "dw_down [8, 14336, 4096], f32 out (summed)",
    )


def phase_reduce_scatter(ctx) -> dict:
    """K12 at the shape of the MoE backward's dx at world 4: da_full [2048,
    4096] f32 a rank -> [512, 4096], against the plain psum_scatter; f32
    within 1e-6 x max|ref| (the sums differ only in order: own chunk, then
    the landing slots, against rank order) and bf16 within one bf16 ulp of
    the scale."""
    import torch
    from triton_dist_tpu_torch.ops import reduce_scatter as rs

    g = torch.Generator(device="cuda").manual_seed(42)
    m_tot, n = TRAIN_B * TRAIN_S, 4096
    m_loc = m_tot // WORLD
    errs = {}
    for dtype, rel in ((torch.bfloat16, 2.0**-7), (torch.float32, 1e-6)):
        x = [torch.randn((m_tot, n), generator=g, device="cuda").to(dtype)
             for _ in range(WORLD)]
        outs = ctx.run(lambda: (rs.reduce_scatter(x[ctx.rank], ctx=ctx),
                                rs._reduce_scatter_xla(x[ctx.rank], ctx)))
        err = max((got.float() - want.float()).abs().max().item() for got, want in outs)
        tol = rel * max(want.float().abs().max().item() for _, want in outs)
        if not err <= tol:
            raise AssertionError(f"reduce_scatter {dtype}: max abs err {err} > {tol}")
        errs[str(dtype)] = dict(max_abs_err=err, tol=tol)
    del outs

    def library():
        return [torch.stack([x[p][r * m_loc:(r + 1) * m_loc] for p in range(WORLD)]).sum(0)
                for r in range(WORLD)]

    nbytes = 4.0 * WORLD * (m_tot * n + m_loc * n)
    b_ms, by = bound(WORLD * (WORLD - 1) * m_loc * n, nbytes)
    entry = dict(
        name="reduce_scatter", route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
        replaces="triton_dist_tpu/ops/reduce_scatter.py:227",
        max_abs_err=errs[str(torch.float32)]["max_abs_err"],
        ms=dist_ms(ctx, lambda: rs.reduce_scatter(x[ctx.rank], ctx=ctx), iters=10),
        plain_ms=dist_ms(ctx, lambda: rs._reduce_scatter_xla(x[ctx.rank], ctx), iters=5),
        bound_ms=b_ms, bound_by=by, library_ms=event_ms(library, iters=5),
        library="torch.stack + sum of the four ranks' slices",
        shapes=f"world {WORLD}: [{m_tot}, {n}] f32 a rank -> [{m_loc}, {n}]",
    )
    emit({"phase": "kernel", "kernel": "reduce_scatter", "world": WORLD, "checks": errs,
          **{k_: entry[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms", "shapes")}})
    return entry


def phase_stuck_wait_rs() -> None:
    """K12's entry barrier with a peer far too late (rank 1's stream held 2
    s, timeout 0.2 s): the run must raise with rank 0's record for the
    reduce_scatter family, site 1."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(2)
    x = torch.randn((64, 256), device="cuda")

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return rs.reduce_scatter(x, ctx=ctx)

    stuck = False
    ctx.run(call)
    stuck = True
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck K12 wait did not raise")
    if [(r["pe"], r["family"], r["site"]) for r in recs] != [(0, "reduce_scatter", 1)]:
        raise AssertionError(f"stuck K12 wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_reduce_scatter", "records": recs})
    ctx.close()


def _train_batch(vocab, seed):
    """A seeded batch of 2 x 1024 tokens, the targets the next token."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, vocab, (TRAIN_B * TRAIN_S,), generator=g, device="cuda")
    return tokens, torch.roll(tokens, -1)


def _profile(fn) -> dict:
    """torch.profiler over one call of `fn` (synchronised): its wall, the
    kernel time summed over every stream, the device's busy time (the union
    of the kernels' intervals) and idle share, launches, the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    by_name = {}  # template instances share a prefix: sum them under it
    for e in kernels:
        by_name[e.key[:70]] = by_name.get(e.key[:70], 0.0) + e.self_device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall,
            "kernel_ms_all_streams": sum(e.self_device_time_total for e in kernels) / 1e3,
            "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / 1e3 / wall,
            "launches": sum(e.count for e in kernels), "top_kernels_ms": dict(top)}


def _check_train(name, losses, launches, plain, used):
    if not (all(math.isfinite(v) for v in losses)
            and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"{name}: losses not finite and decreasing: {losses}")
    if any(launches[k] <= 0 for k in used) or any(plain.values()):
        raise AssertionError(f"{name}: launches {launches}, plain calls {plain}")


def _train_world1(name, model, init, tokens, targets, counters, lr, steps=3,
                  warm=None) -> dict:
    """One warm-up step from the parameters ``init()`` makes (on `warm`, a
    model of the same config, where given) and `steps` timed SGD steps of
    `model` on one batch, launches counted over the timed steps, then one
    forward and one backward timed apart, and a profiled step. Only the
    current step's parameters are kept."""
    import torch
    from triton_dist_tpu_torch.models import tp_transformer as ttm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, loss = ttm.train_step(warm or model, init(), tokens, targets, lr=lr)
    losses, walls = [loss.item()], []
    counters.reset()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = ttm.train_step(model, params, tokens, targets, lr=lr)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    work = ttm._tree_map(lambda p: p.detach().requires_grad_(), params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(tokens, targets, work)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, ttm._tree_leaves(work))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del work, loss
    prof = _profile(lambda: ttm.train_step(model, params, tokens, targets, lr=lr))
    wall = sorted(walls)[len(walls) // 2]
    return dict(phase=name, world=1, lr=lr, batch=TRAIN_B, seq=TRAIN_S,
                losses=losses, step_wall_s=walls, step_wall_s_median=wall,
                forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                train_tokens_per_s=TRAIN_B * TRAIN_S / wall, peak_mem_gb=peak,
                profile_one_step=prof, **counts)


def _train_models():
    """The kernel-path MoE model that records each layer's expert choices,
    and the plain world-1 reference: plain GEMMs and the plain grouped
    GEMMs, differentiable by PyTorch's autograd (the reference gradient),
    taking a given list of expert choices (one ``ids`` a layer) with the
    routing weights recomputed from its own router."""
    import torch
    from triton_dist_tpu_torch.models.tp_transformer import TPMoETransformer, rmsnorm
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain

    class Recorded(TPMoETransformer):
        def _mlp(self, x, p):
            with torch.no_grad():
                h = rmsnorm(x, p["mlp_norm"], self.cfg.norm_eps)
                self.routes.append(mu.select_experts(h.float() @ p["router"].float(),
                                                     self.cfg.topk)[1])
            return super()._mlp(x, p)

    class Plain(TPMoETransformer):
        def _col(self, x, w):
            return _matmul_plain(x, w, x.dtype)

        _row = _col

        def _mlp(self, x, p):
            c = self.cfg
            h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
            logits = h.float() @ p["router"].float()
            tw, ids = mu.select_experts(logits, c.topk)
            if self.replay is not None:
                ids = self.replay[len(self.routes)]
                tw = torch.softmax(logits, -1).gather(1, ids.long())
                tw = tw / tw.sum(-1, keepdim=True)
            self.routes.append(ids)
            al = mu.moe_align_block_size(ids.reshape(-1), c.n_experts, MOE_BLOCK)
            hs = gg._group_gemm_plain(mu.gather_sorted_rows(h, al, c.topk), p["w_up"],
                                      al.expert_ids, MOE_BLOCK, h.dtype, None)
            y = gg._group_gemm_plain(hs, p["w_down"], al.expert_ids, MOE_BLOCK, torch.float32,
                                     gg.gelu)
            return mu.scatter_add_unsorted(y, al, tw, h.shape[0]).to(x.dtype)

    def make(cls, cfg, ctx=None, replay=None):
        model = cls(cfg, ctx=ctx)
        model.routes, model.replay = [], replay
        return model

    return (lambda cfg, ctx=None: make(Recorded, cfg, ctx),
            lambda cfg, replay=None: make(Plain, cfg, replay=replay))


def _flips(a, b) -> list:
    """Per layer, the share of tokens whose expert set differs."""
    import torch

    return [(torch.sort(x, 1).values != torch.sort(y, 1).values).any(1).float().mean().item()
            for x, y in zip(a, b)]


def phase_train_moe(counters: Counters) -> tuple[dict, dict]:
    """World 1: Mixtral-8x7B widths cut to 8 of 32 layers (the serve_moe
    cut), bf16, seeded random weights, batch 2 x 1024, SGD at TRAIN_LR: a
    warm-up step and 3 timed steps on one batch (losses finite and
    falling), K1, K8 and K11 launched and no plain version; the step-1
    loss against the plain path's on the same weights (within 2e-2
    relative; bf16 top-2 routing flips between two summation orders, which
    are reported). Only the warm-up step records its expert choices: the
    timed steps run the model users call. Then the same model and batch at world 4 on the one
    card (train_moe_tp4)."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.ops import grads
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers = 8
    cfg = presets.preset(MOE_MODEL, n_layers=n_layers, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16)
    tokens, targets = _train_batch(cfg.vocab, seed=51)
    make_recorded, make_plain = _train_models()
    plain = make_plain(cfg)
    with torch.inference_mode():
        plain_loss = plain.loss(tokens, targets, ttm.init_moe_params(cfg, seed=50)).item()
    torch.cuda.empty_cache()
    recorded = make_recorded(cfg)
    one = _train_world1("train_moe", ttm.TPMoETransformer(cfg),
                        lambda: ttm.init_moe_params(cfg, seed=50), tokens, targets, counters,
                        TRAIN_LR, warm=recorded)
    rel = abs(one["losses"][0] - plain_loss) / abs(plain_loss)
    # the backward hands K8 each expert bank transposed, a contiguous copy
    # (ops/grads.py _t): w_down^T and w_up^T once a layer each
    bank = torch.randn((cfg.n_experts, cfg.ffn, cfg.hidden), device="cuda").to(cfg.dtype)
    one["bank_transpose_copy_ms"] = cuda_ms(lambda: grads._t(bank), iters=5)
    one["bank_transpose_copies_per_step"] = 2 * n_layers
    del bank
    one.update(model=MOE_MODEL, n_layers=n_layers, step1_loss_plain=plain_loss,
               step1_loss_rel_err=rel, tol_step1_loss_rel=2e-2,
               routing_flip_share_per_layer=_flips(recorded.routes, plain.routes))
    del recorded, plain
    emit(one)
    _check_train("train_moe", one["losses"], one["launches"], one["plain_calls"],
                 ("gemm", "group_gemm", "group_gemm_dw"))
    if not rel <= 2e-2:
        raise AssertionError(f"train_moe step-1 loss {one['losses'][0]} vs plain {plain_loss}")
    torch.cuda.empty_cache()

    params = ttm.init_moe_params(cfg, seed=50)
    ctx = initialize_distributed(WORLD)
    state = ttm.shard_params(params, WORLD, ctx.devices)
    del params
    m_loc = tokens.numel() // WORLD
    models = [ttm.TPMoETransformer(cfg, ctx=ctx) for _ in range(WORLD)]

    def step():
        r = ctx.rank
        state[r], loss = ttm.train_step(models[r], state[r], tokens[r * m_loc:(r + 1) * m_loc],
                                        targets, lr=TRAIN_LR)
        return loss.item()

    def split():
        r = ctx.rank
        work = ttm._tree_map(lambda p: p.detach().requires_grad_(), state[r])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = models[r].loss(tokens[r * m_loc:(r + 1) * m_loc], targets, work)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, ttm._tree_leaves(work))
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [ctx.run(step, grad=True)[0]], []
    counters.reset()
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(ctx.run(step, grad=True)[0])
        walls.append(time.perf_counter() - t0)
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    fwd_bwd = ctx.run(split, grad=True)
    prof = _profile(lambda: ctx.run(step, grad=True))
    wall = sorted(walls)[len(walls) // 2]
    four = dict(phase="train_moe_tp4", model=MOE_MODEL, n_layers=n_layers, world=WORLD,
                lr=TRAIN_LR, batch=TRAIN_B, seq=TRAIN_S, losses=losses, step_wall_s=walls,
                step_wall_s_median=wall, forward_ms=max(f for f, _ in fwd_bwd),
                backward_ms=max(b for _, b in fwd_bwd),
                train_tokens_per_s=TRAIN_B * TRAIN_S / wall, peak_mem_gb=peak,
                profile_one_step=prof, **counts)
    emit(four)
    _check_train("train_moe_tp4", losses, counts["launches"], counts["plain_calls"],
                 ("ag_gemm", "gemm_rs", "group_gemm", "ag_group_gemm", "moe_reduce_rs",
                  "group_gemm_dw", "reduce_scatter", "barrier"))
    del state, models
    ctx.close()
    return one["launches"], counts["launches"]


def phase_train_dense(counters: Counters) -> dict:
    """World 1: Llama-3.1-8B widths, 2 layers, bf16, batch 2 x 1024, a
    warm-up step and 3 timed SGD steps at DENSE_LR: K1 carries the projections forward
    and backward (the dense SwiGLU backward is plain autograd)."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm

    cfg = presets.preset("llama-3.1-8b", n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16)
    tokens, targets = _train_batch(cfg.vocab, seed=53)
    out = _train_world1("train_dense", ttm.TPTransformer(cfg),
                        lambda: ttm.init_params(cfg, seed=52), tokens, targets, counters,
                        DENSE_LR)
    out.update(model="llama-3.1-8b", n_layers=2)
    emit(out)
    _check_train("train_dense", out["losses"], out["launches"], out["plain_calls"], ("gemm",))
    return out["launches"]


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def phase_f32_parity_train() -> None:
    """f32, 2 MoE layers at full Mixtral width, batch 2 x 1024: one
    train_step at world 1 and at world 4 on the card against the plain
    path on the card (plain GEMMs and grouped GEMMs, differentiated by
    PyTorch's autograd) on the same weights and expert choices, TF32 off:
    the loss within 1e-5 relative, every gradient leaf (each rank's shard)
    and every updated parameter within 1e-4 relative L2."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(MOE_MODEL, n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.float32)
    tokens, targets = _train_batch(cfg.vocab, seed=55)
    params = ttm.init_moe_params(cfg, seed=54)
    splits = ttm._tree_leaves(ttm._tree_map(lambda _, s: s, params, ttm.specs_for(cfg)))
    leaves = ttm._tree_leaves(params)
    make_recorded, make_plain = _train_models()
    report = {}

    def reference(routes):
        return ttm._loss_and_grads(make_plain(cfg, replay=routes), params, tokens, targets)

    def compare(world, rank_outs, ref):
        loss_ref, g_ref = ref
        worst = dict(loss_rel=0.0, grad_rel_l2=0.0, param_rel_l2=0.0)
        for r, (loss, grads, (new, step_loss)) in enumerate(rank_outs):
            worst["loss_rel"] = max(worst["loss_rel"], abs(loss - loss_ref.item()) / abs(
                loss_ref.item()), abs(step_loss - loss_ref.item()) / abs(loss_ref.item()))
            for g, want, p, split, q in zip(grads, g_ref, leaves, splits,
                                            ttm._tree_leaves(new)):
                if split is not None and world > 1:
                    want = want.chunk(world, split)[r]
                    p = p.chunk(world, split)[r]
                worst["grad_rel_l2"] = max(worst["grad_rel_l2"], _rel_l2(g, want))
                worst["param_rel_l2"] = max(worst["param_rel_l2"],
                                            _rel_l2(q, p - TRAIN_LR * want))
        report[world] = worst
        if not (worst["loss_rel"] <= 1e-5 and worst["grad_rel_l2"] <= 1e-4
                and worst["param_rel_l2"] <= 1e-4):
            raise AssertionError(f"f32 train parity at world {world}: {worst}")

    model = make_recorded(cfg)
    loss, grads = ttm._loss_and_grads(model, params, tokens, targets)
    routes = model.routes
    new, step_loss = ttm.train_step(make_recorded(cfg), params, tokens, targets, lr=TRAIN_LR)
    ref = reference(routes)
    compare(1, [(loss.item(), grads, (new, step_loss.item()))], ref)
    del grads, new
    torch.cuda.empty_cache()

    ctx = initialize_distributed(WORLD)
    shards = ttm.shard_params(params, WORLD, ctx.devices)
    m_loc = tokens.numel() // WORLD

    def rank():
        r = ctx.rank
        t = tokens[r * m_loc:(r + 1) * m_loc]
        model = make_recorded(cfg, ctx=ctx)
        loss, grads = ttm._loss_and_grads(model, shards[r], t, targets)
        new, step_loss = ttm.train_step(make_recorded(cfg, ctx=ctx), shards[r], t, targets,
                                        lr=TRAIN_LR)
        return (loss.item(), grads, (new, step_loss.item())), model.routes

    outs = ctx.run(rank, grad=True)
    # the ranks route their own token shards: rank order is token order
    routes4 = [torch.cat([o[1][li] for o in outs]) for li in range(cfg.n_layers)]
    flips = _flips(routes4, routes)
    if any(flips):  # the plain path takes world 4's expert choices instead
        del ref
        ref = reference(routes4)
    compare(WORLD, [o[0] for o in outs], ref)
    ctx.close()
    emit({"phase": "f32_parity_train", "model": MOE_MODEL, "n_layers": 2, "worlds": [1, WORLD],
          "reference": "world 1, plain kernels on the card, PyTorch autograd, the kernel "
                       "path's expert choices", "worst": report,
          "routing_flip_share_world4_vs_world1": flips,
          "tol": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "param_rel_l2": 1e-4}})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import triton_dist_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(triton_dist_tpu_torch not found)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    kind = phase_device()
    phase_build()
    counters = Counters()
    entries = [phase_gemm(), phase_flash_decode(), phase_paged_flash_decode()]
    moe_entries = [phase_group_gemm()]
    train_entries = [phase_group_gemm_dw()]
    torch.cuda.empty_cache()
    paged = phase_serve(counters)
    torch.cuda.empty_cache()
    contiguous = phase_contiguous(counters)
    torch.cuda.empty_cache()
    phase_f32_parity()
    torch.cuda.empty_cache()
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    ctx = initialize_distributed(WORLD)
    dist_entries = [phase_barrier(ctx), phase_all_gather(ctx), phase_ag_gemm(ctx),
                    phase_gemm_rs(ctx)]
    moe_entries += [phase_ag_group_gemm(ctx), phase_moe_reduce_rs(ctx)]
    train_entries.append(phase_reduce_scatter(ctx))
    ctx.close()
    phase_stuck_wait()
    phase_stuck_wait_moe()
    phase_stuck_wait_rs()
    torch.cuda.empty_cache()
    tp4 = phase_serve_tp4(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_tp4()
    torch.cuda.empty_cache()
    moe1, moe4 = phase_serve_moe(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_moe()
    torch.cuda.empty_cache()
    train1, train4 = phase_train_moe(counters)
    torch.cuda.empty_cache()
    phase_train_dense(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_train()
    entries[0]["launches"] = paged["gemm"]
    entries[1]["launches"] = contiguous["flash_decode"]
    entries[2]["launches"] = paged["paged_flash_decode"]
    for entry, key in zip(dist_entries, ("barrier", "all_gather", "ag_gemm", "gemm_rs")):
        entry["launches"] = tp4[key]
    entries += dist_entries
    moe_entries[0]["launches"] = moe1["group_gemm"]
    moe_entries[1]["launches"] = moe4["ag_group_gemm"]
    moe_entries[2]["launches"] = moe4["moe_reduce_rs"]
    entries += moe_entries
    train_entries[0]["launches"] = train1["group_gemm_dw"] + train4["group_gemm_dw"]
    train_entries[1]["launches"] = train4["reduce_scatter"]
    entries += train_entries
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
