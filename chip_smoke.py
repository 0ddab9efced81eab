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
   the card identical to the plain path (the wrappers' CPU twins).

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

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core peak


def emit(obj) -> None:
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bf16 operations at the
    tensor-core peak or bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Counters:
    """Launch counts of every kernel wrapper and call counts of the plain
    versions, reset just before a main-path run and read just after it."""

    def __init__(self):
        from triton_dist_tpu_torch.ops import flash_decode as fd
        from triton_dist_tpu_torch.ops import gemm

        self.kernels = {
            "gemm": gemm.matmul,
            "flash_decode": fd.flash_decode,
            "paged_flash_decode": fd.paged_flash_decode,
        }
        self.plain = {"gemm": gemm._matmul_plain, "decode": fd._xla_decode}

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
    torch.cuda.empty_cache()
    paged = phase_serve(counters)
    torch.cuda.empty_cache()
    contiguous = phase_contiguous(counters)
    torch.cuda.empty_cache()
    phase_f32_parity()
    entries[0]["launches"] = paged["gemm"]
    entries[1]["launches"] = contiguous["flash_decode"]
    entries[2]["launches"] = paged["paged_flash_decode"]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
