"""Run a few of ``chip_smoke.py``'s phases in one process, on one card.

    python3 chip_phases.py [--tree DIR] PHASE [PHASE ...]

Builds the kernels, then runs each named phase in order and prints its
JSON lines (as ``chip_smoke.py`` does) and one line
``{"phase_name": ..., "phase_seconds": ..., "alloc_conf": ...}`` a phase.
For reruns of a phase after a change, and for A/B calls: run it in one
chip call with and without a setting, e.g. with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in the environment
and without it (``train`` and ``f32_parity_train`` run under
``chip_smoke.expandable_segments``, as in the full script). ``--tree DIR``
runs DIR's ``chip_smoke.py`` phases with DIR's package (an unpacked
``git archive`` of another commit): two trees in one call, in the order
A, B, B, A, compare two versions on one card. Phases:
``gemm`` (K1, the wgmma engine beside the mma.sync one),
``gemm_small_m`` (K1's wgmma tiles against each other at M <= 64),
``flash_decode`` (K2, the one-launch kernel beside the split one),
``paged_flash_decode`` (K3, the one-launch kernel beside the split one),
``flash_verify`` (K13, the wgmma + TMA kernel beside the mma.sync one),
``paged_flash_decode_profile`` (torch.profiler over both K3 engines),
``serve_paged`` (the world-1 8B serve and its decode profile),
``serve_contiguous`` (4 layers over the contiguous cache: K2),
``serve_chunked_contiguous`` (chunked prefill over it: K13 and K2),
``serve_tp4``, ``layers_ring``, ``f32_parity_tp4``, ``train``
(``train_adam``, ``train_moe_ep4``, ``train_moe_ep_hier``),
``usp_attention``, ``kv_stream``, ``f32_parity_ep``, ``f32_parity_train``.
"""

from __future__ import annotations

import json
import os
import sys
import time


def gemm_small_m(cs) -> None:
    """K1's wgmma tiles at M <= 64 on the five Llama-3.1-8B weights of
    ``phase_gemm``: every tile config of ``SM90_TILES`` on the same
    product, each held to the plain version (2^-7 of the output scale),
    and the sums over the five weights for each M."""
    import torch
    from triton_dist_tpu_torch.ops import gemm as G

    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    per_m = {}
    for m in (8, 16, 32, 48, 64):
        sums = {f"ms_config{c}": 0.0 for c in G.SM90_TILES}
        sums.update(prev_ms=0.0, library_ms=0.0)
        for name, (k, n) in shapes.items():
            a = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            b = (torch.randn((k, n), generator=g, device="cuda") / k**0.5).bfloat16()
            ref = G._matmul_plain(a, b, torch.bfloat16).float()
            tol = 2.0**-7 * ref.abs().max().item()
            for c in G.SM90_TILES:
                err = (G.matmul(a, b, _config=c).float() - ref).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"gemm {name} M={m} config {c}: max abs err {err}")
                sums[f"ms_config{c}"] += cs.cuda_ms(lambda c=c: G.matmul(a, b, _config=c),
                                                    iters=20)
            sums["prev_ms"] += cs.cuda_ms(lambda: G.matmul(a, b, _engine="mma_sync"), iters=20)
            sums["library_ms"] += cs.cuda_ms(lambda: torch.matmul(a, b), iters=20)
        per_m[f"m{m}"] = dict(config=G.plan(m, 6144, 4096, torch.bfloat16).config, **sums)
    cs.emit({"phase": "gemm_small_m", "tiles": {str(c): t for c, t in G.SM90_TILES.items()},
             "sums_over_five_weights": per_m})


def paged_flash_decode_profile(cs) -> None:
    """torch.profiler over 20 calls of each K3 engine at the
    ``phase_paged_flash_decode`` shape: device time per call of each
    kernel (and memset), and the gaps between one call's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s, page = 8, 32, 8, 128, 1024, 16
    pps = s // page
    g = torch.Generator(device="cuda").manual_seed(4)
    lens = torch.tensor([1024, 0, 16, 17, 255, 600, 999, 1], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((b, hq, d), generator=g, device="cuda").bfloat16()
    kp = torch.randn((b * pps, h_kv, page, d), generator=g, device="cuda").bfloat16()
    vp = torch.randn((b * pps, h_kv, page, d), generator=g, device="cuda").bfloat16()
    table = torch.randperm(b * pps, generator=g, device="cuda").reshape(b, pps)
    table = table.to(torch.int32).contiguous()
    calls, out = 20, {}
    for name, engine in (("split", "split"), ("onepass", None)):
        run = lambda: fd.paged_flash_decode(q, kp, vp, lens, table,  # noqa: E731
                                            return_lse=True, _engine=engine)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
                torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                        key=lambda e: e.time_range.start)
        per_call = len(events) // calls
        gaps = [events[i + 1].time_range.start - events[i].time_range.end
                for i in range(len(events) - 1) if (i + 1) % per_call]
        out[name] = dict(
            device_events_per_call=per_call,
            us_per_call={e.key[:60]: e.self_device_time_total / calls
                         for e in prof.key_averages() if e.device_type.name == "CUDA"},
            gap_us_within_call=sum(gaps) / max(1, len(gaps)) if gaps else 0.0)
    cs.emit({"phase": "paged_flash_decode_profile", "calls": calls,
             "lens": lens.tolist(), **out})


def main(argv: list[str]) -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if argv[:1] == ["--tree"] and len(argv) > 1:
        root, argv = os.path.abspath(argv[1]), argv[2:]
        os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    print(json.dumps({"tree": root}), flush=True)

    def train(c):
        with cs.expandable_segments():
            cs.phase_train_adam(c)
            torch.cuda.empty_cache()
            cs.phase_train_moe_ep4(c)
            torch.cuda.empty_cache()
            cs.phase_train_moe_ep_hier(c)

    def f32_parity_train():
        with cs.expandable_segments():
            cs.phase_f32_parity_train()

    phases = {
        "gemm": lambda c: cs.emit({"kernels": [cs.phase_gemm()]}),
        "gemm_small_m": lambda c: gemm_small_m(cs),
        "flash_decode": lambda c: cs.emit({"kernels": [cs.phase_flash_decode()]}),
        "paged_flash_decode": lambda c: cs.emit({"kernels": [cs.phase_paged_flash_decode()]}),
        "flash_verify": lambda c: cs.emit({"kernels": [cs.phase_flash_verify()]}),
        "paged_flash_decode_profile": lambda c: paged_flash_decode_profile(cs),
        "serve_paged": lambda c: cs.phase_serve(c),
        "serve_contiguous": lambda c: cs.phase_contiguous(c),
        "serve_chunked_contiguous": lambda c: cs.phase_chunked_contiguous(c),
        "serve_tp4": lambda c: cs.phase_serve_tp4(c),
        "layers_ring": lambda c: cs.phase_layers_ring(c),
        "f32_parity_tp4": lambda c: cs.phase_f32_parity_tp4(),
        "train": train,
        "usp_attention": lambda c: cs.phase_usp_attention(c),
        "kv_stream": lambda c: cs.emit({"kernels": cs.phase_kv_stream()}),
        "f32_parity_ep": lambda c: cs.phase_f32_parity_ep(),
        "f32_parity_train": lambda c: f32_parity_train(),
    }
    unknown = [p for p in argv if p not in phases]
    if not argv or unknown:
        print(f"chip_phases: name phases from {sorted(phases)} (unknown: {unknown})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_device()
    cs.phase_build()
    counters = cs.Counters()
    for name in argv:
        t0 = time.perf_counter()
        phases[name](counters)
        torch.cuda.empty_cache()
        print(json.dumps({"phase_name": name, "phase_seconds": time.perf_counter() - t0,
                          "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
