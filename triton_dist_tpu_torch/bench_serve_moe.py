"""Time the world-4 MoE serve of a checkout on one CUDA card: the
``serve_moe_tp4`` cell of ``chip_smoke.py`` (Mixtral-8x7B widths cut to 8
of 32 layers, bf16, seeded weights, batch 8, the eight requests of 32–256
prompt tokens and 32 new tokens each, the four ranks on the one card).

    python3 triton_dist_tpu_torch/bench_serve_moe.py [ROOT] [--serves N]

ROOT (default: the current directory) is a checkout holding
``chip_smoke.py`` and the ``triton_dist_tpu_torch`` package: both are taken
from there, and the kernels are built there at first use. Run the file, not
the module (``-m`` would import this checkout's package before ROOT's). One
untimed serve warms the kernels and the allocator, then N serves (default
2) are timed with ``chip_smoke._serve``. The serves are host-bound and
swing between processes, so to compare two versions run it for both roots
inside one call to the card, in turns (ROOT_A, ROOT_B, ROOT_B, ROOT_A).
Prints one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys


def main(root: str, serves: int) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root,
                                                                             "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # sets the stream-connection count before CUDA starts
    import torch
    from triton_dist_tpu_torch import _build
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    if not torch.cuda.is_available():
        raise SystemExit("bench_serve_moe: no CUDA device")
    _build.build_all()
    cfg = presets.preset(smoke.MOE_MODEL, n_layers=8, batch=8, dtype=torch.bfloat16)
    params = init_moe_params(cfg, seed=30)
    reqs = smoke._requests(cfg.vocab, [32, 48, 64, 100, 128, 160, 200, 256], 32, seed=31)
    counters = smoke.Counters()
    ctx = initialize_distributed(smoke.WORLD)
    runs = [smoke._serve(cfg, params, reqs, counters, ctx=ctx) for _ in range(serves + 1)][1:]
    ctx.close()
    return {"root": root, "wall_s": [r["wall_s"] for r in runs],
            "tokens_per_s": [r["tokens_per_s"] for r in runs],
            "ttft_ms_max": [max(r["ttft_ms"]) for r in runs],
            "peak_mem_gb": [r["peak_mem_gb"] for r in runs]}


if __name__ == "__main__":
    args = sys.argv[1:]
    n = 2
    if "--serves" in args:
        i = args.index("--serves")
        n = int(args[i + 1])
        del args[i:i + 2]
    print(json.dumps(main(args[0] if args else ".", n)), flush=True)
