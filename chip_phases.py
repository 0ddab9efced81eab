"""Run a few of ``chip_smoke.py``'s phases in one process, on one card.

    python3 chip_phases.py PHASE [PHASE ...]

Builds the kernels, then runs each named phase in order and prints its
JSON lines (as ``chip_smoke.py`` does) and one line
``{"phase_name": ..., "phase_seconds": ..., "alloc_conf": ...}`` a phase.
For reruns of a phase after a change, and for A/B calls: run it in one
chip call with and without a setting, e.g. with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in the environment
and without it (``train`` runs under ``chip_smoke.expandable_segments``,
as in the full script). Phases: ``serve_tp4``,
``f32_parity_tp4``, ``train`` (``train_adam``, ``train_moe_ep4``,
``train_moe_ep_hier``), ``usp_attention``, ``kv_stream``,
``f32_parity_ep``, ``f32_parity_train``.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv: list[str]) -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import chip_smoke as cs

    def train(c):
        with cs.expandable_segments():
            cs.phase_train_adam(c)
            torch.cuda.empty_cache()
            cs.phase_train_moe_ep4(c)
            torch.cuda.empty_cache()
            cs.phase_train_moe_ep_hier(c)

    phases = {
        "serve_tp4": cs.phase_serve_tp4,
        "f32_parity_tp4": lambda c: cs.phase_f32_parity_tp4(),
        "train": train,
        "usp_attention": cs.phase_usp_attention,
        "kv_stream": lambda c: cs.emit({"kernels": cs.phase_kv_stream()}),
        "f32_parity_ep": lambda c: cs.phase_f32_parity_ep(),
        "f32_parity_train": lambda c: cs.phase_f32_parity_train(),
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
