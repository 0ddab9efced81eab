"""Time the K1 GEMM of a checkout at the world-1 served shapes (Llama-3.1-8B
widths, M = 2048 rows: wqkv, gate/up, LM head), on one CUDA card.

    python3 triton_dist_tpu_torch/bench_gemm.py [ROOT]

ROOT (default: the current directory) holds the ``triton_dist_tpu_torch``
package to time; it is built there at first use. Run the file, not the
module (``-m`` would import this checkout's package before ROOT's).
Each shape's device time is a CUDA-graph replay of ten calls between two
CUDA events. To compare two versions, run it for both roots inside one
call to the card, in turns (ROOT_A, ROOT_B, ROOT_B, ROOT_A). Prints one
JSON line.
"""

from __future__ import annotations

import json
import math
import sys


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from triton_dist_tpu_torch import _build
    from triton_dist_tpu_torch.ops.gemm import matmul

    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: no CUDA device")
    _build.build_all()

    def cuda_ms(fn, iters=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"root": root}
    for name, (k, n) in {"wqkv": (4096, 6144), "gate_up": (4096, 28672),
                         "lm_head": (4096, 128256)}.items():
        a = torch.randn((2048, k), generator=gen, device="cuda").bfloat16()
        b = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
        out[name] = cuda_ms(lambda: matmul(a, b))
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")), flush=True)
