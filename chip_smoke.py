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
   show the K1 GEMM and K3 paged decode carried it (plain versions: 0; every
   product on K1's wgmma + TMA engine, every decode on K3's one-launch
   kernel);
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
13. ``f32_parity_moe``: f32, 1 MoE layer at full width, greedy tokens on the
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
   (loss, every gradient shard, every updated parameter);
18. the multi-position verify kernels K13 (contiguous) and K14 (paged, rows
   sharing prefix pages) at 8B widths, batch 8, a 2048-position cache,
   S = 256 and 8 with parked, ragged and empty rows, soft cap, d = 96, bf16
   and f32, each against its plain version;
19. ``serve_chunked``: Llama-3.1-8B widths, 32 layers, bf16, batch 8, paged,
   s_max 2048, 8 prompts of 512-1536 tokens admitted in 256-token ranged
   chunks (K14, K3) — tokens/s, TTFT, the longest decode stall while a
   chunk lands — against the same requests admitted in bulk; then
   ``serve_prefix``: 8 requests sharing a 512-token system prompt with the
   radix prefix cache (one miss, seven hits) against no cache;
   ``serve_chunked_contiguous`` (K13, K2, 4 layers);
20. ``f32_parity_ranged``: 2 layers, world 1 and 4: chunked = bulk =
   token-fed and prefix hit = miss = token-fed greedy tokens, a Mixtral
   MoE chunked = token-fed, K13/K14 chunk calls bit for bit equal to the
   whole-range call, ``prefill_cache_ranged`` composition and CPU twin;
21. the rings (``csrc/ring.cu``), the world-4 context re-declared a ring
   (``ctx.full_mesh = False``): the ring AG-GEMM K15 at K6's shapes (one
   span and two), the ring GEMM-RS K16 and its spans K17 at K7's (chunks
   1, 2, 3), the ring reduce-scatter K18 at K12's, each against its
   ring-order plain version and the library golden; a stuck ring wait that
   must raise with its record;
22. ``serve_tp4_ring``: ``serve_tp4``'s model, weights and traffic on a
   ring context with two spans a shard (K15, K17; no K6/K7) and its bf16
   logits; ``f32_parity_tp4_ring``: f32 greedy tokens on a ring against
   the world-4 CPU twins on a ring;
23. ``train_ring``: one f32 train step at world 4 on a ring, Mixtral widths
   cut to 2 layers (K15, K16, K18), loss, gradients and updated
   parameters against the plain path differentiated by PyTorch;
24. ``ring_collectives``, world 4 on a ring: the ring allgathers K19-K22
   (one way and both, one span and spans) at the SP combine's payload and
   the Mixtral token slab, bit-exact against the plain gather; the chunked
   ring reduce-scatter K23 at K12's shape, bit-equal to K18; a second pass
   of every ring kernel (K15-K23) with the race-shaking delay on, whose
   outputs must be bit-identical; a stuck bidirectional-ring wait at world
   3 that must raise with its fixed site;
25. ``layers_ring``: the layer tier at full width on a ring (one counted
   run): ``SpGQAFlashDecodeAttention(ag_method="ring_bidir")`` contiguous
   and paged at 70B decode widths against ``full_mesh_push``, ``TPMLP`` at
   70B widths with two-span ring configs, ``TPMoEMLP`` sequential and
   overlapped at Mixtral widths (the gather K21 and K18 against K9/K10),
   the op-level sequential pair with ``ag_method="ring_1d"`` and a
   two-span reduce-scatter (K19, K23), the token gather with two spans
   (K20, K22), and one f32 forward + backward of the sequential
   ``TPMoEMLP`` against the plain path differentiated by PyTorch.

26. the int8 / fp8 expert banks: the scaled grouped GEMM K24 at K8's
   Mixtral prefill shapes (up-projection, and down-projection with the GELU
   fused) and the f32 engine at small shapes; at world 4 the scaled
   AG-GroupGEMM K25 and MoE-Reduce-RS K26 at K9's and K10's shapes, each
   format held to its plain twin and timed beside its bound, its plain
   twin and the library (the pool upcast to bf16, ``torch._grouped_mm``,
   the scale fold); ``serve_moe_w8`` and ``serve_moe_fp8``:
   ``serve_moe``'s model and requests from banks quantized by
   ``quantize_moe_serving_params`` (the float banks freed first: peak
   memory and the banks' GB), ``serve_moe_tp4_w8`` at world 4 (K25, K26),
   each serve's bf16 prefill logits against the plain scaled forward; and
   ``f32_parity_moe_quant``: one f32 layer, both formats, world 1 and 4,
   greedy tokens on the card equal to the CPU plain path, two runs built
   from float banks so the engine's quantize-once branch runs on the card.
27. expert parallelism (``csrc/a2a.cu``): the padded-slab all-to-all K27
   and its chunked form K28 (2 and 3 spans) at the EP serve's prefill and
   decode slabs, with and without the payload, and on the int8 wire,
   bit-exact against the plain host exchange and timed beside the byte
   bound and ``torch.stack``; ``stuck_wait_a2a`` (a late peer raises, naming
   its slab's site); ``serve_moe_ep4``: ``ServingEngine`` at world 4 on
   ``preset("mixtral-8x7b:ep", n_layers=8)`` (``serve_moe``'s weights and
   requests; K27, K8, K6/K7, K3/K5) with the padding share of K8's rows,
   its bf16 logits and a profile; ``serve_moe_ep4_q`` (the int8 wire over
   int8 banks, K24); ``f32_parity_ep`` (one f32 layer, world 4, both
   wires, greedy tokens on the card equal to the CPU plain path); and, at
   the end, ``layers_ep``: ``EPMoEMLP`` at Mixtral widths with two and three
   spans (K28), bit-identical to the whole-slab layer.
28. ragged expert rows (``GroupGemmConfig(ragged=True)``): the ragged
   grouped GEMM K29 (bf16, int8, fp8) on ``serve_moe_ep4``'s received
   prefill slab, and at world 4 the ragged AG-GroupGEMM K30 and
   MoE-Reduce-RS K31 at ``serve_moe_tp4``'s shard shapes, each against its
   plain twin and its padded kernel on the same inputs (live rows
   bit-equal, dead rows zero; K31 bit-equal), timed beside the padded
   kernel, the plain twin and the library over the packed live rows, the
   bound counting the live work; ``stuck_wait_ragged`` (K30 with a rank
   whose blocks are all dead still waits for it and raises with its
   record); ``serve_moe_ep4_ragged`` and ``serve_moe_tp4_ragged``: the
   padded serves' weights and requests under the ragged config, with the
   padding share of the rows computed beside the padded twin's, their
   tokens and bf16 logits against the padded serve's and the plain
   forward; ``f32_parity_ragged``: one f32 layer, world 4, EP and TP,
   greedy tokens on the card equal to the CPU plain path's and the padded
   serve's.

29. the chunked schedules (``GroupGemmConfig(chunks_per_shard=...,
   span_policy=...)``): at world 4, the chunked AG-GroupGEMM K32 at K9's
   served shapes (two spans at the default gather group, three or four
   with ``gather_group_blocks=4``, under ``contig``, ``window`` and
   ``torus2d``; int8, fp8 and ragged rows at two) and the chunked
   MoE-Reduce-RS K33 at K10's (two and three chunks under all four
   policies; int8, fp8, ragged at two), each bit-equal to its one-span
   kernel and timed beside it; a stuck K33 wait that must name chunk 0 of
   the late rank (in ``stuck_wait_moe``); ``serve_moe_tp4_chunked``:
   ``serve_moe_tp4``'s weights and requests under ``chunks_per_shard=2``
   (K32/K33 at prefill, K9/K10 at decode), greedy tokens equal to
   ``serve_moe_tp4``'s and bf16 prefill logits bit-equal to the one-span
   forward's; in ``layers_ring`` the overlapped ``TPMoEMLP`` at two spans
   (bit-equal to one span, timed beside the sequential and one-span
   layers) and one f32 ``tp_moe_mlp`` with ``backend="ragged_dot"``
   against the ``pallas`` backend.

30. ragged-row MoE training and long-context sequence-parallel training:
   the ragged weight gradient K34 at K11's Mixtral backward shapes under a
   real routing's ragged map (bit-equal to K11 on zeroed dead rows, NaN in
   G's dead rows changes nothing, timed beside K11); at world 4, ring
   attention K35 at Llama-3.1-8B attention widths, S 16384 (causal
   contiguous, causal zigzag, non-causal; and one world-1 call), each
   against its plain version and the SDPA golden; ``stuck_wait_ring_attention``
   (a late rank: fixed records); ``train_moe_ragged``: ``train_moe``'s
   configuration under ``GroupGemmConfig(ragged=True)`` beside the padded
   run (K29, K34; no K8, no K11), then one world-4 step (K30, K31);
   ``train_sp``: ``SPTransformer`` at Llama-3.1-8B widths, 2 layers, world
   4, S 8192, contiguous and zigzag (K35); ``f32_parity_sp`` (SP logits,
   loss, gradients and parameters against the plain path differentiated by
   PyTorch) and the ragged cases of ``f32_parity_train``.

31. the 2-D rank runtime (``initialize_distributed(mesh_shape=...)``):
   the hierarchical ring allgather K36 and the 2-D AG-GEMM K37
   (``csrc/ring.cu``) at 2 x 2, 2 x 4, 4 x 2 and over the swapped pair,
   K36 bit-exact and equal to K19 over the flattened ring, K37 bit-equal
   to K15 and within one bf16 ulp of its plain version, a 3-axis gather,
   each timed at 2 x 2 beside its 1-D twins (K19; K6 and K15);
   ``stuck_wait_2d`` (a late rank: the same entry-barrier site on every
   other rank); ``serve_moe_ep_hier``: ``preset("mixtral-8x7b:ep-hier",
   n_layers=8)`` through ``ServingEngine`` on ``{"dcn": 2, "tp": 2}``
   (K27 in both dispatch phases) beside ``serve_moe_ep4``; ``train_dp_tp``:
   ``train_step(dp_axis="dp")`` on ``{"dp": 2, "tp": 2}`` at
   Llama-3.1-8B widths, 2 layers (replicas bitwise equal across dp);
   ``layers_2d``: ``TPMLP`` and ``TPMoEMLP`` over ``("dp", "tp")`` at full
   width (the counted run of K36/K37); ``f32_parity_2d``: hierarchical
   greedy tokens against the flat EP serve and the CPU, and a dp x tp step
   against the plain path differentiated by PyTorch.

32. one-byte KV caches (``quantize_kv``, ``quantize_kv_fp8``): the
   quantized decode K38 at K2's served shapes, its paged twin K39 at K3's
   (a shuffled table, junk past each length) and the quantized verify K40
   at K13's (S 256 and 8 over a 2048-position cache), int8 and fp8, each
   held to its plain version and timed beside its bound, its plain
   version, the library (dequantize to bf16, SDPA) and the bf16 kernel
   (K2, K3, K13) on the same cache; the card's quantizer byte-equal to the
   CPU's; fp8 ranged-prefill chunk calls bit-equal to the whole-range
   call; then ``quant_kv_path``, the counted run of the op-level entries
   (world 1, and the int8 / fp8 SP decode, the fp8 ranged prefill and
   ``flash_decode_op`` at world 4 on the one card) against the world-1
   plain path, the SP entries timed.

33. the KV handoff stream: K41 (native wire) and K42 (int8 and fp8
   wires) at full width (every rank's [65536, 1024] slab, the KV of one
   Llama-3.1-8B prompt) at world 2 and 4, chunks 1, 2, 4, bit-exact
   against the plain exchange and timed beside its bound, the plain
   version and ``Tensor.copy_`` (with the quantize and dequantize on the
   one-byte wires); ``kv_stream_path``, the counted run of ``kv_stream_op``
   on every wire at world 4; ``stuck_wait_kv_stream``;
34. training on the 2-D runtime: ``train_moe_ep4`` (``mixtral-8x7b:ep``,
   8 layers, 2 x 1024 tokens, world 4) and ``train_moe_ep_hier``
   (``:ep-hier`` on ``{"dcn": 2, "tp": 2}``, ``dp_axis="dcn"``), each with
   falling bf16 losses, a moving router and an f32 small-width step
   against the CPU plain path; ``train_adam`` (``train_dense``'s model
   with Adam at world 1 and on ``{"dp": 2, "tp": 2}``, f32 Adam steps
   against the CPU); ``usp_attention`` (S 8192 on ``{"sp": 2, "tp": 2}``,
   K27 + K35, against the flat world-4 ring and SDPA).

The line before the last lists every kernel (K1-K42) with its readings;
the last is ``{"ok": true, "device": {...}}``. With no CUDA device, or
without the port beside it, the script prints no result and exits
non-zero.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator grows segments in place while the block runs
    (``expandable_segments``), and returns to fixed-size segments after it.
    For the training phases that run within a few GB of the card's 80 (the
    dp x tp Adam step ~61 GB, the hierarchical EP step ~73 GB): with
    fixed-size segments, blocks free but split (16-24 GB seen) ran them out
    of memory. Every other phase keeps the default allocator."""
    import torch

    settings = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
                or torch.cuda.memory._set_allocator_settings)  # older torch
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


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
        from triton_dist_tpu_torch.ops import all_to_all as a2a
        from triton_dist_tpu_torch.ops import allgather, allgather_gemm, common, gemm
        from triton_dist_tpu_torch.ops import flash_decode as fd
        from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
        from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
        from triton_dist_tpu_torch.ops import group_gemm as gg
        from triton_dist_tpu_torch.ops import kv_stream as kvs
        from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
        from triton_dist_tpu_torch.ops import reduce_scatter as rs
        from triton_dist_tpu_torch.ops import ring_attention as ra

        self.kernels = {
            "gemm": gemm.matmul,
            # K1's engines: wgmma + TMA, and mma.sync where TMA cannot load
            "gemm_wgmma": (gemm.matmul, "wgmma_launches"),
            "gemm_mma": (gemm.matmul, "mma_launches"),
            # K3 and K2 on the one-launch kernel (bf16 caches), K13 on wgmma + TMA
            "paged_flash_decode_onepass": (fd.paged_flash_decode, "onepass_launches"),
            "flash_decode_onepass": (fd.flash_decode, "onepass_launches"),
            "flash_verify_wgmma": (fd.flash_verify, "wgmma_launches"),
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
            "flash_verify": fd.flash_verify,
            "paged_flash_verify": fd.paged_flash_verify,
            "ag_gemm_ring": allgather_gemm._ag_gemm_ring,
            "gemm_rs_ring": grs._gemm_rs_ring,
            "gemm_rs_ring_chunked": grs._gemm_rs_ring_chunked,
            "reduce_scatter_ring": rs._ring_reduce_scatter,
            "reduce_scatter_ring_chunked": rs._ring_reduce_scatter_chunked,
            "all_gather_ring_1d": allgather._all_gather_ring_1d,
            "all_gather_ring_1d_chunked": allgather._all_gather_ring_1d_chunked,
            "all_gather_ring_bidir": allgather._all_gather_ring_bidir,
            "all_gather_ring_bidir_chunked": allgather._all_gather_ring_bidir_chunked,
            # the int8 / fp8 formats of K8, K9, K10 count apart (K24-K26)
            "group_gemm_scaled": (gg.group_gemm, "scaled_launches"),
            "ag_group_gemm_scaled": (aggg.ag_group_gemm_overlap, "scaled_launches"),
            "moe_reduce_rs_scaled": (mrs.moe_reduce_rs_overlap, "scaled_launches"),
            "all_to_all": a2a._a2a,
            "all_to_all_chunked": a2a._a2a_chunked,
            # the ragged-row forms of K8/K24, K9/K25, K10/K26 count apart (K29-K31)
            "group_gemm_ragged": (gg.group_gemm, "ragged_launches"),
            "ag_group_gemm_ragged": (aggg.ag_group_gemm_overlap, "ragged_launches"),
            "moe_reduce_rs_ragged": (mrs.moe_reduce_rs_overlap, "ragged_launches"),
            # the chunked schedules of K9/K25/K30 and K10/K26/K31 (K32, K33)
            "ag_group_gemm_chunked": (aggg.ag_group_gemm_overlap, "chunked_launches"),
            "moe_reduce_rs_chunked": (mrs.moe_reduce_rs_overlap, "chunked_launches"),
            # the ragged-row form of K11 (K34) counts apart; ring attention (K35)
            "group_gemm_dw_ragged": (gg.group_gemm_dw, "ragged_launches"),
            "ring_attention": ra.ring_attention,
            # the 2-D rings over an axis pair (K36, K37)
            "all_gather_2d": allgather._all_gather_ring_2d,
            "ag_gemm_2d": allgather_gemm._ag_gemm_ring_2d,
            # one-byte KV caches: K38 decode, K39 paged decode, K40 verify
            "flash_decode_quant": fd.flash_decode_quant,
            "paged_flash_decode_quant": (fd.paged_flash_decode, "quant_launches"),
            "flash_verify_quant": (fd.flash_verify, "quant_launches"),
            # the KV handoff stream: K41 native, K42 the one-byte wires (fp8 apart too)
            "kv_stream": kvs._kv_stream,
            "kv_stream_w8": kvs._kv_stream_w8,
            "kv_stream_fp8": (kvs._kv_stream_w8, "fp8_launches"),
        }
        self.plain = {
            "gemm": gemm._matmul_plain, "decode": fd._xla_decode,
            "barrier": common._barrier_plain, "all_gather": allgather._all_gather_xla,
            "ag_gemm": allgather_gemm._ag_gemm_xla, "gemm_rs": grs._gemm_rs_xla,
            "group_gemm": gg._group_gemm_plain, "ag_group_gemm": aggg._ag_overlap_xla,
            "moe_reduce_rs": mrs._moe_rs_overlap_xla,
            "group_gemm_dw": gg._group_gemm_dw_plain, "reduce_scatter": rs._reduce_scatter_xla,
            "verify": fd._xla_verify, "ag_gemm_ring": allgather_gemm._ag_gemm_ring_plain,
            "gemm_rs_ring": grs._gemm_rs_ring_plain,
            "reduce_scatter_ring": rs._reduce_scatter_ring_plain,
            "all_to_all": a2a._fast_all_to_all_xla,
            "ring_attention": ra._ring_attention_plain,
            "ag_gemm_2d": allgather_gemm._ag_gemm_2d_plain,
            "decode_quant": fd._plain_decode_quant, "verify_quant": fd._plain_verify_quant,
            "kv_stream": kvs._kv_stream_xla,
        }

    def _counters(self):
        for name, fn in self.kernels.items():
            yield (name, *fn) if isinstance(fn, tuple) else (name, fn, "launches")

    def reset(self) -> None:
        for _, fn, key in self._counters():
            setattr(fn, key, 0)
        for fn in self.plain.values():
            fn.calls = 0

    def read(self) -> dict:
        return {
            "launches": {name: getattr(fn, key) for name, fn, key in self._counters()},
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
    M = 8 x 256 rows (the wgmma + TMA engine, timed beside the earlier
    mma.sync engine in the same call), the same weights at the smaller
    admissions ``serve_paged`` sends (batch 8 x a prompt bucket of 32, 64
    or 128 tokens: 128x128 against 128x256), ragged shapes, the epilogue
    adds and the f32 route."""
    import torch
    from triton_dist_tpu_torch.ops import gemm as G
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain, matmul

    g = torch.Generator(device="cuda").manual_seed(1)

    def operands(m, n, k, dtype):
        a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        b = (torch.randn((k, n), generator=g, device="cuda") / math.sqrt(k)).to(dtype)
        return a, b

    # ragged edges (every engine: TMA-loadable or not) and the f32 kernel:
    # max |kernel - plain| over max |plain| — f32 products and sums in both,
    # only the order differs, so 1e-4 holds with a wide margin
    edges = {}
    for m, n, k, dtype in ((1, 1, 1, torch.bfloat16), (33, 17, 9, torch.bfloat16),
                           (100, 72, 40, torch.bfloat16), (257, 130, 100, torch.bfloat16),
                           (1, 8, 8, torch.bfloat16), (127, 136, 72, torch.bfloat16),
                           (129, 136, 200, torch.bfloat16), (2049, 520, 1000, torch.bfloat16),
                           (33, 17, 9, torch.float32), (300, 500, 700, torch.float32)):
        a, b = operands(m, n, k, dtype)
        adds = [torch.randn((m, n), generator=g, device="cuda") for _ in range(m % 3)]
        got = matmul(a, b, out_dtype=torch.float32, adds=adds)
        ref = _matmul_plain(a, b, torch.float32, adds)
        rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        if not rel <= 1e-4:
            raise AssertionError(f"gemm {m}x{n}x{k} {dtype}: rel err {rel}")
        engine = G.plan(m, n, k, dtype).engine
        edges[engine] = edges.get(engine, 0) + 1

    m = 8 * 256
    shapes = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    rows, admissions = [], {}
    total = dict(ms=0.0, prev_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 flops=0.0, bytes=0.0)
    worst = 0.0
    for name, (k, n) in shapes.items():
        a, b = operands(m, n, k, torch.bfloat16)
        ref = _matmul_plain(a, b, torch.bfloat16).float()
        # bf16 output: both round an f32 sum to bf16 (2^-8 relative), and the
        # sums differ in order, so a result may land one ulp apart
        tol = 2.0**-7 * ref.abs().max().item()
        errs = {}
        for engine in ("wgmma", "mma_sync"):
            errs[engine] = (matmul(a, b, _engine=engine).float() - ref).abs().max().item()
            if not errs[engine] <= tol:
                raise AssertionError(f"gemm {name} ({engine}): max abs err {errs[engine]}")
        worst = max(worst, errs["wgmma"])
        flops, nbytes = 2.0 * m * n * k, 2.0 * (m * k + k * n + m * n)
        b_ms, _ = bound(flops, nbytes)
        row = dict(
            shape=[m, k, n], max_abs_err=errs["wgmma"], prev_max_abs_err=errs["mma_sync"],
            tol=tol, config=G.plan(m, n, k, a.dtype).config,
            ms=cuda_ms(lambda: matmul(a, b), iters=10),
            prev_ms=cuda_ms(lambda: matmul(a, b, _engine="mma_sync"), iters=10),
            plain_ms=cuda_ms(lambda: _matmul_plain(a, b, torch.bfloat16), iters=5),
            library_ms=cuda_ms(lambda: torch.matmul(a, b), iters=10),
            bound_ms=b_ms,
        )
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "prev_ms", "plain_ms", "library_ms", "bound_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        # the served admissions below M = 2048: batch 8 x buckets 32, 64 and
        # 128 (the prompts of 32 to 128 tokens), both wgmma tiles timed
        for m_adm in (256, 512, 1024):
            a_adm = a[:m_adm].contiguous()
            ref_adm = _matmul_plain(a_adm, b, torch.bfloat16).float()
            err_adm = (matmul(a_adm, b).float() - ref_adm).abs().max().item()
            if not err_adm <= 2.0**-7 * ref_adm.abs().max().item():
                raise AssertionError(f"gemm {name} at M={m_adm}: max abs err {err_adm}")
            admissions.setdefault(f"m{m_adm}", {})[name] = dict(
                config=G.plan(m_adm, n, k, a.dtype).config,
                **{f"ms_config{c}": cuda_ms(lambda c=c: matmul(a_adm, b, _config=c), iters=20)
                   for c in (0, 1)},
                prev_ms=cuda_ms(lambda: matmul(a_adm, b, _engine="mma_sync"), iters=20),
                library_ms=cuda_ms(lambda: torch.matmul(a_adm, b), iters=20))
            del a_adm, ref_adm
        del a, b, ref
    emit({"phase": "kernel", "kernel": "gemm", "per_shape": rows,
          "prev_engine": "mma.sync (csrc/gemm_core.cuh Bf16Engine)",
          "admissions": admissions, "edge_cells_by_engine": edges,
          "sums": {k_: total[k_] for k_ in ("ms", "prev_ms", "library_ms", "bound_ms")}})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="gemm", route="cuda", source="triton_dist_tpu_torch/csrc/gemm.cu",
        replaces="triton_dist_tpu/ops/common.py:523",
        max_abs_err=worst, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=b_ms, bound_by=by, library_ms=total["library_ms"],
        prev_ms=total["prev_ms"], engine="wgmma + TMA (csrc/gemm_sm90.cuh)",
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
    d = 128, s_max = 1024, ragged lengths including 0 and s_max; the bf16
    cache on the one-launch kernel, the split engine beside it."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s = 8, 32, 8, 128, 1024
    lens = torch.tensor([0, 1, 17, 300, 513, 777, 1000, 1024], dtype=torch.int32,
                        device="cuda")
    q, k, v = _decode_inputs(b, hq, h_kv, d, s, torch.bfloat16, seed=2)
    before = fd.flash_decode.onepass_launches
    got = fd.flash_decode(q, k, v, lens, return_lse=True)
    if fd.flash_decode.onepass_launches != before + 1:
        raise AssertionError("flash_decode: the bf16 cache did not take the one-launch kernel")
    ref = fd._xla_decode(q, k, v, lens, return_lse=True)
    err = _check_decode("flash_decode", got, ref, lens, DECODE_TOL)
    prev = fd.flash_decode(q, k, v, lens, return_lse=True, _engine="split")
    prev_err = _check_decode("flash_decode (split)", prev, ref, lens, DECODE_TOL)
    again = fd.flash_decode(q, k, v, lens, return_lse=True)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("flash_decode: two calls differ (merge order or counters)")
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
        prev_ms=cuda_ms(lambda: fd.flash_decode(q, k, v, lens, return_lse=True,
                                                _engine="split"), iters=50),
        prev_max_abs_err=prev_err, engine="one launch (onepass_kernel, contiguous)",
        plain_ms=cuda_ms(lambda: fd._xla_decode(q, k, v, lens, return_lse=True), iters=20),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True), iters=50),
        shapes=f"b={b} hq={hq} h_kv={h_kv} d={d} s_max={s} lens={lens.tolist()}",
    )
    emit({"phase": "kernel", "kernel": "flash_decode", "fuse_heads_err": err_fh,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "prev_ms", "prev_max_abs_err",
                                      "plain_ms", "bound_ms", "library_ms", "shapes")}})
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
    before = fd.paged_flash_decode.onepass_launches
    got = fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True)
    if fd.paged_flash_decode.onepass_launches != before + 1:
        raise AssertionError("paged_flash_decode: the bf16 pool did not take the one-launch kernel")
    ref = fd._xla_paged_decode(q, kp, vp, lens, table, return_lse=True)
    err = _check_decode("paged_flash_decode", got, ref, lens, DECODE_TOL)
    prev = fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True, _engine="split")
    prev_err = _check_decode("paged_flash_decode (split)", prev, ref, lens, DECODE_TOL)
    again = fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("paged_flash_decode: two calls differ (merge order or counters)")

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
        prev_ms=cuda_ms(lambda: fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True,
                                                      _engine="split"), iters=50),
        prev_max_abs_err=prev_err, engine="one launch (paged_onepass_kernel)",
        plain_ms=cuda_ms(lambda: fd._xla_paged_decode(q, kp, vp, lens, table,
                                                      return_lse=True), iters=20),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, enable_gqa=True), iters=50),
        shapes=f"b={b} hq={hq} h_kv={h_kv} d={d} page={page} pages/seq={pps} "
               f"lens={lens.tolist()}",
    )
    # the one-launch call's memset of its b * h_kv arrival counters, alone
    zeroing_ms = cuda_ms(lambda: torch.zeros((b * h_kv,), dtype=torch.int32, device="cuda"),
                         iters=50)
    emit({"phase": "kernel", "kernel": "paged_flash_decode", "counter_zeroing_ms": zeroing_ms,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "prev_ms", "prev_max_abs_err",
                                      "plain_ms", "bound_ms", "library_ms", "shapes")}})
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
    # every served product is TMA-loadable (K, N multiples of 8, aligned), so
    # the rule sends all of them to the wgmma engine; the bf16 pool sends
    # every paged decode to the one-launch kernel
    if launches["gemm_wgmma"] <= 0 or launches["gemm_mma"] != 0:
        raise AssertionError(f"K1 engines on the served path: {launches}")
    if launches["paged_flash_decode_onepass"] != launches["paged_flash_decode"]:
        raise AssertionError(f"K3 engines on the served path: {launches}")
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
    if (launches["flash_decode"] <= 0 or launches["flash_decode_onepass"] <= 0
            or launches["gemm"] <= 0 or any(plain.values())):
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
    from triton_dist_tpu_torch.models.tp_transformer import init_params
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
    _check_tp4_logits("serve_tp4_logits", cfg, params, reqs, ctx)
    phase_decode_profile_tp4(cfg, params, ctx)
    ctx.close()
    return launches


def _check_tp4_logits(name, cfg, params, reqs, ctx) -> None:
    """Prefill last-row logits at world 4 (the projections on ``ctx``'s
    kernels) against the world-1 plain-GEMM forward on the same card, same
    weights, same prompts (bf16)."""
    import torch
    from triton_dist_tpu_torch.models.tp_transformer import TPTransformer, shard_params
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain

    L = 128
    pcfg = dataclasses.replace(cfg, seq=L)
    flat = _prompt_tokens(reqs, cfg.batch, L)
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
    # relative, in two summation orders (and K7 rounds each rank's partial,
    # the ring at every hop)
    if not (torch.isfinite(got).all().item() and rel <= 5e-2):
        raise AssertionError(f"{name}: world-4 prefill logits vs world-1 plain: rel L2 {rel}")
    emit({"phase": name, "rows": cfg.batch, "prompt_len": L,
          "rel_l2_err": rel, "max_abs_err": (got - ref).abs().max().item(),
          "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
          "tol_rel_l2": 5e-2, "reference": "world 1, plain GEMMs"})


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


def phase_f32_parity_tp4(ring: bool = False) -> None:
    """f32, 2 layers at full 70B width, world 4: greedy tokens of the kernel
    path on the card (K6/K7 f32 engines, K3, K5; with `ring` a ring context
    and two spans a shard: K15, K17) identical to the world-4 plain path
    (the wrappers' CPU twins, ranks as CPU threads, the same context)."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(TP_MODEL, n_layers=2, batch=4, dtype=torch.float32)
    if ring:
        cfg = _ring_tp_cfg(cfg)
    params = init_params(cfg, seed=3)
    params_cpu = {
        "embed": params["embed"].cpu(), "final_norm": params["final_norm"].cpu(),
        "lm_head": params["lm_head"].cpu(),
        "layers": [{k: v.cpu() for k, v in p.items()} for p in params["layers"]],
    }
    # the ring check feeds fewer new tokens: its CPU reference is the cost
    lengths, max_new = [12, 20, 33, 40], 4 if ring else 8

    def run(p, device):
        ctx = initialize_distributed(WORLD, device=device)
        ctx.full_mesh = not ring
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
    name = "f32_parity_tp4_ring" if ring else "f32_parity_tp4"
    if got != want:
        raise AssertionError(f"{name}: world-4 f32 greedy tokens differ: {got} vs {want}")
    emit({"phase": name, "model": TP_MODEL, "n_layers": 2, "world": WORLD,
          "full_mesh": not ring, "requests": len(lengths), "max_new_tokens": max_new,
          "identical": True, "cpu_reference_s": t_cpu, "card_s": t_card})


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
    moe_rs family, site 1. Then K33 (two spans) with rank 1 held just after
    its entry barrier: rank 0's record must name chunk 0 of rank 1
    (family moe_rs_chunked, site 18)."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import group_gemm as gg
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
    ctx.close()

    # K33 with two spans, rank 1 held 2 s just after its entry barrier (its
    # barrier passes, its spans are late): rank 0's reduce must name chunk
    # 0 of rank 1, site 2 + 1 * MAX_SPANS + 0
    ctx = initialize_distributed(2)
    tw, ids = _moe_route(g, 512, 8, 2)
    ral = mu.moe_align_ranked(ids.reshape(2, -1), 8, MOE_BLOCK, 256)
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, 256, 2)
    hs = torch.randn((2 * ral.t_pad_loc, 64), generator=g, device="cuda")
    cfg = gg.GroupGemmConfig(MOE_BLOCK, chunks_per_shard=2)
    barrier = mrs.launch_barrier

    def late(ctx_, launch, flags, stream):
        barrier(ctx_, launch, flags, stream)
        if ctx_.rank == 1 and stuck:
            with torch.cuda.stream(stream):
                common.sleep_on_stream(2_000_000_000)

    def chunked():
        return mrs.moe_reduce_rs_overlap(hs, wd, ral.expert_ids, dst, w_rows, ctx=ctx,
                                         m_out=256, combine_rows=inv, config=cfg)

    mrs.launch_barrier = late
    try:
        stuck = False
        ctx.run(chunked)
        stuck = True
        with config.wait_timeout(0.2):
            ctx.run(chunked)
    except DistTimeoutError as err:
        chunk_recs = err.records
    else:
        raise AssertionError("a stuck K33 wait did not raise")
    finally:
        mrs.launch_barrier = barrier
    if [(r["pe"], r["family"], r["site"]) for r in chunk_recs] != [(0, "moe_rs_chunked", 18)]:
        raise AssertionError(f"stuck K33 wait: unexpected records {chunk_recs}")
    emit({"phase": "stuck_wait_moe", "records": recs, "chunked_records": chunk_recs})
    ctx.close()


def _moe_models():
    """The two forwards of the MoE logits check, each keeping its layers'
    routing ``(weights, ids)`` in ``.routes``:

    - the served forward (``TPMoETransformer``, or ``EPMoETransformer``
      for an expert-parallel config; kernels), unchanged: each
      layer's routing is recomputed after the layer from the same input by
      the same operations, so it is bitwise the routing the layer used;
    - the world-1 reference: plain GEMMs for the projections and the plain
      grouped GEMMs for the experts (the sequential composition of
      ``ops/moe_mlp.py`` with every kernel replaced by its plain version).
      Given ``replay`` (one ``(weights, ids)`` a layer), it takes those
      expert choices instead of its own.
    """
    import torch
    from triton_dist_tpu_torch.models.tp_transformer import (
        EPMoETransformer, EPMoETransformerConfig, TPMoETransformer, rmsnorm,
    )
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain

    def route(cfg, x, p):
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        return h, mu.select_experts(h.float() @ p["router"].float(), cfg.topk)

    def recording(base):
        class Served(base):
            def _mlp(self, x, p):
                out = super()._mlp(x, p)
                self.routes.append(route(self.cfg, x, p)[1])
                return out

        return Served

    # the tensor-parallel and the expert-parallel served forwards
    served = {False: recording(TPMoETransformer), True: recording(EPMoETransformer)}

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
            # quantized banks: the plain scaled twins (upcast, fold)
            hs = gg._group_gemm_plain(mu.gather_sorted_rows(h, al, c.topk), p["w_up"],
                                      al.expert_ids, MOE_BLOCK, h.dtype, None,
                                      p.get("w_up_scale"))
            y = gg._group_gemm_plain(hs, p["w_down"], al.expert_ids, MOE_BLOCK, torch.float32,
                                     gg.gelu, p.get("w_down_scale"))
            return mu.scatter_add_unsorted(y, al, tw, h.shape[0]).to(x.dtype)

    def make(cls, cfg, replay=None, ctx=None):
        model = cls(cfg, ctx=ctx)
        model.routes, model.replay = [], replay
        return model

    return (lambda cfg, ctx=None: make(served[isinstance(cfg, EPMoETransformerConfig)], cfg,
                                       ctx=ctx),
            lambda cfg, replay=None: make(Plain, cfg, replay))


# the MoE serves' readings and greedy tokens by phase name, for the ragged
# serves' comparison with their padded twins in the same run
SERVES = {}


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
    _serve.outputs = {uid: res.tokens for uid, res in done.items()}
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
    from triton_dist_tpu_torch.ops.moe_mlp import tp_moe_mlp
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.utils import tally

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
    tp_moe_mlp.rows = tp_moe_mlp.assignments = 0
    tp_moe_mlp.live_rows = {}
    tp4 = _serve(cfg, params, reqs, counters, ctx=ctx)
    tp4["padding_row_share"] = 1 - tp_moe_mlp.assignments / tally(tp_moe_mlp.live_rows)
    SERVES["serve_moe_tp4"] = dict(tp4, outputs=_serve.outputs)
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
    """f32, one MoE layer at full Mixtral width (cut from two to keep the
    script near half its time limit: the world-4 CPU reference was ~100 s
    at two): greedy tokens of the kernel
    path on the card (K8 f32 at world 1; K9, K10, K6, K7 f32 at world 4)
    identical to the plain path on the CPU (the wrappers' twins), TF32 off."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(MOE_MODEL, n_layers=1, batch=4, dtype=torch.float32)
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
    emit({"phase": "f32_parity_moe", "model": MOE_MODEL, "n_layers": 1, "worlds": [1, WORLD],
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
    params, loss = ttm.train_step(warm or model, init(), tokens, targets, lr=lr, dp_axis=None)
    losses, walls = [loss.item()], []
    counters.reset()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = ttm.train_step(model, params, tokens, targets, lr=lr, dp_axis=None)
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
    prof = _profile(lambda: ttm.train_step(model, params, tokens, targets, lr=lr, dp_axis=None))
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
    TRAIN_READINGS["train_moe"] = {k: one[k] for k in ("losses", "step_wall_s_median",
                                                       "train_tokens_per_s", "peak_mem_gb")}
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
                                        targets, lr=TRAIN_LR, dp_axis=None)
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


def _train_worst(world, rank_outs, ref, params, cfg) -> dict:
    """The worst relative errors of each rank's ``(loss, gradients, (new
    params, step loss))`` against the plain path's ``(loss, gradients)`` on
    the whole parameters: each split leaf compared on the rank's shard."""
    from triton_dist_tpu_torch.models import tp_transformer as ttm

    loss_ref, g_ref = ref
    splits = ttm._tree_leaves(ttm._tree_map(lambda _, s: s, params, ttm.specs_for(cfg)))
    leaves = ttm._tree_leaves(params)
    worst = dict(loss_rel=0.0, grad_rel_l2=0.0, param_rel_l2=0.0)
    for r, (loss, grads, (new, step_loss)) in enumerate(rank_outs):
        worst["loss_rel"] = max(worst["loss_rel"], abs(loss - loss_ref.item()) / abs(
            loss_ref.item()), abs(step_loss - loss_ref.item()) / abs(loss_ref.item()))
        for g, want, p, split, q in zip(grads, g_ref, leaves, splits, ttm._tree_leaves(new)):
            if split is not None and world > 1:
                want = want.chunk(world, split)[r]
                p = p.chunk(world, split)[r]
            worst["grad_rel_l2"] = max(worst["grad_rel_l2"], _rel_l2(g, want))
            worst["param_rel_l2"] = max(worst["param_rel_l2"], _rel_l2(q, p - TRAIN_LR * want))
    return worst


def _ragged_vs_padded(model, step_model, params, tokens, targets, padded, routes) -> dict:
    """The ragged step's loss, gradients and updated parameters against the
    padded step's ``(loss, gradients, new params)`` on the same weights;
    the routing (recorded by `model`) must be the padded run's."""
    from triton_dist_tpu_torch.models import tp_transformer as ttm

    loss_p, grads_p, new_p = padded
    loss, grads = ttm._loss_and_grads(model, params, tokens, targets)
    worst = dict(loss_rel=abs(loss.item() - loss_p) / abs(loss_p),
                 grad_rel_l2=max(_rel_l2(g, w) for g, w in zip(grads, grads_p)),
                 routing_flip_share=_flips(model.routes, routes))
    del grads
    new, _ = ttm.train_step(step_model, params, tokens, targets, lr=TRAIN_LR, dp_axis=None)
    worst["param_rel_l2"] = max(_rel_l2(q, p) for q, p in zip(ttm._tree_leaves(new),
                                                              ttm._tree_leaves(new_p)))
    return worst


def _check_ragged_parity(world, worst) -> None:
    if (any(worst["routing_flip_share"]) or not (worst["loss_rel"] <= 1e-5
                                                 and worst["grad_rel_l2"] <= 1e-4
                                                 and worst["param_rel_l2"] <= 1e-4)):
        raise AssertionError(f"f32 ragged train parity at world {world}: {worst}")


def phase_f32_parity_train() -> None:
    """f32, 2 MoE layers at full Mixtral width, batch 2 x 1024: one
    train_step at world 1 and at world 4 on the card against the plain
    path on the card (plain GEMMs and grouped GEMMs, differentiated by
    PyTorch's autograd) on the same weights and expert choices, TF32 off:
    the loss within 1e-5 relative, every gradient leaf (each rank's shard)
    and every updated parameter within 1e-4 relative L2. Then the ragged
    cases: the same step under ``GroupGemmConfig(ragged=True)`` at world 1
    and 4 (K29/K30/K31 forward, K29 and K34 backward) against the padded
    step on the same routing, to the same tolerances."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(MOE_MODEL, n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.float32)
    tokens, targets = _train_batch(cfg.vocab, seed=55)
    params = ttm.init_moe_params(cfg, seed=54)
    make_recorded, make_plain = _train_models()
    report = {}

    def reference(routes):
        return ttm._loss_and_grads(make_plain(cfg, replay=routes), params, tokens, targets)

    def compare(world, rank_outs, ref):
        worst = report[world] = _train_worst(world, rank_outs, ref, params, cfg)
        if not (worst["loss_rel"] <= 1e-5 and worst["grad_rel_l2"] <= 1e-4
                and worst["param_rel_l2"] <= 1e-4):
            raise AssertionError(f"f32 train parity at world {world}: {worst}")

    model = make_recorded(cfg)
    loss, grads = ttm._loss_and_grads(model, params, tokens, targets)
    routes = model.routes
    new, step_loss = ttm.train_step(make_recorded(cfg), params, tokens, targets, lr=TRAIN_LR,
                                    dp_axis=None)
    ref = reference(routes)
    compare(1, [(loss.item(), grads, (new, step_loss.item()))], ref)
    # the ragged step on the same routing against the padded step
    rcfg = dataclasses.replace(cfg, gg_config=GroupGemmConfig(MOE_BLOCK, ragged=True))
    ragged = {1: _ragged_vs_padded(make_recorded(rcfg), make_recorded(rcfg), params, tokens,
                                   targets, (loss.item(), grads, new), routes)}
    _check_ragged_parity(1, ragged[1])
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
                                        lr=TRAIN_LR, dp_axis=None)
        return (loss.item(), grads, (new, step_loss.item())), model.routes

    outs = ctx.run(rank, grad=True)
    # the ranks route their own token shards: rank order is token order
    routes4 = [torch.cat([o[1][li] for o in outs]) for li in range(cfg.n_layers)]
    flips = _flips(routes4, routes)
    if any(flips):  # the plain path takes world 4's expert choices instead
        del ref
        ref = reference(routes4)
    compare(WORLD, [o[0] for o in outs], ref)
    del ref
    torch.cuda.empty_cache()

    def rank_ragged():
        r = ctx.rank
        t = tokens[r * m_loc:(r + 1) * m_loc]
        (loss_p, grads_p, (new_p, _)), routes_p = outs[r]
        return _ragged_vs_padded(make_recorded(rcfg, ctx=ctx), make_recorded(rcfg, ctx=ctx),
                                 shards[r], t, targets, (loss_p, grads_p, new_p), routes_p)

    worst4 = ctx.run(rank_ragged, grad=True)
    ragged[WORLD] = {k: max(w[k] for w in worst4) for k in ("loss_rel", "grad_rel_l2",
                                                           "param_rel_l2")}
    ragged[WORLD]["routing_flip_share"] = [max(f) for f in zip(*(w["routing_flip_share"]
                                                                  for w in worst4))]
    _check_ragged_parity(WORLD, ragged[WORLD])
    ctx.close()
    emit({"phase": "f32_parity_train", "model": MOE_MODEL, "n_layers": 2, "worlds": [1, WORLD],
          "reference": "world 1, plain kernels on the card, PyTorch autograd, the kernel "
                       "path's expert choices", "worst": report,
          "ragged_vs_padded": ragged,
          "routing_flip_share_world4_vs_world1": flips,
          "tol": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "param_rel_l2": 1e-4}})


# ------------------------------------------------ ranged prefill (slice 5) ----

VERIFY_SHAPE = dict(b=8, hq=32, h_kv=8, d=128, s=2048)   # Llama-3.1-8B decode widths


def _verify_tol(ref, dtype) -> float:
    """bf16 cache: one bf16 ulp of the output scale (the kernel rounds the
    probabilities to bf16 before P.V, as the TPU kernel does; the plain
    version keeps them in f32); f32: 1e-5 of the output scale (the same
    f32 products in another order)."""
    import torch

    scale = ref[torch.isfinite(ref)].abs().max().item()
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _check_verify(name, got, ref, lens, dtype) -> float:
    """max |out| and |lse| errors within their tolerances; rows with
    kv_len == 0 must give out = 0 and lse = -inf exactly."""
    import torch

    (o, l), (ro, rl) = got, ref
    empty = lens == 0
    live = ~empty[..., None].expand_as(l)
    err_o, err_l = (o - ro).abs().max().item(), (l[live] - rl[live]).abs().max().item()
    tol_o, tol_l = _verify_tol(ro, dtype), _verify_tol(rl, dtype)
    if not (err_o <= tol_o and err_l <= tol_l):
        raise AssertionError(f"{name}: out err {err_o} (tol {tol_o}), lse err {err_l} "
                             f"(tol {tol_l})")
    if empty.any() and not ((o[empty] == 0).all().item()
                            and torch.isneginf(l[empty]).all().item()):
        raise AssertionError(f"{name}: kv_len == 0 must give out 0, lse -inf")
    return max(err_o / tol_o, err_l / tol_l)


def _ranged_lens(b, S, s, gen):
    """Per-row prefix lengths of a batcher's ranged pass over an s-position
    cache: sequence 0 the range's target, rows attend pos0 + i + 1;
    sequences 1.. parked at s_max (every row its whole cache), with one
    more target-like row set and a zero-length row (a rank that holds none
    of the prefix yet) for coverage."""
    import torch

    pos0 = torch.randint(0, s - S + 1, (b,), generator=gen, device="cuda")
    lens = pos0[:, None] + torch.arange(1, S + 1, device="cuda")[None, :]
    lens[2:] = s                          # parked slots
    lens[1] = torch.arange(1, S + 1)      # a first chunk (pos0 = 0)
    lens[1, 0] = 0
    return lens.clamp(0, s).to(torch.int32).contiguous()


def _verify_bound(lens, S, hq, h_kv, d, itemsize) -> tuple[float, str]:
    """Operations and bytes this run's lengths need: 4 FLOPs per (row,
    head, cached position, head-dim column); q read, each sequence's cache
    up to its longest row read once, out and lse written."""
    b = lens.shape[0]
    flops = 4.0 * hq * d * float(lens.sum().item())
    max_len = lens.max(dim=1).values.sum().item()
    nbytes = (b * S * hq * d * itemsize + 2 * h_kv * max_len * d * itemsize
              + b * S * hq * (d + 1) * 4 + 4 * b * S)
    return bound(flops, nbytes)


def _verify_library(q, k, v, lens):
    """SDPA on the same rows (q [b, hq, S, d], a [b, 1, S, s] length
    mask): the library yardstick, timed and used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    mask = (torch.arange(k.shape[2], device="cuda")[None, None, :]
            < lens[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, enable_gqa=True)


def _verify_inputs(S, dtype, seed, d=None):
    """q, k, v at the served shapes (another head dim with `d`) and the
    ranged pass's per-row lengths."""
    import torch

    sh = dict(VERIFY_SHAPE, d=d or VERIFY_SHAPE["d"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((sh["b"], S, sh["hq"], sh["d"]), generator=gen, device="cuda").to(dtype)
    k = torch.randn((sh["b"], sh["h_kv"], sh["s"], sh["d"]), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((sh["b"], sh["h_kv"], sh["s"], sh["d"]), generator=gen,
                    device="cuda").to(dtype)
    return q, k, v, _ranged_lens(sh["b"], S, sh["s"], gen)


def phase_flash_verify() -> dict:
    """K13 at the served shapes: 8B widths (32 query / 8 kv heads, d 128),
    batch 8, a 2048-position cache, S = 256 (a prefill chunk), S = 8 (a
    speculative verify) and S = 1 (a one-position chunk), parked-full,
    ragged and empty rows; a soft-cap case and d = 96 and 64 cases; bf16
    (the wgmma + TMA engine, each case also on the mma.sync engine) and
    f32."""
    import torch
    from triton_dist_tpu_torch.ops import flash_decode as fd

    worst = prev_worst = 0.0
    for S, dtype, cap, d in ((256, torch.bfloat16, 0.0, None), (8, torch.bfloat16, 0.0, None),
                             (1, torch.bfloat16, 0.0, None), (64, torch.bfloat16, 30.0, None),
                             (64, torch.bfloat16, 0.0, 96), (8, torch.bfloat16, 5.0, 64),
                             (64, torch.float32, 0.0, None), (37, torch.float32, 5.0, 96)):
        q, k, v, lens = _verify_inputs(S, dtype, seed=11 + S, d=d)
        cfg = fd.FlashDecodeConfig(soft_cap=cap)
        name = f"flash_verify S={S} {dtype} cap={cap} d={q.shape[-1]}"
        before = fd.flash_verify.wgmma_launches
        got = fd.flash_verify(q, k, v, lens, config=cfg, return_lse=True)
        if fd.flash_verify.wgmma_launches != before + (dtype == torch.bfloat16):
            raise AssertionError(f"{name}: the bf16 cache did not take the wgmma engine")
        ref = fd._xla_verify(q, k, v, lens, return_lse=True, soft_cap=cap)
        worst = max(worst, _check_verify(name, got, ref, lens, dtype))
        if dtype == torch.bfloat16:
            prev_worst = max(prev_worst, _check_verify(
                f"{name} (mma.sync)", fd.flash_verify(q, k, v, lens, config=cfg,
                                                      return_lse=True, _engine="mma"),
                ref, lens, dtype))
    S = 256
    q, k, v, lens = _verify_inputs(S, torch.bfloat16, seed=11 + S)
    sh = VERIFY_SHAPE
    b_ms, by = _verify_bound(lens, S, sh["hq"], sh["h_kv"], sh["d"], 2)
    got = fd.flash_verify(q, k, v, lens, return_lse=True)
    again = fd.flash_verify(q, k, v, lens, return_lse=True)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("flash_verify: two calls differ")
    ref = fd._xla_verify(q, k, v, lens, return_lse=True)
    prev = fd.flash_verify(q, k, v, lens, return_lse=True, _engine="mma")
    entry = dict(
        name="flash_verify", route="cuda",
        source="triton_dist_tpu_torch/csrc/flash_verify.cu",
        replaces="triton_dist_tpu/ops/flash_decode.py:618",
        max_abs_err=(got[0] - ref[0]).abs().max().item(),
        ms=cuda_ms(lambda: fd.flash_verify(q, k, v, lens, return_lse=True), iters=10),
        prev_ms=cuda_ms(lambda: fd.flash_verify(q, k, v, lens, return_lse=True, _engine="mma"),
                        iters=10),
        prev_max_abs_err=(prev[0] - ref[0]).abs().max().item(),
        engine="wgmma + TMA (verify_sm90_kernel)",
        plain_ms=cuda_ms(lambda: fd._xla_verify(q, k, v, lens, return_lse=True), iters=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(_verify_library(q, k, v, lens), iters=10),
        shapes=f"b=8 S={S} hq=32 h_kv=8 d=128 s=2048, 6 of 8 sequences parked (full "
               f"cache), bf16",
    )
    emit({"phase": "kernel", "kernel": "flash_verify", "worst_err_over_tol": worst,
          "prev_worst_err_over_tol": prev_worst,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "prev_ms", "prev_max_abs_err",
                                      "plain_ms", "bound_ms", "library_ms", "shapes")}})
    return entry


def _paged_pool(k, v, page, gen, share: int):
    """The cache as a page pool behind a shuffled block table in which
    sequences 2.. name sequence 1's first `share` pages: shared prefix
    pages, as under the prefix cache."""
    import torch

    b, h_kv, s, d = k.shape
    pps = s // page
    table = torch.randperm(b * pps, generator=gen, device="cuda").reshape(b, pps)
    table[2:, :share] = table[1, :share]

    def pool(x):
        pages = x.reshape(b, h_kv, pps, page, d).transpose(1, 2)   # [b, pps, h_kv, page, d]
        p = torch.zeros((b * pps, h_kv, page, d), dtype=x.dtype, device="cuda")
        p[table[:, share:].reshape(-1)] = pages[:, share:].reshape(-1, h_kv, page, d)
        p[table[:2, :share].reshape(-1)] = pages[:2, :share].reshape(-1, h_kv, page, d)
        return p

    return pool(k), pool(v), table.to(torch.int32).contiguous()


def phase_paged_flash_verify() -> dict:
    """K14 at the served shapes: the engine's pool of 16-token pages, a
    shuffled block table whose rows share prefix pages, S = 256 and 8, a
    soft-cap case and a d = 96 case; bf16 and f32."""
    import torch
    from triton_dist_tpu_torch.ops import flash_decode as fd

    page = 16
    worst = 0.0
    for S, dtype, cap, d in ((256, torch.bfloat16, 0.0, None), (8, torch.bfloat16, 0.0, None),
                             (64, torch.bfloat16, 30.0, None), (64, torch.bfloat16, 0.0, 96),
                             (64, torch.float32, 0.0, None), (37, torch.float32, 5.0, 96)):
        q, k, v, lens = _verify_inputs(S, dtype, seed=21 + S, d=d)
        gen = torch.Generator(device="cuda").manual_seed(S)
        kp, vp, table = _paged_pool(k, v, page, gen, share=32)
        worst = max(worst, _check_verify(
            f"paged_flash_verify S={S} {dtype} cap={cap} d={q.shape[-1]}",
            fd.paged_flash_verify(q, kp, vp, lens, table, soft_cap=cap, return_lse=True),
            fd._xla_paged_verify(q, kp, vp, lens, table, return_lse=True, soft_cap=cap),
            lens, dtype))
    S = 256
    q, k, v, lens = _verify_inputs(S, torch.bfloat16, seed=21 + S)
    kp, vp, table = _paged_pool(k, v, page, torch.Generator(device="cuda").manual_seed(S),
                                share=32)
    kc, vc = fd._paged_to_contiguous(kp, table), fd._paged_to_contiguous(vp, table)
    sh = VERIFY_SHAPE
    b_ms, by = _verify_bound(lens, S, sh["hq"], sh["h_kv"], sh["d"], 2)
    entry = dict(
        name="paged_flash_verify", route="cuda",
        source="triton_dist_tpu_torch/csrc/flash_verify.cu",
        replaces="triton_dist_tpu/ops/flash_decode.py:846",
        max_abs_err=(fd.paged_flash_verify(q, kp, vp, lens, table, return_lse=True)[0]
                     - fd._xla_paged_verify(q, kp, vp, lens, table, return_lse=True)[0]
                     ).abs().max().item(),
        ms=cuda_ms(lambda: fd.paged_flash_verify(q, kp, vp, lens, table, return_lse=True),
                   iters=10),
        plain_ms=cuda_ms(lambda: fd._xla_paged_verify(q, kp, vp, lens, table,
                                                      return_lse=True), iters=3, warmup=1),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_ms(_verify_library(q, kc, vc, lens), iters=10),
        shapes=f"b=8 S={S} hq=32 h_kv=8 d=128 page=16 pages/seq=128 (32 shared), 6 of 8 "
               f"sequences parked, bf16",
    )
    emit({"phase": "kernel", "kernel": "paged_flash_verify", "worst_err_over_tol": worst,
          **{k_: entry[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "shapes")}})
    return entry


def _timed_serve(eng, reqs, spacing_s: float) -> dict:
    """Serve `reqs` arriving `spacing_s` apart (engine clock) and record,
    for every decode round, the host wall time since the previous one ended
    and whether prefill work (a bulk admission or ranged chunks) ran in
    between: the decode stall an admission causes."""
    import torch
    from triton_dist_tpu_torch.serving.traffic import Arrival

    b = eng._batcher
    decode_round = b._decode_round
    gaps = []
    mark = {"t": time.perf_counter(), "work": b.prefill_work_total}

    def timed():
        decode_round()  # ends in a device-to-host read of the step's tokens
        now = time.perf_counter()
        gaps.append((now - mark["t"], b.prefill_work_total > mark["work"]))
        mark["t"], mark["work"] = now, b.prefill_work_total

    b._decode_round = timed
    t_base = eng.clock.monotonic()
    traffic = [Arrival(t_s=t_base + i * spacing_s, request=r) for i, r in enumerate(reqs)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark["t"] = t0
    done = eng.serve(traffic)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(r.uid for r in reqs):
        raise AssertionError(f"serve finished {sorted(done)}")
    for uid, res in done.items():
        if len(res.tokens) != reqs[0].max_new_tokens or not all(
                0 <= t < eng.cfg.vocab for t in res.tokens):
            raise AssertionError(f"{uid}: bad tokens {res.tokens}")
    n_tok = sum(len(r.tokens) for r in done.values())
    ttft = [done[r.uid].ttft_ms for r in reqs]
    with_prefill = [g for g, w in gaps if w]
    decode_only = sorted(g for g, w in gaps if not w)
    return dict(
        wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall, ttft_ms=ttft,
        ttft_ms_max=max(ttft), ttft_ms_median=sorted(ttft)[len(ttft) // 2],
        decode_rounds=len(gaps),
        max_gap_with_prefill_ms=1e3 * max(with_prefill) if with_prefill else None,
        median_gap_decode_only_ms=(1e3 * decode_only[len(decode_only) // 2]
                                   if decode_only else None),
        prefill_work=b.prefill_work_total, prefill_tokens=b.prefill_tokens_total,
        done=done,
    )


def phase_ranged_serving(counters: Counters) -> tuple[dict, dict]:
    """``serve_chunked`` and ``serve_prefix``: Llama-3.1-8B widths, 32
    layers, bf16, batch 8, paged cache of 16-token pages, prefill=True.
    Chunked: 8 prompts of 512-1536 tokens (2-6 chunks of 256), 32 new
    tokens each, arriving 0.25 s apart, s_max 2048; then the same requests
    admitted in bulk. Prefix: 8 requests sharing one 512-token system
    prompt, each with its own 32-128 token suffix, 32 new tokens, arriving
    0.25 s apart, s_max 1024, with the radix prefix cache; then the same
    requests without it. The main-path runs (chunked, cached) read the
    launch counts: K14 and K3 carried them, no plain version ran."""
    import numpy as np
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher, Request
    from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig
    from triton_dist_tpu_torch.models.tp_transformer import init_params
    from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine

    cfg = presets.preset("llama-3.1-8b", n_layers=32, batch=8, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    max_new, spacing = 32, 0.25

    def main_path(name, run):
        counters.reset()
        out = run()
        counts = counters.read()
        launches, plain = counts["launches"], counts["plain_calls"]
        if launches["paged_flash_verify"] <= 0 or launches["paged_flash_decode"] <= 0:
            raise AssertionError(f"{name}: served path skipped a kernel: {launches}")
        if any(plain.values()):
            raise AssertionError(f"{name}: plain versions ran on the card path: {plain}")
        return out, launches

    # serve_chunked
    lengths = [512, 640, 768, 896, 1024, 1152, 1280, 1536]
    reqs = _requests(cfg.vocab, lengths, max_new, seed=21)

    def engine(s_max, **serving):
        return ServingEngine(cfg, params, s_max=s_max, page_size=16, prefill=True,
                             serving=ServingConfig(max_queue=64, **serving))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunked, ch_launches = main_path("serve_chunked", lambda: _timed_serve(
        engine(2048, prefill_chunk_tokens=256), reqs, spacing))
    peak = torch.cuda.max_memory_allocated() / 1e9
    bulk = _timed_serve(engine(2048), reqs, spacing)
    same = sum(chunked["done"][r.uid].tokens == bulk["done"][r.uid].tokens for r in reqs)
    # one 256-token chunk (positions [256, 512) of a 1024-token prompt)
    # profiled: K14's share of the pass, and the share of K14's work that
    # goes to the seven parked slots (each row attends all 2048 positions)
    bt = ContinuousBatcher(cfg, params, s_max=2048, page_size=16, prefill=True,
                           prefill_chunk_tokens=256)
    bt.submit(_requests(cfg.vocab, [1024], max_new, seed=26)[0])
    bt._admit()
    bt._chunk_pass()            # the first chunk, a warm-up
    prof = _profile(bt._chunk_pass)
    del bt
    target = sum(256 + i + 1 for i in range(256))
    parked = (cfg.batch - 1) * 256 * 2048
    prof["paged_flash_verify_ms"] = sum(ms for name, ms in prof["top_kernels_ms"].items()
                                        if "verify_mma_kernel" in name)
    prof["parked_share_of_verify_work"] = parked / (parked + target)
    drop = ("done",)
    emit({"phase": "serve_chunked", "model": "llama-3.1-8b", "n_layers": 32, "batch": 8,
          "s_max": 2048, "page_size": 16, "prefill_chunk_tokens": 256,
          "prompt_lens": lengths, "max_new_tokens": max_new, "arrival_spacing_s": spacing,
          "chunked": {k_: v_ for k_, v_ in chunked.items() if k_ not in drop},
          "bulk": {k_: v_ for k_, v_ in bulk.items() if k_ not in drop},
          "requests_with_identical_tokens": same, "peak_mem_gb": peak,
          "chunk_profile": prof, "launches": ch_launches})

    # serve_prefix
    rng = np.random.default_rng(22)
    system = [int(t) for t in rng.integers(0, cfg.vocab, 512)]
    suffixes = [32, 45, 64, 77, 90, 100, 115, 128]
    preqs = [Request(system + [int(t) for t in rng.integers(0, cfg.vocab, n)],
                     max_new_tokens=max_new, uid=f"p{i}") for i, n in enumerate(suffixes)]
    holder = {}

    def cached_run():
        eng = engine(1024, prefix_cache=PrefixCacheConfig())
        holder["eng"] = eng
        return _timed_serve(eng, preqs, spacing)

    cached, px_launches = main_path("serve_prefix", cached_run)
    stats = holder.pop("eng").snapshot()["prefix_cache"]
    if stats["hits"] != len(preqs) - 1 or stats["prefill_tokens_saved"] <= 0:
        raise AssertionError(f"serve_prefix: expected one miss and 7 hits: {stats}")
    uncached = _timed_serve(engine(1024), preqs, spacing)
    same_px = sum(cached["done"][r.uid].tokens == uncached["done"][r.uid].tokens
                  for r in preqs)

    def split(res):
        out = {k_: v_ for k_, v_ in res.items() if k_ not in drop}
        out["ttft_ms_miss"] = res["ttft_ms"][0]
        out["ttft_ms_hits_median"] = sorted(res["ttft_ms"][1:])[len(preqs[1:]) // 2]
        return out

    emit({"phase": "serve_prefix", "model": "llama-3.1-8b", "n_layers": 32, "batch": 8,
          "s_max": 1024, "page_size": 16, "system_prompt": 512, "suffix_lens": suffixes,
          "max_new_tokens": max_new, "arrival_spacing_s": spacing,
          "cached": split(cached), "uncached": split(uncached),
          "prefix_cache": stats, "requests_with_identical_tokens": same_px,
          "launches": px_launches})
    return ch_launches, px_launches


def phase_chunked_contiguous(counters: Counters) -> dict:
    """Chunked prefill over the contiguous cache (K13 and K2) at 8B widths,
    4 layers: 4 prompts of 300-700 tokens in 128-token chunks."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_params

    cfg = presets.preset("llama-3.1-8b", n_layers=4, batch=4, dtype=torch.bfloat16)
    params = init_params(cfg, seed=1)
    batcher = ContinuousBatcher(cfg, params, s_max=1024, prefill=True,
                                prefill_chunk_tokens=128)
    reqs = _requests(cfg.vocab, [300, 420, 555, 700], 16, seed=23)
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
        raise AssertionError("chunked contiguous serve did not finish every request")
    if (launches["flash_verify_wgmma"] <= 0 or launches["flash_decode_onepass"] <= 0
            or any(plain.values())):
        raise AssertionError(f"chunked contiguous path: {counts}")
    emit({"phase": "serve_chunked_contiguous", "n_layers": 4, "wall_s": wall,
          "prefill_chunk_tokens": 128, "tokens": sum(len(t) for t in done.values()),
          **counts})
    return launches


def _verify_composes(fd, dtype, paged) -> None:
    """K13/K14: a whole-range ranged call and the calls over its chunks
    give every row's (out, lse) bit for bit, at 8B widths."""
    import torch

    b, S, hq, h_kv, d, s, page = 4, 256, 32, 8, 128, 2048, 16
    gen = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((b, S, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h_kv, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h_kv, s, d), generator=gen, device="cuda").to(dtype)
    pos0 = torch.tensor([0, 300, 1792, s], device="cuda")   # the last row parked
    if paged:
        kp, vp, table = _paged_pool(k, v, page, gen, share=8)
        run = lambda qq, ll: fd.paged_flash_verify(qq, kp, vp, ll, table,  # noqa: E731
                                                   return_lse=True)
    else:
        run = lambda qq, ll: fd.flash_verify(qq, k, v, ll, return_lse=True)  # noqa: E731
    before = fd.flash_verify.wgmma_launches
    whole = run(q, fd._ranged_local_lens(pos0, S, 0, s))
    for lo, hi in ((0, 1), (1, 100), (100, 256)):
        part = run(q[:, lo:hi].contiguous(), fd._ranged_local_lens(pos0 + lo, hi - lo, 0, s))
        if not (torch.equal(part[0], whole[0][:, lo:hi])
                and torch.equal(part[1], whole[1][:, lo:hi])):
            raise AssertionError(f"{'paged_' if paged else ''}flash_verify {dtype}: chunk "
                                 f"[{lo}, {hi}) differs from the whole-range call")
    # the contiguous bf16 calls ran K13's wgmma engine (one consumer
    # warpgroup on the 1-position chunk, two on the others)
    if fd.flash_verify.wgmma_launches != before + 4 * (not paged and dtype == torch.bfloat16):
        raise AssertionError(f"flash_verify {dtype}: the composition calls missed the wgmma "
                             f"engine")


def phase_f32_parity_ranged() -> None:
    """f32, 2 layers at 8B widths, world 1 and world 4 on the card, TF32
    off: chunked = bulk = token-fed greedy tokens; prefix-cache hit = miss
    = token-fed prefix-cache run; a 2-layer Mixtral-width MoE chunked =
    token-fed at world 1. K13/K14 whole-range = chunk calls bit for bit
    (f32 and bf16). ``prefill_cache_ranged``: a whole range and its
    composition from chunks padded to the same rows, as the batcher pads
    them, within 1e-6 relative L2 (logits rows, written K/V) at world 1
    and 4; unpadded chunks within 1e-5; its logits within 1e-5 relative L2
    of the CPU twin and of the world-1 pass at world 4."""
    import numpy as np
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import decode as dec
    from triton_dist_tpu_torch.models.prefix_cache import PrefixCacheConfig
    from triton_dist_tpu_torch.models.tp_transformer import (
        init_moe_params, init_params, shard_params,
    )
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for paged in (False, True):
            _verify_composes(fd, dtype, paged)

    def tokens(cfg, params, reqs, ctx=None, sequential=False, **kw):
        b = dec.ContinuousBatcher(cfg, params, s_max=256, device="cuda", ctx=ctx, **kw)
        out = {}
        for group in ([[r] for r in reqs] if sequential else [reqs]):
            for r in group:
                b.submit(r)
            out.update(dict(b.run()))
        return out, b

    cfg = presets.preset("llama-3.1-8b", n_layers=2, batch=4, dtype=torch.float32)
    params = init_params(cfg, seed=5)
    rng = np.random.default_rng(24)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab, 48)]
    tail = lambda n: [int(t) for t in rng.integers(0, cfg.vocab, n)]  # noqa: E731
    cls_reqs = _requests(cfg.vocab, [40, 57, 70], 6, seed=25)
    a = prefix + tail(13)
    px_reqs = [dec.Request(a, max_new_tokens=6, uid="a"),
               dec.Request(list(a), max_new_tokens=6, uid="b"),
               dec.Request(prefix + tail(21), max_new_tokens=6, uid="c")]
    report = {}
    for world in (1, WORLD):
        ctx = initialize_distributed(world) if world > 1 else None
        tok, _ = tokens(cfg, params, cls_reqs, ctx, page_size=16)
        bulk, _ = tokens(cfg, params, cls_reqs, ctx, page_size=16, prefill=True)
        chunk, _ = tokens(cfg, params, cls_reqs, ctx, page_size=16, prefill=True,
                          prefill_chunk_tokens=16)
        if not tok == bulk == chunk:
            raise AssertionError(f"world {world}: chunked {chunk} / bulk {bulk} / token-fed "
                                 f"{tok} differ")
        px_kw = dict(page_size=16, prefix_cache=PrefixCacheConfig())
        px_tok, _ = tokens(cfg, params, px_reqs, ctx, sequential=True, **px_kw)
        px_pre, bt = tokens(cfg, params, px_reqs, ctx, sequential=True, prefill=True, **px_kw)
        stats = bt.prefix_cache_stats()
        if not (px_pre == px_tok and px_pre["a"] == px_pre["b"] and stats["hits"] >= 2):
            raise AssertionError(f"world {world}: prefix hit/miss/token-fed differ: "
                                 f"{px_pre} vs {px_tok} ({stats})")
        report[world] = dict(prefix_hits=stats["hits"],
                             prefill_tokens_saved=stats["prefill_tokens_saved"])
        if ctx is not None:
            ctx.close()

    # prefill_cache_ranged: whole range vs chunks (world 1 and 4), vs the CPU
    # twin (world 1), on the paged cache. As the batcher runs them, the
    # chunks are padded to the whole range's row count (their pad rows write
    # junk past the chunk, which the next chunk overwrites), so every
    # projection runs at the same M: cuBLAS picks its algorithm by M, and
    # unpadded chunks (other M) differ from the whole pass by f32
    # summation-order noise at K = 4096, held to 1e-5 and reported.
    spec = dec.PagedKVCacheSpec(256, 16, static_table=True)
    L = 64
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (cfg.batch, L)))

    def ranged(p, device, splits, ctx=None, pad=False):
        cache = spec.init(cfg, device, 1 if ctx is None else ctx.world)
        rows, lo = [], 0
        for hi in splits:
            t = toks[:, lo:hi]
            if pad:
                t = torch.nn.functional.pad(t, (0, L - (hi - lo)))
            logits, cache = dec.prefill_cache_ranged(cfg, p, cache, t.to(device), lo,
                                                     spec=spec, ctx=ctx)
            rows.append(logits[:, :hi - lo].float())
            lo = hi
        # K/V of positions [0, L) (this rank's part of them): logical pages
        # 0 .. L/16 - 1 of every slot, on the rank that owns them
        pages = cache["block_table"][0][:, :L // 16].reshape(-1).long()
        own = ctx is None or ctx.rank * (256 // ctx.world) < L
        kv = (cache["k"][:, pages], cache["v"][:, pages]) if own else None
        return torch.cat(rows, dim=1), kv

    def composition(whole, parts):
        out = {"logits": _rel_l2(parts[0], whole[0])}
        if whole[1] is not None:
            out.update(k=_rel_l2(parts[1][0], whole[1][0]), v=_rel_l2(parts[1][1], whole[1][1]))
        return max(out.values())

    with torch.inference_mode():
        whole = ranged(params, "cuda", [L])
        comp = composition(whole, ranged(params, "cuda", [24, L], pad=True))
        comp_unpadded = composition(whole, ranged(params, "cuda", [24, L]))
        params_cpu = {k_: v_.cpu() for k_, v_ in params.items() if k_ != "layers"}
        params_cpu["layers"] = [{k_: v_.cpu() for k_, v_ in p.items()} for p in params["layers"]]
        twin = ranged(params_cpu, "cpu", [L])
        del params_cpu
    twin_err = _rel_l2(whole[0].cpu(), twin[0])
    ctx = initialize_distributed(WORLD)
    shards = shard_params(params, WORLD, ctx.devices)
    w4 = ctx.run(lambda: (ranged(shards[ctx.rank], "cuda", [L], ctx),
                          ranged(shards[ctx.rank], "cuda", [24, L], ctx, pad=True)))
    ctx.close()
    comp4 = max(composition(w_, p_) for w_, p_ in w4)
    w4_vs_w1 = _rel_l2(w4[0][0][0], whole[0])
    if not (comp <= 1e-6 and comp4 <= 1e-6 and comp_unpadded <= 1e-5 and twin_err <= 1e-5
            and w4_vs_w1 <= 1e-5):
        raise AssertionError(f"ranged pass: composition {comp} (unpadded {comp_unpadded}) / "
                             f"world 4 {comp4}, CPU twin {twin_err}, world 4 vs 1 {w4_vs_w1}")

    # MoE: chunked = token-fed at world 1
    mcfg = presets.preset(MOE_MODEL, n_layers=2, batch=4, dtype=torch.float32)
    del params, shards
    torch.cuda.empty_cache()
    mparams = init_moe_params(mcfg, seed=34)
    m_reqs = _requests(mcfg.vocab, [33, 50], 6, seed=35)
    m_tok, _ = tokens(mcfg, mparams, m_reqs, page_size=16)
    m_chunk, _ = tokens(mcfg, mparams, m_reqs, page_size=16, prefill=True,
                        prefill_chunk_tokens=16)
    if m_tok != m_chunk:
        raise AssertionError(f"MoE chunked {m_chunk} vs token-fed {m_tok}")
    emit({"phase": "f32_parity_ranged", "n_layers": 2, "worlds": [1, WORLD],
          "identical": True, "verify_chunks_bit_identical": True,
          "ranged_composition_rel_l2": comp, "ranged_composition_rel_l2_world4": comp4,
          "ranged_composition_unpadded_rel_l2": comp_unpadded,
          "ranged_vs_cpu_twin_rel_l2": twin_err, "ranged_world4_vs_world1_rel_l2": w4_vs_w1,
          "prefix": report, "moe_chunked_identical": True,
          "tol": {"composition_rel_l2": 1e-6, "composition_unpadded_rel_l2": 1e-5,
                  "cpu_twin_rel_l2": 1e-5, "world4_vs_world1_rel_l2": 1e-5},
          "seconds": time.perf_counter() - t_start})


# ------------------------------------------------------ the rings (slice 6) ----

RING_CHUNKS = 2  # AGGemmConfig / GemmRSConfig chunks_per_shard of serve_tp4_ring


def _check_ring(name, got, plain, library, world):
    """A ring kernel's bf16 output against its plain version (the ring's
    own hop order and rounding, one bf16 ulp of the output scale) and the
    library golden (one f32 sum rounded once: the ring rounds n-1 times,
    so n-1 ulps); f32 within 1e-5 of the scale against both."""
    import torch

    scale = plain.float().abs().max().item()
    bf16 = got.dtype == torch.bfloat16
    err = (got.float() - plain.float()).abs().max().item()
    err_lib = (got.float() - library.float()).abs().max().item()
    tol = (2.0**-7 if bf16 else 1e-5) * scale
    tol_lib = (2.0**-7 * (world - 1) if bf16 else 1e-5) * scale
    if not (err <= tol and err_lib <= tol_lib):
        raise AssertionError(f"{name}: max abs err {err} (tol {tol}) against the plain ring, "
                             f"{err_lib} (tol {tol_lib}) against the library")
    return err, err_lib


def phase_ag_gemm_ring(ctx) -> dict:
    """K15 on a ring context at K6's shapes (a 4-way Llama-3.1-70B prefill,
    512 rows a rank: wqkv, gate/up, LM head), one span and two a shard:
    bf16 against the ring's plain version and the gathered A bit-exact; f32
    at the wqkv shape. The bound is K6's: the same work and bytes."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops.common import ring_spans

    g = torch.Generator(device="cuda").manual_seed(62)
    m_loc, k = 512, 8192
    rows, worst = [], 0.0
    total = dict(ms=0.0, ms_one_span=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for name, n_loc in (("wqkv", 2560), ("gate_up", 14336), ("lm_head", 32064)):
        # f32 first: the timings below read the last (bf16) operands
        dtypes = (torch.float32, torch.bfloat16) if name == "wqkv" else (torch.bfloat16,)
        row = dict(shape=[m_loc, k, n_loc])
        for dtype in dtypes:
            a = [torch.randn((m_loc, k), generator=g, device="cuda").to(dtype)
                 for _ in range(WORLD)]
            b = [(torch.randn((k, n_loc), generator=g, device="cuda") / k**0.5).to(dtype)
                 for _ in range(WORLD)]
            for chunks in (1, RING_CHUNKS):
                cfg = agg.AGGemmConfig(chunks_per_shard=chunks)
                spans = ring_spans(m_loc, chunks, cfg.block_m)
                outs = ctx.run(lambda: (
                    agg.ag_gemm(a[ctx.rank], b[ctx.rank], ctx=ctx, config=cfg,
                                gather_output=True),
                    agg._ag_gemm_ring_plain(a[ctx.rank], b[ctx.rank], ctx, False, dtype, spans)))
                a_full = torch.cat(a)
                err = 0.0
                for r, ((out, ag), plain) in enumerate(outs):
                    if not torch.equal(ag, a_full):
                        raise AssertionError(f"ag_gemm ring {name}: gathered A not bit-exact")
                    err = max(err, _check_ring(f"ag_gemm ring {name} chunks {chunks} rank {r}",
                                               out, plain, plain, WORLD)[0])
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                row[f"max_abs_err_{str(dtype)[6:]}_chunks{chunks}"] = err
                del outs
                if dtype == torch.bfloat16:
                    row[f"ms_chunks{chunks}"] = dist_ms(ctx, lambda: agg.ag_gemm(
                        a[ctx.rank], b[ctx.rank], ctx=ctx, config=cfg), iters=5)
        row["plain_ms"] = dist_ms(ctx, lambda: agg._ag_gemm_ring_plain(
            a[ctx.rank], b[ctx.rank], ctx, False, torch.bfloat16, spans), iters=2)
        row["library_ms"] = cuda_ms(lambda: [torch.matmul(torch.cat(a), b[r])
                                             for r in range(WORLD)], iters=3)
        flops = WORLD * 2.0 * WORLD * m_loc * k * n_loc
        nbytes = 2.0 * (WORLD * m_loc * k + WORLD * k * n_loc + WORLD * WORLD * m_loc * n_loc)
        row["bound_ms"] = bound(flops, nbytes)[0]
        rows.append({name: row})
        total["ms"] += row[f"ms_chunks{RING_CHUNKS}"]
        total["ms_one_span"] += row["ms_chunks1"]
        for key in ("plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b
    emit({"phase": "kernel", "kernel": "ag_gemm_ring", "world": WORLD, "per_shape": rows,
          "ms_chunks1_summed": total["ms_one_span"],
          f"ms_chunks{RING_CHUNKS}_summed": total["ms"]})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="ag_gemm_ring", route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
        replaces="triton_dist_tpu/ops/allgather_gemm.py:109", max_abs_err=worst,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"], ms_one_span=total["ms_one_span"],
        shapes=f"world {WORLD} ring: a [512, 8192] a rank; n_loc 2560, 14336, 32064 "
               f"(summed); ms at chunks_per_shard {RING_CHUNKS}, ms_one_span at 1",
    )


def phase_gemm_rs_ring(ctx) -> list[dict]:
    """K16 (one span) and K17 (chunks 2 and 3; its one-span launch
    bit-equal to K16) on a ring context at K7's shapes (2048 rows, wo and
    down, N 8192): bf16 against the ring's plain version and the library
    golden; f32 at the wo shape. The bound is K7's."""
    import torch
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.ops.common import ring_spans

    g = torch.Generator(device="cuda").manual_seed(63)
    m_tot, n = 2048, 8192
    m_loc = m_tot // WORLD
    chunk_set = (1, RING_CHUNKS, 3)
    rows, worst = [], {c: 0.0 for c in chunk_set}
    total = {c: 0.0 for c in chunk_set}
    total.update(plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for name, k_loc in (("wo", 2048), ("down", 7168)):
        # f32 first: the timings below read the last (bf16) operands
        dtypes = (torch.float32, torch.bfloat16) if name == "wo" else (torch.bfloat16,)
        row = dict(shape=[m_tot, k_loc, n])
        for dtype in dtypes:
            a = [torch.randn((m_tot, k_loc), generator=g, device="cuda").to(dtype)
                 for _ in range(WORLD)]
            b = [(torch.randn((k_loc, n), generator=g, device="cuda") / (WORLD * k_loc)**0.5)
                 .to(dtype) for _ in range(WORLD)]
            library = sum(a[r].float() @ b[r].float() for r in range(WORLD)).to(dtype)
            for chunks in chunk_set:
                cfg = grs.GemmRSConfig(chunks_per_shard=chunks)
                spans = ring_spans(m_loc, chunks, cfg.block_m)
                outs = ctx.run(lambda: (
                    grs.gemm_rs(a[ctx.rank], b[ctx.rank], ctx=ctx, method="ring", config=cfg),
                    grs._gemm_rs_ring_plain(a[ctx.rank], b[ctx.rank], ctx, dtype, spans)))
                err = err_lib = 0.0
                for r, (out, plain) in enumerate(outs):
                    e = _check_ring(f"gemm_rs ring {name} chunks {chunks} rank {r}", out, plain,
                                    library[r * m_loc:(r + 1) * m_loc], WORLD)
                    err, err_lib = max(err, e[0]), max(err_lib, e[1])
                if dtype == torch.bfloat16:
                    worst[chunks] = max(worst[chunks], err)
                row[f"max_abs_err_{str(dtype)[6:]}_chunks{chunks}"] = err
                row[f"max_abs_err_library_{str(dtype)[6:]}_chunks{chunks}"] = err_lib
                if chunks == 1:  # K17 with one span is K16, bit for bit
                    one = ctx.run(lambda: grs._gemm_rs_ring_chunked(
                        a[ctx.rank], b[ctx.rank], ctx, dtype, ((0, m_loc),)))
                    if not all(torch.equal(x, o) for x, (o, _) in zip(one, outs)):
                        raise AssertionError(f"gemm_rs ring {name}: one span not bit-equal")
                del outs
                if dtype == torch.bfloat16:
                    row[f"ms_chunks{chunks}"] = dist_ms(ctx, lambda: grs.gemm_rs(
                        a[ctx.rank], b[ctx.rank], ctx=ctx, method="ring", config=cfg), iters=5)
        row["plain_ms"] = dist_ms(ctx, lambda: grs._gemm_rs_ring_plain(
            a[ctx.rank], b[ctx.rank], ctx, torch.bfloat16, ((0, m_loc),)), iters=2)
        row["library_ms"] = cuda_ms(lambda: sum(torch.matmul(a[r], b[r])
                                                for r in range(WORLD)), iters=3)
        flops = WORLD * 2.0 * m_tot * k_loc * n
        nbytes = 2.0 * (WORLD * m_tot * k_loc + WORLD * k_loc * n + m_tot * n)
        row["bound_ms"] = bound(flops, nbytes)[0]
        rows.append({name: row})
        for c in chunk_set:
            total[c] += row[f"ms_chunks{c}"]
        for key in ("plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b, library
    emit({"phase": "kernel", "kernel": "gemm_rs_ring", "world": WORLD, "per_shape": rows,
          **{f"ms_chunks{c}_summed": total[c] for c in chunk_set}})
    b_ms, by = bound(total["flops"], total["bytes"])
    common = dict(route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
                  plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
                  library_ms=total["library_ms"])
    shapes = f"world {WORLD} ring: a [2048, k_loc] a rank, k_loc 2048 and 7168, N 8192 (summed)"
    return [
        dict(name="gemm_rs_ring", replaces="triton_dist_tpu/ops/gemm_reduce_scatter.py:147",
             max_abs_err=worst[1], ms=total[1], shapes=shapes, **common),
        dict(name="gemm_rs_ring_chunked",
             replaces="triton_dist_tpu/ops/gemm_reduce_scatter.py:187",
             max_abs_err=max(worst[RING_CHUNKS], worst[3]), ms=total[RING_CHUNKS],
             ms_chunks3=total[3], shapes=f"{shapes}; ms at chunks_per_shard {RING_CHUNKS}",
             **common),
    ]


def phase_reduce_scatter_ring(ctx) -> dict:
    """K18 on a ring context at K12's shape (the MoE backward's dx at world
    4, [2048, 4096] a rank), f32 and bf16, against the ring's plain version
    (the same adds in the same order: bit-exact) and the library golden.
    The bound is K12's."""
    import torch
    from triton_dist_tpu_torch.ops import reduce_scatter as rs

    g = torch.Generator(device="cuda").manual_seed(64)
    m_tot, n = TRAIN_B * TRAIN_S, 4096
    m_loc = m_tot // WORLD
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = [torch.randn((m_tot, n), generator=g, device="cuda").to(dtype)
             for _ in range(WORLD)]
        library = sum(t.float() for t in x).to(dtype)
        outs = ctx.run(lambda: (rs.reduce_scatter(x[ctx.rank], ctx=ctx, method="ring"),
                                rs._reduce_scatter_ring_plain(x[ctx.rank], ctx)))
        worst = (0.0, 0.0)
        for r, (got, plain) in enumerate(outs):
            e = _check_ring(f"reduce_scatter ring {dtype} rank {r}", got, plain,
                            library[r * m_loc:(r + 1) * m_loc], WORLD)
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        errs[str(dtype)] = dict(max_abs_err=worst[0], max_abs_err_library=worst[1])
        del outs

    def library_fn():
        return [torch.stack([x[p][r * m_loc:(r + 1) * m_loc] for p in range(WORLD)]).sum(0)
                for r in range(WORLD)]

    nbytes = 4.0 * WORLD * (m_tot * n + m_loc * n)
    b_ms, by = bound(WORLD * (WORLD - 1) * m_loc * n, nbytes)
    entry = dict(
        name="reduce_scatter_ring", route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
        replaces="triton_dist_tpu/ops/reduce_scatter.py:102",
        max_abs_err=errs[str(torch.float32)]["max_abs_err"],
        ms=dist_ms(ctx, lambda: rs.reduce_scatter(x[ctx.rank], ctx=ctx, method="ring"),
                   iters=10),
        plain_ms=dist_ms(ctx, lambda: rs._reduce_scatter_ring_plain(x[ctx.rank], ctx), iters=5),
        bound_ms=b_ms, bound_by=by, library_ms=event_ms(library_fn, iters=5),
        library="torch.stack + sum of the four ranks' slices",
        shapes=f"world {WORLD} ring: [{m_tot}, {n}] f32 a rank -> [{m_loc}, {n}]",
    )
    emit({"phase": "kernel", "kernel": "reduce_scatter_ring", "world": WORLD, "checks": errs,
          **{k_: entry[k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms", "shapes")}})
    return entry


def phase_stuck_wait_ring() -> None:
    """A ring kernel whose neighbour never comes in time: rank 1's stream
    is held 2 s before its ring GEMM-RS, the wait timeout is 0.2 s. Rank 0
    must raise with its record (the gemm_rs_ring family, site 1: the
    arrival of its right neighbour, rank 1), not hang."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(2)
    ctx.full_mesh = False
    a = torch.randn((64, 128), device="cuda")
    b = torch.randn((128, 256), device="cuda")

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return grs.gemm_rs(a, b, ctx=ctx)

    stuck = False
    ctx.run(call)  # the buffers and flags exist
    stuck = True
    t0 = time.perf_counter()
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck ring wait did not raise")
    if [(r["pe"], r["family"], r["site"]) for r in recs] != [(0, "gemm_rs_ring", 1)]:
        raise AssertionError(f"stuck ring wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_ring", "raised_after_s": time.perf_counter() - t0,
          "records": recs})
    ctx.close()


def _ring_tp_cfg(cfg):
    from triton_dist_tpu_torch.ops.allgather_gemm import AGGemmConfig
    from triton_dist_tpu_torch.ops.gemm_reduce_scatter import GemmRSConfig

    return dataclasses.replace(cfg, ag_config=AGGemmConfig(chunks_per_shard=RING_CHUNKS),
                               rs_config=GemmRSConfig(chunks_per_shard=RING_CHUNKS))


def phase_serve_tp4_ring(counters: Counters) -> dict:
    """``serve_tp4`` on a ring context: the same model, weights and traffic
    (Llama-3.1-70B widths, 8 of 80 layers, bf16, batch 8, 8 requests),
    ``ctx.full_mesh = False`` and ``ag_config``/``rs_config`` with two
    spans a shard: the column projections of every prefill run K15, the
    row projections K17; no full-mesh projection kernel (K6, K7) runs.
    Then its prefill logits against the world-1 plain forward."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers, max_new = 8, 32
    cfg = _ring_tp_cfg(presets.preset(TP_MODEL, n_layers=n_layers, batch=8,
                                      dtype=torch.bfloat16))
    params = init_params(cfg, seed=10)
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, max_new, seed=15)
    ctx = initialize_distributed(WORLD)
    ctx.full_mesh = False
    res = _serve(cfg, params, reqs, counters, ctx=ctx)
    launches = res["launches"]
    used = ("ag_gemm_ring", "gemm_rs_ring_chunked", "all_gather", "paged_flash_decode")
    if any(launches[k] <= 0 for k in used) or launches["ag_gemm"] or launches["gemm_rs"]:
        raise AssertionError(f"serve_tp4_ring did not run on the ring kernels: {launches}")
    emit({"phase": "serve_tp4_ring", "model": TP_MODEL, "n_layers": n_layers, "world": WORLD,
          "full_mesh": False, "chunks_per_shard": RING_CHUNKS, "batch": 8, "s_max": 1024,
          "page_size": 16, "prompt_lens": lengths, "max_new_tokens": max_new, **res})
    _check_tp4_logits("serve_tp4_ring_logits", cfg, params, reqs, ctx)
    ctx.close()
    return launches


def phase_train_ring(counters: Counters) -> dict:
    """One f32 train step at world 4 on a ring context, Mixtral-8x7B widths
    cut to 2 layers (batch 2 x 1024, default configs: one span), against
    the plain path on the card differentiated by PyTorch given the same
    expert choices: the loss within 1e-5 relative, every gradient shard and
    updated parameter within 1e-4 relative L2. The projections run K15 and
    K16 forward and backward, the MoE backward's dx K18; K6, K7 and K12 do
    not run."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.preset(MOE_MODEL, n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.float32)
    tokens, targets = _train_batch(cfg.vocab, seed=57)
    params = ttm.init_moe_params(cfg, seed=56)
    make_recorded, make_plain = _train_models()
    ctx = initialize_distributed(WORLD)
    ctx.full_mesh = False
    shards = ttm.shard_params(params, WORLD, ctx.devices)
    m_loc = tokens.numel() // WORLD

    def rank():
        r = ctx.rank
        t = tokens[r * m_loc:(r + 1) * m_loc]
        model = make_recorded(cfg, ctx=ctx)
        loss, grads = ttm._loss_and_grads(model, shards[r], t, targets)
        new, step_loss = ttm.train_step(make_recorded(cfg, ctx=ctx), shards[r], t, targets,
                                        lr=TRAIN_LR, dp_axis=None)
        return (loss.item(), grads, (new, step_loss.item())), model.routes

    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    outs = ctx.run(rank, grad=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    launches, plain = counts["launches"], counts["plain_calls"]
    used = ("ag_gemm_ring", "gemm_rs_ring", "reduce_scatter_ring", "ag_group_gemm",
            "moe_reduce_rs", "group_gemm", "group_gemm_dw")
    if (any(launches[k] <= 0 for k in used) or launches["ag_gemm"] or launches["gemm_rs"]
            or launches["reduce_scatter"]):
        raise AssertionError(f"train_ring did not run on the ring kernels: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card path: {plain}")
    routes = [torch.cat([o[1][li] for o in outs]) for li in range(cfg.n_layers)]
    ref = ttm._loss_and_grads(make_plain(cfg, replay=routes), params, tokens, targets)
    worst = _train_worst(WORLD, [o[0] for o in outs], ref, params, cfg)
    ctx.close()
    tol = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "param_rel_l2": 1e-4}
    if any(worst[k] > v for k, v in tol.items()):
        raise AssertionError(f"train_ring against the plain path: {worst}")
    emit({"phase": "train_ring", "model": MOE_MODEL, "n_layers": 2, "world": WORLD,
          "full_mesh": False, "tokens": TRAIN_B * TRAIN_S, "step_wall_s": wall,
          "loss": outs[0][0][0], "worst": worst, "tol": tol,
          "reference": "world 1, plain kernels on the card, PyTorch autograd, the ring "
                       "path's expert choices", **counts})
    return launches


# ------------------------------- the ring collectives and the layer tier ----

# (kernels-line name, method, chunked, the Pallas kernel it replaces)
RING_GATHERS = (
    ("all_gather_ring_1d", "ring_1d", False, "triton_dist_tpu/ops/allgather.py:73"),
    ("all_gather_ring_1d_chunked", "ring_1d", True, "triton_dist_tpu/ops/allgather.py:144"),
    ("all_gather_ring_bidir", "ring_bidir", False, "triton_dist_tpu/ops/allgather.py:102"),
    ("all_gather_ring_bidir_chunked", "ring_bidir", True,
     "triton_dist_tpu/ops/allgather.py:191"),
)
JITTER = 100_000  # comm_jitter's base in the race-shaking pass: ~0.2-2 ms a rank


def _gather_shapes():
    """The two payloads of the ring gathers, each with the chunk counts it
    runs at: the SP combine at Llama-3.1-70B decode widths ([b*hq +
    ceil(b*hq/d), d] f32 a rank, K5's shape) and the Mixtral token slab of
    the sequential MoE MLP ([512, 4096] bf16 a rank)."""
    import torch

    rows = 8 * 64 + math.ceil(8 * 64 / 128)
    return {"sp_combine": ((rows, 128), torch.float32, (1, 2)),
            "moe_tokens": ((512, 4096), torch.bfloat16, (1, 2, 4))}


def phase_ring_collectives(ctx) -> list[dict]:
    """On the world-4 ring context: K19-K22 at the two payloads of
    :func:`_gather_shapes`, each held bit for bit to the plain gather
    (``_all_gather_xla``, also the golden: a gather is a copy); K23 at
    K12's shape ([2048, 4096] a rank, f32 and bf16, chunks 2 and 3), bit
    for bit equal to K18 and to its ring-order plain version, and within
    n-1 bf16 ulps (f32 1e-5) of the library golden; then a second pass of
    every ring kernel (K15-K23) with the race-shaking delay on, whose
    outputs must be bit-identical to the first pass's."""
    import torch
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.ops.common import ring_spans

    g = torch.Generator(device="cuda").manual_seed(71)
    shapes = _gather_shapes()
    xs = {name: [torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for _ in range(WORLD)] for name, (shape, dtype, _) in shapes.items()}
    per_shape = {}
    for name, (shape, dtype, _) in shapes.items():
        x = xs[name]
        shard = x[0].numel() * x[0].element_size()
        per_shape[name] = dict(
            plain_ms=dist_ms(ctx, lambda: ag._all_gather_xla(x[ctx.rank], ctx), iters=20),
            library_ms=cuda_ms(lambda: [torch.cat(x) for _ in range(WORLD)], iters=20),
            bytes=WORLD * shard * (1.0 + WORLD))
    entries = []
    for kname, method, chunked, replaces in RING_GATHERS:
        row = {}
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0)
        for name, (shape, dtype, chunk_set) in shapes.items():
            x, want = xs[name], torch.cat(xs[name])
            runs = [c for c in chunk_set if (c > 1) == chunked]
            for c in runs:
                outs = ctx.run(lambda: (
                    ag.all_gather(x[ctx.rank], ctx=ctx, method=method, chunks_per_shard=c),
                    ag._all_gather_xla(x[ctx.rank], ctx)))
                if not all(torch.equal(got, want) and torch.equal(got, plain)
                           for got, plain in outs):
                    raise AssertionError(f"{kname} {name} chunks {c}: not bit-exact")
                del outs
                row[f"{name}_ms_chunks{c}"] = dist_ms(ctx, lambda: ag.all_gather(
                    x[ctx.rank], ctx=ctx, method=method, chunks_per_shard=c), iters=20)
            total["ms"] += row[f"{name}_ms_chunks{runs[0]}"]
            for key in ("plain_ms", "library_ms", "bytes"):
                total[key] += per_shape[name][key]
        b_ms, by = bound(0.0, total["bytes"])
        entries.append(dict(
            name=kname, route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
            replaces=replaces, max_abs_err=0.0, ms=total["ms"], plain_ms=total["plain_ms"],
            bound_ms=b_ms, bound_by=by, library_ms=total["library_ms"],
            library="torch.cat of the shards", per_shape=row,
            shapes=f"world {WORLD} ring: [{shapes['sp_combine'][0][0]}, 128] f32 + "
                   f"[512, 4096] bf16 a rank (summed)"
                   + ("; ms at chunks_per_shard 2" if chunked else "")))
        emit({"phase": "kernel", "kernel": kname, "world": WORLD, **row,
              **{k_: entries[-1][k_] for k_ in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "shapes")}})

    # K23 at K12's shape
    m_tot, n = TRAIN_B * TRAIN_S, 4096
    m_loc = m_tot // WORLD
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = [torch.randn((m_tot, n), generator=g, device="cuda").to(dtype)
             for _ in range(WORLD)]
        library = sum(t.float() for t in x).to(dtype)
        for chunks in (2, 3):
            cfg = rs.ReduceScatterConfig(chunks_per_shard=chunks)
            if len(ring_spans(m_loc, chunks, cfg.block_m)) != chunks:
                raise AssertionError(f"reduce_scatter ring chunks {chunks}: spans collapsed")
            outs = ctx.run(lambda: (rs.reduce_scatter(x[ctx.rank], ctx=ctx, config=cfg),
                                    rs.reduce_scatter(x[ctx.rank], ctx=ctx, method="ring"),
                                    rs._reduce_scatter_ring_plain(x[ctx.rank], ctx)))
            worst = 0.0
            for r, (got, k18, plain) in enumerate(outs):
                if not (torch.equal(got, k18) and torch.equal(got, plain)):
                    raise AssertionError(f"reduce_scatter ring chunks {chunks} {dtype} rank "
                                         f"{r}: not bit-equal to K18 and the plain ring")
                worst = max(worst, _check_ring(
                    f"reduce_scatter ring chunks {chunks} {dtype} rank {r}", got, plain,
                    library[r * m_loc:(r + 1) * m_loc], WORLD)[1])
            errs[f"{str(dtype)[6:]}_chunks{chunks}"] = dict(max_abs_err=0.0,
                                                           max_abs_err_library=worst)
            del outs

    def library_fn():
        return [torch.stack([x[p][r * m_loc:(r + 1) * m_loc] for p in range(WORLD)]).sum(0)
                for r in range(WORLD)]

    def k23(chunks):
        cfg = rs.ReduceScatterConfig(chunks_per_shard=chunks)
        return dist_ms(ctx, lambda: rs.reduce_scatter(x[ctx.rank], ctx=ctx, config=cfg),
                       iters=10)

    b_ms, by = bound(WORLD * (WORLD - 1) * m_loc * n, 4.0 * WORLD * (m_tot * n + m_loc * n))
    entries.append(dict(
        name="reduce_scatter_ring_chunked", route="cuda",
        source="triton_dist_tpu_torch/csrc/ring.cu",
        replaces="triton_dist_tpu/ops/reduce_scatter.py:152", max_abs_err=0.0,
        ms=k23(2), ms_chunks3=k23(3),
        plain_ms=dist_ms(ctx, lambda: rs._reduce_scatter_ring_plain(x[ctx.rank], ctx),
                         iters=5),
        bound_ms=b_ms, bound_by=by, library_ms=event_ms(library_fn, iters=5),
        library="torch.stack + sum of the four ranks' slices", checks=errs,
        shapes=f"world {WORLD} ring: [{m_tot}, {n}] f32 a rank -> [{m_loc}, {n}]; ms at "
               f"chunks_per_shard 2, ms_chunks3 at 3"))
    emit({"phase": "kernel", "kernel": "reduce_scatter_ring_chunked", "world": WORLD,
          **{k_: entries[-1][k_] for k_ in ("checks", "ms", "ms_chunks3", "plain_ms",
                                            "bound_ms", "library_ms", "shapes")}})
    del x, library
    _jitter_pass(ctx, xs["moe_tokens"], g)
    return entries


def _jitter_pass(ctx, tokens, g) -> None:
    """Every ring kernel once without and once with ``config.comm_delay``
    (each rank starts each kernel a different 1x-8x of JITTER steps late):
    K15 at the wqkv shape, K16/K17 at wo's, K18/K23 at K12's, K19-K22 at
    the token slab, one span and two each. The outputs must be
    bit-identical."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.ops import reduce_scatter as rs

    a = [torch.randn((512, 8192), generator=g, device="cuda").bfloat16() for _ in range(WORLD)]
    b = (torch.randn((8192, 2560), generator=g, device="cuda") / 8192**0.5).bfloat16()
    a_rs = [torch.randn((2048, 2048), generator=g, device="cuda").bfloat16()
            for _ in range(WORLD)]
    b_rs = (torch.randn((2048, 8192), generator=g, device="cuda") / 4096).bfloat16()
    x = [torch.randn((TRAIN_B * TRAIN_S, 4096), generator=g, device="cuda")
         for _ in range(WORLD)]

    def calls():
        r, out = ctx.rank, []
        for c in (1, RING_CHUNKS):
            out += [agg.ag_gemm(a[r], b, ctx=ctx, config=agg.AGGemmConfig(chunks_per_shard=c)),
                    grs.gemm_rs(a_rs[r], b_rs, ctx=ctx,
                                config=grs.GemmRSConfig(chunks_per_shard=c)),
                    rs.reduce_scatter(x[r], ctx=ctx,
                                      config=rs.ReduceScatterConfig(chunks_per_shard=c)),
                    *[ag.all_gather(tokens[r], ctx=ctx, method=m, chunks_per_shard=c)
                      for m in ("ring_1d", "ring_bidir")]]
        return out

    want = ctx.run(calls)  # also grows the workspaces: the timed passes allocate nothing
    passes = {}
    for name, base in (("plain", 0), ("jitter", JITTER)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with config.comm_delay(base):
            got = ctx.run(calls)
        torch.cuda.synchronize()
        passes[f"{name}_pass_s"] = time.perf_counter() - t0
        same = [all(torch.equal(u, v) for u, v in zip(w, o)) for w, o in zip(want, got)]
        if not all(same) or len(want[0]) != 10:
            raise AssertionError(f"the {name} pass changed a ring kernel's output: {same}")
    emit({"phase": "ring_jitter", "world": WORLD, "comm_delay": JITTER,
          "kernels": "K15-K23, one span and two", "calls_a_rank": len(want[0]),
          "bit_identical": True, **passes})


def phase_stuck_wait_ring_bidir() -> None:
    """The bidirectional ring allgather at world 3 whose middle rank comes
    far too late: rank 1's stream is held 2 s, the wait timeout is 0.2 s.
    Its two neighbours must raise with the same fixed site, rank 1's
    arrival: rank 0, whose right neighbour it is, and rank 2, whose left
    neighbour it is."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(3)
    ctx.full_mesh = False
    x = torch.randn((516, 128), device="cuda")

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return ag.all_gather(x, ctx=ctx, method="ring_bidir")

    stuck = False
    ctx.run(call)  # the buffers and flags exist
    stuck = True
    t0 = time.perf_counter()
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck bidirectional ring wait did not raise")
    got = sorted((r["pe"], r["family"], r["site"]) for r in recs)
    if got != [(0, "all_gather_ring_bidir", 1), (2, "all_gather_ring_bidir", 1)]:
        raise AssertionError(f"stuck bidirectional ring wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_ring_bidir", "world": 3,
          "raised_after_s": time.perf_counter() - t0, "records": recs})
    ctx.close()


def _moe_mlp_plain(x, w_up, w_down, ids, tw):
    """The MoE MLP in plain PyTorch, differentiable: every token's top-k
    experts' tanh-GELU MLPs, weighted and summed (full, unsharded banks)."""
    import torch
    from triton_dist_tpu_torch.ops.group_gemm import gelu

    out = torch.zeros_like(x)
    for e in range(w_up.shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        y = gelu(x[tok] @ w_up[e]) @ w_down[e]
        out = out.index_add(0, tok, y * tw[tok, slot][:, None])
    return out


def phase_layers_ring(counters: Counters) -> dict:
    """The layer tier at full width, world 4 on a ring context, one counted
    run of every layer (then the comparisons, then the timings):

    - ``SpGQAFlashDecodeAttention(ag_method="ring_bidir")``, contiguous
      and paged, batch 8, 64 q / 8 kv heads, d 128, 1024 positions sharded
      four ways (bf16): K2, K3, K21; held to the same layer with
      ``full_mesh_push`` (K5) within the decode tolerance;
    - ``TPMLP`` at Llama-3.1-70B widths, 512 tokens a rank, ring configs
      with two spans (K15, K17), held to the composition of the rings'
      plain versions within 2 bf16 ulps of the output scale;
    - ``TPMoEMLP(overlap=False)`` and ``(overlap=True)`` at Mixtral-8x7B
      widths, 512 tokens a rank, the same routing, bf16: the gather K21,
      K8 and K18 against K9 and K10; the two within 1e-2 relative L2 (a
      few bf16 roundings in other places); the op-level sequential pair
      with ``ag_method="ring_1d"`` and a two-span reduce-scatter (K19,
      K23) bit-equal to the sequential layer; the token gather with two
      spans, one way and both (``all_gather(chunks_per_shard=2)``: K20,
      K22), bit-exact;
    - one f32 forward + backward of ``TPMoEMLP(overlap=False)`` against
      the plain MoE MLP on the card differentiated by PyTorch: output
      within 1e-5, every gradient within 1e-4 relative L2.

    No plain version may run on the counted path (no B6 fallback)."""
    import torch
    from triton_dist_tpu_torch import layers
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_mlp as tmlp
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.ops.common import ring_spans
    from triton_dist_tpu_torch.ops.flash_decode import FlashDecodeConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = initialize_distributed(WORLD)
    ctx.full_mesh = False
    g = torch.Generator(device="cuda").manual_seed(73)
    bf16 = torch.bfloat16

    # SP decode: each rank holds 256 of the 1024 positions, contiguous and
    # as its own pool of 16-token pages behind a shuffled block table
    b, hq, h_kv, d, page = 8, 64, 8, 128, 16
    s_loc = 1024 // WORLD
    pps = s_loc // page
    q = torch.randn((b, hq, d), generator=g, device="cuda").to(bf16)
    kv = [[torch.randn((b, h_kv, s_loc, d), generator=g, device="cuda").to(bf16)
           for _ in range(2)] for _ in range(WORLD)]
    total = torch.tensor([1024, 1, 255, 256, 257, 600, 999, 0], dtype=torch.int32,
                         device="cuda")
    perm = torch.randperm(b * pps, generator=g, device="cuda")
    table = perm.reshape(b, pps).to(torch.int32)

    def pool(x):
        pages = x.reshape(b, h_kv, pps, page, d).permute(0, 2, 1, 3, 4).reshape(
            b * pps, h_kv, page, d)
        out = torch.empty_like(pages)
        out[perm] = pages
        return out

    pools = [[pool(t) for t in pair] for pair in kv]
    sp_ring = layers.SpGQAFlashDecodeAttention(ctx, FlashDecodeConfig(), ag_method="ring_bidir")
    sp_mesh = layers.SpGQAFlashDecodeAttention(ctx, FlashDecodeConfig(),
                                               ag_method="full_mesh_push")

    def sp(layer):
        r = ctx.rank
        lens = layer.local_lens_from_global(total, s_loc).to(torch.int32)
        return (layer(q, kv[r][0], kv[r][1], lens),
                layer.forward_paged(q, pools[r][0], pools[r][1], lens, table))

    # TPMLP at 70B widths
    hid, f_loc, m_loc = 8192, 28672 // WORLD, 512
    x70 = [torch.randn((m_loc, hid), generator=g, device="cuda").to(bf16) for _ in range(WORLD)]
    wu70 = [(torch.randn((hid, f_loc), generator=g, device="cuda") / hid**0.5).to(bf16)
            for _ in range(WORLD)]
    wd70 = [(torch.randn((f_loc, hid), generator=g, device="cuda") / (4 * f_loc)**0.5).to(bf16)
            for _ in range(WORLD)]
    ag_cfg = agg.AGGemmConfig(chunks_per_shard=RING_CHUNKS)
    rs_cfg = grs.GemmRSConfig(chunks_per_shard=RING_CHUNKS)
    mlp = layers.TPMLP(ctx, ag_config=ag_cfg, rs_config=rs_cfg)

    # the MoE MLP at Mixtral widths, one routing
    h_moe, f_moe, n_exp = 4096, 14336 // WORLD, 8
    tw, ids = _moe_route(g, WORLD * m_loc, n_exp, 2)
    xm = [torch.randn((m_loc, h_moe), generator=g, device="cuda").to(bf16) for _ in range(WORLD)]
    wum = [(torch.randn((n_exp, h_moe, f_moe), generator=g, device="cuda") / h_moe**0.5)
           .to(bf16) for _ in range(WORLD)]
    wdm = [(torch.randn((n_exp, f_moe, h_moe), generator=g, device="cuda")
            / (4 * f_moe)**0.5).to(bf16) for _ in range(WORLD)]
    moe_seq = layers.TPMoEMLP(ctx, overlap=False)
    moe_ovl = layers.TPMoEMLP(ctx, overlap=True)
    moe_chunk = layers.TPMoEMLP(ctx, gg.GroupGemmConfig(MOE_BLOCK, chunks_per_shard=2),
                                overlap=True)
    rs2 = rs.ReduceScatterConfig(chunks_per_shard=RING_CHUNKS)

    def rows(t):
        return t[ctx.rank * m_loc:(ctx.rank + 1) * m_loc]

    def moe(layer):
        r = ctx.rank
        return layer(xm[r], wum[r], wdm[r], rows(ids), rows(tw))

    def moe_ops():
        """The sequential pair at the op level, the gather pinned one way
        and the reduce-scatter in two spans."""
        r = ctx.rank
        h, al = aggg.ag_group_gemm(xm[r], wum[r], rows(ids), ctx=ctx, ag_method="ring_1d")
        return mrs.moe_reduce_rs(h, wdm[r], al, tw, ctx=ctx, n_tokens=WORLD * m_loc,
                                 rs_config=rs2, out_dtype=bf16, act_fn=gg.gelu)

    # the f32 step of the sequential layer
    f32 = torch.float32
    xf = [t.float() for t in xm]
    wuf = [t.float() for t in wum]
    wdf = [t.float() for t in wdm]
    dout = torch.randn((WORLD * m_loc, h_moe), generator=g, device="cuda")

    def moe_f32_step():
        r = ctx.rank
        leaves = [t.clone().requires_grad_() for t in (xf[r], wuf[r], wdf[r], rows(tw))]
        out = moe_seq(leaves[0], leaves[1], leaves[2], rows(ids), leaves[3])
        torch.autograd.backward(out, rows(dout))
        return out.detach(), [t.grad for t in leaves]

    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    sp_outs = ctx.run(lambda: sp(sp_ring))
    mlp_outs = ctx.run(lambda: mlp(x70[ctx.rank], wu70[ctx.rank], wd70[ctx.rank]))
    seq_outs = ctx.run(lambda: moe(moe_seq))
    ovl_outs = ctx.run(lambda: moe(moe_ovl))
    chunk_outs = ctx.run(lambda: moe(moe_chunk))
    op_outs = ctx.run(moe_ops)
    gathered = ctx.run(lambda: [ag.all_gather(xm[ctx.rank], ctx=ctx, method=m,
                                              chunks_per_shard=RING_CHUNKS)
                                for m in ("ring_1d", "ring_bidir")])
    step_outs = ctx.run(moe_f32_step, grad=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters.read()
    launches, plain = counts["launches"], counts["plain_calls"]
    used = ("flash_decode", "paged_flash_decode", "all_gather_ring_1d",
            "all_gather_ring_1d_chunked", "all_gather_ring_bidir",
            "all_gather_ring_bidir_chunked", "ag_gemm_ring", "gemm_rs_ring_chunked",
            "group_gemm", "group_gemm_dw", "ag_group_gemm", "moe_reduce_rs",
            "ag_group_gemm_chunked", "moe_reduce_rs_chunked", "reduce_scatter_ring",
            "reduce_scatter_ring_chunked")
    if any(launches[k] <= 0 for k in used):
        raise AssertionError(f"layers_ring did not run on the kernels: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the layers' path: {plain}")

    checks = {}
    # SP decode: the same layer with the full-mesh push
    ref = ctx.run(lambda: sp(sp_mesh))
    checks["sp_decode_max_abs_err"] = max(
        (a - b_).float().abs().max().item() for got, want in zip(sp_outs, ref)
        for a, b_ in zip(got, want))
    if not checks["sp_decode_max_abs_err"] <= DECODE_TOL:
        raise AssertionError(f"SP decode ring_bidir against full_mesh_push: {checks}")
    # TPMLP against the rings' plain composition
    spans_ag = ring_spans(m_loc, RING_CHUNKS, ag_cfg.block_m)
    spans_rs = ring_spans(m_loc, RING_CHUNKS, rs_cfg.block_m)
    mlp_ref = ctx.run(lambda: grs._gemm_rs_ring_plain(
        gg.gelu(agg._ag_gemm_ring_plain(x70[ctx.rank], wu70[ctx.rank], ctx, False, bf16,
                                        spans_ag)),
        wd70[ctx.rank], ctx, bf16, spans_rs))
    err = max((a.float() - b_.float()).abs().max().item() for a, b_ in zip(mlp_outs, mlp_ref))
    tol = 2 * 2.0**-7 * max(t.float().abs().max().item() for t in mlp_ref)
    checks["tp_mlp"] = dict(max_abs_err=err, tol=tol)
    if not err <= tol:
        raise AssertionError(f"TPMLP on a ring against its plain composition: {checks}")
    # the MoE MLP: sequential against overlapped, the op-level pair, the gathers
    seq, ovl = torch.cat(seq_outs).float(), torch.cat(ovl_outs).float()
    checks["moe_seq_vs_overlap_rel_l2"] = _rel_l2(seq, ovl)
    if not checks["moe_seq_vs_overlap_rel_l2"] <= 1e-2:
        raise AssertionError(f"TPMoEMLP sequential against overlapped: {checks}")
    if not all(torch.equal(a, b_) for a, b_ in zip(chunk_outs, ovl_outs)):
        raise AssertionError("TPMoEMLP overlapped at two spans (K32, K33) is not bit-equal to "
                             "one span (K9, K10)")
    if not all(torch.equal(a, b_) for a, b_ in zip(op_outs, seq_outs)):
        raise AssertionError("the op-level sequential pair is not bit-equal to the layer")
    if not all(torch.equal(one, torch.cat(xm)) and torch.equal(both, torch.cat(xm))
               for one, both in gathered):
        raise AssertionError("the token gather with two spans: not bit-exact")
    # the f32 step against the plain MLP differentiated by PyTorch
    full = [torch.cat([t.detach() for t in w], dim) for w, dim in ((wuf, 2), (wdf, 1))]
    leaves = [t.clone().requires_grad_() for t in (torch.cat(xf), *full, tw)]
    want = _moe_mlp_plain(leaves[0], leaves[1], leaves[2], ids.long(), leaves[3])
    torch.autograd.backward(want, dout)
    got_out = torch.cat([o for o, _ in step_outs])
    checks["f32_out_rel_l2"] = _rel_l2(got_out, want.detach())
    grads = {
        "dx": (torch.cat([gr[0] for _, gr in step_outs]), leaves[0].grad),
        "dw_up": (torch.cat([gr[1] for _, gr in step_outs], 2), leaves[1].grad),
        "dw_down": (torch.cat([gr[2] for _, gr in step_outs], 1), leaves[2].grad),
        "d_topk_weights": (torch.cat([gr[3] for _, gr in step_outs]), leaves[3].grad),
    }
    checks["f32_grad_rel_l2"] = {k_: _rel_l2(a, b_) for k_, (a, b_) in grads.items()}
    if not (checks["f32_out_rel_l2"] <= 1e-5
            and all(v <= 1e-4 for v in checks["f32_grad_rel_l2"].values())):
        raise AssertionError(f"TPMoEMLP(overlap=False) f32 step against the plain path: "
                             f"{checks}")
    del step_outs, leaves, want, full, grads
    # the ragged_dot backend (plain PyTorch, the sequential composition) in
    # f32 against the pallas backend (K9, K10) on the same inputs
    sentinel = gg.GroupGemmConfig(MOE_BLOCK, backend="ragged_dot")
    rd = ctx.run(lambda: [tmlp.tp_moe_mlp(xf[ctx.rank], wuf[ctx.rank], wdf[ctx.rank],
                                          rows(ids), rows(tw), ctx=ctx, gg_config=cfg_)
                          for cfg_ in (sentinel, gg.GroupGemmConfig(MOE_BLOCK))])
    got_rd, want_rd = torch.cat([a for a, _ in rd]), torch.cat([b_ for _, b_ in rd])
    checks["f32_ragged_dot_vs_pallas_max_abs_err"] = (got_rd - want_rd).abs().max().item()
    checks["f32_ragged_dot_tol"] = 1e-5 * want_rd.abs().max().item()
    if not checks["f32_ragged_dot_vs_pallas_max_abs_err"] <= checks["f32_ragged_dot_tol"]:
        raise AssertionError(f"tp_moe_mlp ragged_dot against pallas in f32: {checks}")
    del rd, got_rd, want_rd

    timings = dict(
        sp_decode_ring_bidir_ms=dist_ms(ctx, lambda: sp(sp_ring), iters=10),
        sp_decode_full_mesh_ms=dist_ms(ctx, lambda: sp(sp_mesh), iters=10),
        tp_mlp_ms=dist_ms(ctx, lambda: mlp(x70[ctx.rank], wu70[ctx.rank], wd70[ctx.rank]),
                          iters=5),
        tp_moe_mlp_sequential_ms=dist_ms(ctx, lambda: moe(moe_seq), iters=5),
        tp_moe_mlp_overlap_ms=dist_ms(ctx, lambda: moe(moe_ovl), iters=5),
        tp_moe_mlp_overlap_chunked_ms=dist_ms(ctx, lambda: moe(moe_chunk), iters=5),
    )
    emit({"phase": "layers_ring", "world": WORLD, "full_mesh": False,
          "chunks_per_shard": RING_CHUNKS, "counted_run_wall_s": wall, "checks": checks,
          "timings": timings, "sp_decode": f"b {b}, hq {hq}, h_kv {h_kv}, d {d}, 1024 "
          f"positions, {s_loc} a rank, bf16", "tp_mlp": f"{TP_MODEL} widths, [{m_loc}, {hid}] "
          f"a rank, F shard {f_loc}", "tp_moe_mlp": f"{MOE_MODEL} widths, [{m_loc}, {h_moe}] "
          f"a rank, F shard {f_moe}, top-2 of {n_exp}", **counts})
    ctx.close()
    return launches


# ------------------------------------------- int8 / fp8 expert banks (K24-K26) ----

FORMATS = ("int8", "fp8")


def _quant_bank(gen, shape, fmt):
    """A random bf16-scale bank ``[E, K, N]`` quantized to `fmt`: ``(pool,
    scale)``."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg

    b = torch.randn(shape, generator=gen, device="cuda") / shape[1]**0.5
    quantize = gg.quantize_expert_weights if fmt == "int8" else gg.quantize_expert_weights_fp8
    return quantize(b)


def _gg_config(fmt):
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig

    return GroupGemmConfig(MOE_BLOCK, w8=fmt == "int8", fp8=fmt == "fp8")


def _scaled_library(a, expert_ids, scale, act, out_dtype):
    """The library yardstick of a scaled grouped GEMM over expert-sorted
    blocks: ``fn(bank_bf16)`` runs ``torch._grouped_mm`` on A against the
    pool upcast to bf16 (bf16 out: this torch takes no f32 out for bf16
    operands) and folds each block's expert scale row in f32; the caller
    times the upcast with it. Returns ``(fn, name)``."""
    import torch

    n_exp = scale.shape[0]
    nb = expert_ids.numel()
    bm = a.shape[0] // nb
    counts = torch.bincount(expert_ids.long(), minlength=n_exp) * bm
    offs = torch.cumsum(counts, 0).to(torch.int32)
    rows = scale[expert_ids.long()]  # [nb, 1, N]

    def fn(b):
        x = a if act is None else act(a.float()).to(a.dtype)
        y = torch._grouped_mm(x, b, offs=offs)
        return (y.view(nb, bm, -1).float() * rows).view(a.shape[0], -1).to(out_dtype)

    return fn, "pool upcast + torch._grouped_mm + scale fold"


def _format_entry(name, source, replaces, per_fmt, shapes, library):
    """One kernels-line entry for a scaled kernel: the int8 readings as its
    columns (the format the serve cells run first), both formats' under
    ``formats``, the worst error of either."""
    head = per_fmt["int8"]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=max(f["max_abs_err"] for f in per_fmt.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"], library=library,
        formats=per_fmt, shapes=shapes,
    )


def phase_group_gemm_scaled() -> dict:
    """K24, int8 and fp8, at the world-1 MoE prefill shapes of K8 (2048
    tokens top-2 over 8 experts, t_pad 5120, bf16 activations): the
    up-projection [5120, 4096] x [8, 4096, 14336] to bf16 and the
    down-projection with the GELU fused [5120, 14336] x [8, 14336, 4096] to
    f32, each within one bf16 ulp of the output scale of its plain twin;
    first the f32 engine and ragged edges at small shapes (1e-5 of the
    scale)."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(41)
    n_exp, topk, bm = 8, 2, MOE_BLOCK
    bf16, f32 = torch.bfloat16, torch.float32
    small = {}
    for fmt in FORMATS:
        worst = 0.0
        for tokens, k, n, dtype, out_dtype, act in ((100, 256, 304, f32, f32, gg.gelu),
                                                    (300, 512, 1024, f32, f32, None),
                                                    (33, 100, 272, bf16, bf16, gg.gelu)):
            _, ids = _moe_route(g, tokens, n_exp, topk)
            al = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
            a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g,
                            device="cuda").to(dtype)
            b, sc = _quant_bank(g, (n_exp, k, n), fmt)
            got = gg.group_gemm(a, b, al.expert_ids, scale=sc, out_dtype=out_dtype, act_fn=act)
            ref = gg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act, sc)
            if dtype == bf16:
                _check_bf16(f"group_gemm {fmt} {tokens}x{k}x{n}", got, ref)
            else:
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                if not rel <= 1e-5:
                    raise AssertionError(f"group_gemm {fmt} f32 {tokens}x{k}x{n}: {rel}")
                worst = max(worst, rel)
        small[fmt] = worst

    tokens = 8 * 256
    _, ids = _moe_route(g, tokens, n_exp, topk)
    al = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm)
    t_pad = al.sorted_token_ids.shape[0]
    used = int((torch.bincount(ids.reshape(-1).long(), minlength=n_exp) > 0).sum().item())
    per_fmt, rows, lib_name = {}, [], ""
    for fmt in FORMATS:
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
        for name, (k, n, act, out_dtype) in {"up": (4096, 14336, None, bf16),
                                             "down_gelu": (14336, 4096, gg.gelu, f32)}.items():
            a = torch.randn((t_pad, k), generator=g, device="cuda").to(bf16)
            b, sc = _quant_bank(g, (n_exp, k, n), fmt)
            got = gg.group_gemm(a, b, al.expert_ids, scale=sc, out_dtype=out_dtype, act_fn=act)
            ref = gg._group_gemm_plain(a, b, al.expert_ids, bm, out_dtype, act, sc)
            err, tol = _check_bf16(f"group_gemm {fmt} {name}", got, ref)
            del got, ref
            flops = 2.0 * t_pad * k * n
            nbytes = (2.0 * t_pad * k + 1.0 * used * k * n + 4.0 * used * n
                      + t_pad * n * (4 if out_dtype == f32 else 2))
            lib_fn, lib_name = _scaled_library(a, al.expert_ids, sc, act, out_dtype)
            row = dict(
                format=fmt, shape=[t_pad, k, n], gelu=act is not None, max_abs_err=err, tol=tol,
                ms=cuda_ms(lambda: gg.group_gemm(a, b, al.expert_ids, scale=sc,
                                                 out_dtype=out_dtype, act_fn=act), iters=10),
                plain_ms=event_ms(lambda: gg._group_gemm_plain(a, b, al.expert_ids, bm,
                                                               out_dtype, act, sc), iters=2),
                library_ms=event_ms(lambda: lib_fn(b.to(bf16)), iters=5),
                bound_ms=bound(flops, nbytes)[0],
            )
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append({name: row})
            for key in ("ms", "plain_ms", "library_ms"):
                total[key] += row[key]
            total["flops"] += flops
            total["bytes"] += nbytes
            total["err"] = max(total["err"], err)
            del a, b, sc
        b_ms, by = bound(total["flops"], total["bytes"])
        per_fmt[fmt] = dict(ms=total["ms"], plain_ms=total["plain_ms"],
                            library_ms=total["library_ms"], bound_ms=b_ms, bound_by=by,
                            max_abs_err=total["err"], f32_engine_rel_err=small[fmt])
    emit({"phase": "kernel", "kernel": "group_gemm_scaled", "t_pad": t_pad,
          "experts_used": used, "per_shape": rows, "f32_engine_rel_err": small})
    return _format_entry(
        "group_gemm_scaled", "triton_dist_tpu_torch/csrc/group_gemm.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:87", per_fmt,
        f"t_pad {t_pad} (2048 tokens, top-2 of 8): up 4096->14336 bf16 out, down 14336->4096 "
        f"with GELU, f32 out (summed); int8 and fp8 e4m3 banks", lib_name)


def phase_ag_group_gemm_scaled(ctx) -> dict:
    """K25, int8 and fp8, at K9's shapes (world 4: 512 tokens a rank,
    t_pad_loc 2048, H 4096 -> F shard 3584, bf16), each rank's bank
    quantized on its own shard, held to its plain twin as K9 is."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import group_gemm as gg

    g = torch.Generator(device="cuda").manual_seed(42)
    m_loc, k, n_loc, n_exp = 512, 4096, 3584, 8
    ral, _ = _moe_tp4_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    x = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16() for _ in range(WORLD)]
    slabs = [x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(WORLD)]
    gathered = torch.cat(slabs)
    ids_flat = ral.expert_ids.reshape(-1)
    rows = WORLD * t_pad_loc
    flops = WORLD * 2.0 * rows * k * n_loc
    nbytes = (2.0 * rows * k + WORLD * (n_exp * k * n_loc + 4.0 * n_exp * n_loc)
              + 2.0 * WORLD * rows * n_loc)
    b_ms, by = bound(flops, nbytes)
    per_fmt, lib_name = {}, ""
    for fmt in FORMATS:
        banks = [_quant_bank(g, (n_exp, k, n_loc), fmt) for _ in range(WORLD)]

        def kernel():
            bq, sc = banks[ctx.rank]
            return aggg.ag_group_gemm_overlap(x[ctx.rank], bq, ral, ctx=ctx, scale=sc)

        outs = ctx.run(kernel)
        err, tol = max(_check_bf16(f"ag_group_gemm {fmt} rank {r}", out,
                                   gg._group_gemm_plain(gathered, banks[r][0], ids_flat,
                                                        MOE_BLOCK, torch.bfloat16, None,
                                                        banks[r][1]))
                       for r, out in enumerate(outs))
        del outs
        libs = [[_scaled_library(slabs[c], ral.expert_ids[c], banks[r][1], None,
                                 torch.bfloat16) for c in range(WORLD)] for r in range(WORLD)]
        lib_name = libs[0][0][1] + ", per source slab, after torch.cat"

        def library():
            for r in range(WORLD):
                torch.cat(slabs)
                up = banks[r][0].to(torch.bfloat16)
                for fn, _ in libs[r]:
                    fn(up)

        per_fmt[fmt] = dict(
            ms=dist_ms(ctx, kernel, iters=5),
            plain_ms=dist_ms(ctx, lambda: aggg._ag_overlap_xla(
                aggg.presort_local_rows(x[ctx.rank], ral, ctx), banks[ctx.rank][0], ral, ctx,
                False, torch.bfloat16, banks[ctx.rank][1]), iters=2),
            library_ms=event_ms(library, iters=3), bound_ms=b_ms, bound_by=by,
            max_abs_err=err, tol=tol)
        per_fmt[fmt]["tflops"] = flops / per_fmt[fmt]["ms"] / 1e9
        del banks, libs
    emit({"phase": "kernel", "kernel": "ag_group_gemm_scaled", "world": WORLD,
          "formats": per_fmt})
    return _format_entry(
        "ag_group_gemm_scaled", "triton_dist_tpu_torch/csrc/dist.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:288", per_fmt,
        f"world {WORLD}: [{m_loc}, {k}] tokens a rank, t_pad_loc {t_pad_loc}, w_up shard "
        f"[{n_exp}, {k}, {n_loc}] int8 / fp8 e4m3", lib_name)


def phase_moe_reduce_rs_scaled(ctx) -> dict:
    """K26, int8 and fp8, at K10's shapes (world 4: rank-major rows [4 x
    2048, 3584] bf16 against the W_down shard [8, 3584, 4096], 512 tokens
    out a rank), held to its plain twin as K10 is (two bf16 ulps: each
    peer's partial is rounded to bf16)."""
    import torch
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(43)
    m_loc, f_loc, h, n_exp = 512, 3584, 4096, 8
    ral, tw = _moe_tp4_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, m_loc, 2)
    hs = [torch.randn((WORLD * t_pad_loc, f_loc), generator=g, device="cuda").bfloat16()
          for _ in range(WORLD)]
    rows = WORLD * t_pad_loc
    flops = WORLD * 2.0 * rows * f_loc * h
    nbytes = (2.0 * WORLD * rows * f_loc + WORLD * (n_exp * f_loc * h + 4.0 * n_exp * h)
              + 2.0 * WORLD * m_loc * h)
    b_ms, by = bound(flops, nbytes)
    dst_l = dst.reshape(WORLD, -1).long()
    w_l = w_rows.reshape(WORLD, -1, 1)
    per_fmt, lib_name = {}, ""
    for fmt in FORMATS:
        banks = [_quant_bank(g, (n_exp, f_loc, h), fmt) for _ in range(WORLD)]

        def kernel():
            wd, sc = banks[ctx.rank]
            return mrs.moe_reduce_rs_overlap(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows,
                                             ctx=ctx, m_out=m_loc, combine_rows=inv, scale=sc)

        def plain():
            wd, sc = banks[ctx.rank]
            return mrs._moe_rs_overlap_xla(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows, ctx,
                                           m_loc, torch.bfloat16, sc)

        outs = ctx.run(lambda: (kernel(), plain()))
        err, tol = max(_check_bf16(f"moe_reduce_rs {fmt} rank {r}", got, want, factor=2.0)
                       for r, (got, want) in enumerate(outs))
        del outs
        libs = [[_scaled_library(hs[r][c * t_pad_loc:(c + 1) * t_pad_loc], ral.expert_ids[c],
                                 banks[r][1], None, torch.float32)
                 for c in range(WORLD)] for r in range(WORLD)]
        lib_name = libs[0][0][1] + ", per (rank, destination), + index_add_ + a sum"

        def library():
            parts = []
            for r in range(WORLD):
                up = banks[r][0].to(torch.bfloat16)
                parts.append([torch.zeros((m_loc, h), device="cuda").index_add_(
                    0, dst_l[c], libs[r][c][0](up) * w_l[c]) for c in range(WORLD)])
            return [sum(parts[r][c] for r in range(WORLD)).bfloat16() for c in range(WORLD)]

        per_fmt[fmt] = dict(ms=dist_ms(ctx, kernel, iters=5), plain_ms=dist_ms(ctx, plain, iters=2),
                            library_ms=event_ms(library, iters=3), bound_ms=b_ms, bound_by=by,
                            max_abs_err=err, tol=tol)
        per_fmt[fmt]["tflops"] = flops / per_fmt[fmt]["ms"] / 1e9
        del banks, libs
    emit({"phase": "kernel", "kernel": "moe_reduce_rs_scaled", "world": WORLD,
          "formats": per_fmt})
    return _format_entry(
        "moe_reduce_rs_scaled", "triton_dist_tpu_torch/csrc/dist.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:576", per_fmt,
        f"world {WORLD}: h [{rows}, {f_loc}] a rank, W_down shard [{n_exp}, {f_loc}, {h}] "
        f"int8 / fp8 e4m3, {m_loc} tokens out a rank", lib_name)


def _bank_gb(params) -> float:
    """The expert banks' bytes (pools and scales) over every layer, GB."""
    return sum(p[n].numel() * p[n].element_size() for p in params["layers"]
               for n in ("w_up", "w_down", "w_up_scale", "w_down_scale") if n in p) / 1e9


def phase_serve_moe_quant(counters: Counters) -> tuple[dict, dict, dict]:
    """``serve_moe_w8`` and ``serve_moe_fp8``: ``serve_moe``'s model
    (Mixtral-8x7B widths, 8 of 32 layers, bf16, the same seed) and its 8
    requests, served from banks quantized by ``quantize_moe_serving_params``
    with the float banks freed first (so the peak shows the format), the
    config asking for the format (K24 in prefill; decode upcasts the pools
    in plain PyTorch); each serve's bf16 prefill logits against the world-1
    plain scaled forward under the served path's expert choices; then
    ``serve_moe_tp4_w8``: the int8 banks at world 4 on the one card (K25,
    K26) and its logits."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import (
        init_moe_params, quantize_moe_serving_params, shard_params,
    )
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers = 8
    base = presets.preset(MOE_MODEL, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(base.vocab, lengths, 32, seed=31)
    L = 128
    flat = _prompt_tokens(reqs, base.batch, L)
    rows = torch.arange(base.batch, device="cuda") * L + L - 1
    make_served, make_plain = _moe_models()
    out = {}
    for fmt in FORMATS:
        cfg = dataclasses.replace(base, gg_config=_gg_config(fmt))
        params = init_moe_params(base, seed=30)  # serve_moe's weights
        float_gb = _bank_gb(params)
        params = quantize_moe_serving_params(params, fmt=fmt)  # the float banks go
        torch.cuda.empty_cache()
        res = _serve(cfg, params, reqs, counters)
        launches = res["launches"]
        if (any(launches[k] <= 0 for k in ("group_gemm_scaled", "gemm", "paged_flash_decode"))
                or launches["group_gemm"]):
            raise AssertionError(f"serve_moe_{fmt} took the wrong kernels: {launches}")
        name = "serve_moe_w8" if fmt == "int8" else "serve_moe_fp8"
        emit({"phase": name, "model": MOE_MODEL, "n_layers": n_layers, "world": 1,
              "format": fmt, "batch": 8, "s_max": 1024, "page_size": 16,
              "prompt_lens": lengths, "max_new_tokens": 32, "expert_bank_gb": _bank_gb(params),
              "float_bank_gb": float_gb, **res})
        out[fmt] = launches
        pcfg = dataclasses.replace(cfg, seq=L)
        served = make_served(pcfg)
        with torch.inference_mode():
            got = served(flat, params)[rows].float()
        _check_moe_logits(f"{name}_logits", got, served.routes, make_plain, pcfg, flat, params,
                          rows)
        if fmt == "int8":
            ctx = initialize_distributed(WORLD)
            tp4 = _serve(cfg, params, reqs, counters, ctx=ctx)
            launches4 = tp4["launches"]
            used = ("ag_group_gemm_scaled", "moe_reduce_rs_scaled", "group_gemm_scaled",
                    "ag_gemm", "gemm_rs", "gemm", "all_gather", "paged_flash_decode", "barrier")
            if any(launches4[k] <= 0 for k in used) or any(
                    launches4[k] for k in ("ag_group_gemm", "moe_reduce_rs", "group_gemm")):
                raise AssertionError(f"serve_moe_tp4_w8 took the wrong kernels: {launches4}")
            emit({"phase": "serve_moe_tp4_w8", "model": MOE_MODEL, "n_layers": n_layers,
                  "world": WORLD, "format": fmt, "batch": 8, "s_max": 1024, "page_size": 16,
                  "prompt_lens": lengths, "max_new_tokens": 32,
                  "expert_bank_gb": _bank_gb(params), **tp4})
            out["tp4"] = launches4
            shards = shard_params(params, WORLD, ctx.devices)
            m_loc = flat.numel() // WORLD

            def rank_logits():
                r = ctx.rank
                model = make_served(pcfg, ctx=ctx)
                logits = model(flat[r * m_loc:(r + 1) * m_loc], shards[r])
                return logits[rows].float(), model.routes

            outs = ctx.run(rank_logits)
            del shards
            routes = [tuple(torch.cat([o[1][li][j] for o in outs]) for j in (0, 1))
                      for li in range(n_layers)]
            _check_moe_logits("serve_moe_tp4_w8_logits", torch.cat([o[0] for o in outs], dim=1),
                              routes, make_plain, pcfg, flat, params, rows)
            ctx.close()
        del params, served
        torch.cuda.empty_cache()
    return out["int8"], out["fp8"], out["tp4"]


def phase_f32_parity_moe_quant() -> None:
    """f32, one MoE layer at full Mixtral width, int8 and fp8 banks: greedy
    tokens of the kernel path on the card (K24 at world 1; K25, K26 at world
    4) identical to the plain path on the CPU. Two of the four runs build a
    ``ServingEngine`` from float banks with the format in ``gg_config``, so
    the engine's quantize-once branch runs (and the pools it makes on the
    card must equal the CPU's byte for byte); the others feed pre-quantized
    banks to the batcher. TF32 off."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import (
        init_moe_params, quantize_moe_serving_params,
    )
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.serving.engine import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = presets.preset(MOE_MODEL, n_layers=1, batch=2, dtype=torch.float32)
    params = init_moe_params(base, seed=35)
    cpu = {k: v.cpu() for k, v in params.items() if k != "layers"}
    cpu["layers"] = [{k: v.cpu() for k, v in p.items()} for p in params["layers"]]
    lengths, max_new = [12, 33], 4
    reqs = lambda: _requests(base.vocab, lengths, max_new, seed=36)  # noqa: E731
    same_bytes = {}
    for fmt in FORMATS:
        card_q = quantize_moe_serving_params(params, fmt=fmt)["layers"][0]
        cpu_q = quantize_moe_serving_params(cpu, fmt=fmt)["layers"][0]
        same_bytes[fmt] = all(
            torch.equal(card_q[n].cpu().view(torch.uint8) if fmt == "fp8" and "scale" not in n
                        else card_q[n].cpu(),
                        cpu_q[n].view(torch.uint8) if fmt == "fp8" and "scale" not in n
                        else cpu_q[n])
            for n in ("w_up", "w_down", "w_up_scale", "w_down_scale"))
        if not same_bytes[fmt]:
            raise AssertionError(f"{fmt} pools or scales quantized on the card differ from the CPU's")
        del card_q, cpu_q

    def run(p, device, world, fmt, float_banks):
        cfg = dataclasses.replace(base, gg_config=_gg_config(fmt))
        ctx = initialize_distributed(world, device=device) if world > 1 else None
        if float_banks:
            eng = ServingEngine(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                                ctx=ctx, serving=ServingConfig(max_queue=8))
            if eng._serving_params() is p:
                raise AssertionError("the engine did not quantize the float banks")
            for r in reqs():
                eng.submit(r)
            got = {u: r.tokens for u, r in eng.run_until_idle().items()}
        else:
            b = ContinuousBatcher(cfg, quantize_moe_serving_params(p, fmt=fmt), s_max=256,
                                  page_size=16, prefill=True, device=device, ctx=ctx)
            for r in reqs():
                b.submit(r)
            got = dict(b.run())
        if ctx is not None:
            ctx.close()
        return got

    times = {}
    for world, fmt, float_banks in ((1, "int8", True), (1, "fp8", False), (WORLD, "int8", False),
                                    (WORLD, "fp8", True)):
        t0 = time.perf_counter()
        want = run(cpu, "cpu", world, fmt, float_banks)
        t1 = time.perf_counter()
        got = run(params, "cuda", world, fmt, float_banks)
        times[f"world{world}_{fmt}"] = (t1 - t0, time.perf_counter() - t1)
        if got != want:
            raise AssertionError(f"world-{world} {fmt} f32 greedy tokens differ: {got} vs {want}")
    emit({"phase": "f32_parity_moe_quant", "model": MOE_MODEL, "n_layers": 1,
          "runs": list(times), "requests": len(lengths), "max_new_tokens": max_new,
          "identical": True, "card_quantized_bytes_equal_cpu": same_bytes,
          "cpu_reference_s": {k: t[0] for k, t in times.items()},
          "card_s": {k: t[1] for k, t in times.items()}})


# ------------------------------------------------- expert parallelism ----

EP_MODEL = "mixtral-8x7b:ep"
EP_HIDDEN = 4096  # the Mixtral token row
EP_SHAPES = {  # name: (max_m, dtype name, payload metadata ints a slab)
    # prefill: 8 x 256 tokens, 512 a rank, top-2: max_m = 1024, ids ride along
    "prefill_dispatch": (1024, "bfloat16", 1024),
    "prefill_combine": (1024, "bfloat16", 0),
    # decode: 8 rows, 2 a rank: max_m = 4
    "decode_dispatch": (4, "bfloat16", 4),
    "decode_combine": (4, "bfloat16", 0),
    # the int8 wire: ids and the bitcast row scales on the payload
    "prefill_dispatch_int8": (1024, "int8", 2048),
}


def _a2a_inputs(g, max_m, dtype_name, meta_w):
    """Every rank's send slabs [4, max_m, 4096], counts and payload
    metadata (None without)."""
    import torch

    dtype = getattr(torch, dtype_name)
    shape = (WORLD, max_m, EP_HIDDEN)
    if dtype == torch.int8:
        slabs = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                               dtype=torch.int32).to(dtype) for _ in range(WORLD)]
    else:
        slabs = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(WORLD)]
    splits = [torch.randint(0, max_m + 1, (WORLD,), generator=g, device="cuda")
              for _ in range(WORLD)]
    meta = None if not meta_w else [
        torch.randint(-1, 2, (WORLD, meta_w), generator=g, device="cuda", dtype=torch.int32)
        for _ in range(WORLD)]
    return slabs, splits, meta


def phase_all_to_all(ctx) -> list[dict]:
    """K27 (one chunk a slab) and K28 (2 and 3 spans) at the shapes of the
    world-4 EP serve (``serve_moe_ep4``): the prefill dispatch [4, 1024,
    4096] bf16 a rank with its payload [4, 1025] int32 (counts and expert
    ids), the combine (no metadata), the decode slabs [4, 4, 4096], and the
    int8 wire with its payload [4, 2049] (ids and bitcast row scales); every
    call bit-exact against the plain host exchange. Then timed at the
    prefill dispatch shape (and K27 at the decode one): the kernel, the
    plain version, and ``torch.stack`` of the peers' slabs for every rank
    (the library yardstick); the bound is every rank's slabs and payload
    read once and written once at the HBM rate."""
    import torch
    from triton_dist_tpu_torch.ops import all_to_all as a2a

    g = torch.Generator(device="cuda").manual_seed(90)
    checked = {}
    for name, (max_m, dtype_name, meta_w) in EP_SHAPES.items():
        slabs, splits, meta = _a2a_inputs(g, max_m, dtype_name, meta_w)
        for chunks in (1, 2, 3):
            cfg = a2a.A2AConfig(chunks_per_shard=chunks)

            def body():
                r = ctx.rank
                m = None if meta is None else meta[r]
                return (a2a.fast_all_to_all(slabs[r], splits[r], meta=m, ctx=ctx, config=cfg),
                        a2a._fast_all_to_all_xla(slabs[r], splits[r], ctx, meta=m))

            for got, want in ctx.run(body):
                if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"all_to_all {name} chunks {chunks}: not bit-exact")
        checked[name] = f"[{WORLD}, {max_m}, {EP_HIDDEN}] {dtype_name}, payload [{WORLD}, " \
                        f"{1 + meta_w}] int32: chunks 1, 2, 3 bit-exact"
        del slabs, splits, meta

    def timed(max_m, meta_w):
        slabs, splits, meta = _a2a_inputs(g, max_m, "bfloat16", meta_w)

        def call(chunks):
            cfg = a2a.A2AConfig(chunks_per_shard=chunks)
            return lambda: a2a.fast_all_to_all(slabs[ctx.rank], splits[ctx.rank],
                                               meta=meta[ctx.rank], ctx=ctx, config=cfg)

        ms = {c: dist_ms(ctx, call(c), iters=20) for c in ((1, 2, 3) if max_m > 4 else (1,))}
        plain = dist_ms(ctx, lambda: a2a._fast_all_to_all_xla(
            slabs[ctx.rank], splits[ctx.rank], ctx, meta=meta[ctx.rank]), iters=5)
        library = cuda_ms(lambda: [torch.stack([slabs[p][r] for p in range(WORLD)])
                                   for r in range(WORLD)], iters=20)
        nbytes = 2.0 * WORLD * (slabs[0].numel() * 2 + meta[0].numel() * 4 + WORLD * 4)
        return ms, plain, library, bound(0.0, nbytes)

    ms, plain, library, (b_ms, by) = timed(1024, 1024)
    decode_ms, decode_plain, decode_library, (decode_b, _) = timed(4, 4)
    common = dict(route="cuda", source="triton_dist_tpu_torch/csrc/a2a.cu", max_abs_err=0.0,
                  plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=library,
                  library="torch.stack of the peers' slabs, every rank",
                  shapes=f"world {WORLD}: [{WORLD}, 1024, {EP_HIDDEN}] bf16 a rank, payload "
                         f"[{WORLD}, 1025] int32")
    k27 = dict(name="all_to_all", replaces="triton_dist_tpu/ops/all_to_all.py:92", ms=ms[1],
               decode=dict(ms=decode_ms[1], plain_ms=decode_plain, library_ms=decode_library,
                           bound_ms=decode_b, shapes=f"[{WORLD}, 4, {EP_HIDDEN}] bf16 a rank"),
               **common)
    k28 = dict(name="all_to_all_chunked", replaces="triton_dist_tpu/ops/all_to_all.py:136",
               ms=ms[2], ms_3_spans=ms[3], spans=2, **common)
    emit({"phase": "kernel", "kernel": "all_to_all", "world": WORLD, "checks": checked,
          "ms_by_spans": ms, "plain_ms": plain, "bound_ms": b_ms, "library_ms": library,
          "decode": k27["decode"]})
    return [k27, k28]


def phase_stuck_wait_a2a() -> None:
    """K27 and K28 (3 spans) at world 2 with rank 1's stream held 2 s
    before its push (wait timeout 0.2 s): rank 0's collect must raise with
    the record of its wait for rank 1's slab — chunk 0 of it with spans —
    site 2 + 1 * 16 + 0, not hang."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    x, s = torch.randn((2, 48, 64), device="cuda"), torch.tensor([3, 48], device="cuda")
    recs = {}
    for chunks, family in ((1, "all_to_all"), (3, "all_to_all_chunked")):
        ctx = initialize_distributed(2)
        cfg = a2a.A2AConfig(chunks_per_shard=chunks)
        stuck = False

        def call():
            if ctx.rank == 1 and stuck:
                common.sleep_on_stream(2_000_000_000)
            return a2a.fast_all_to_all(x, s, ctx=ctx, config=cfg)

        ctx.run(call)
        stuck = True
        try:
            with config.wait_timeout(0.2):
                ctx.run(call)
        except DistTimeoutError as err:
            recs[family] = err.records
        else:
            raise AssertionError(f"a stuck {family} wait did not raise")
        if [(r["pe"], r["family"], r["site"]) for r in recs[family]] != [(0, family, 18)]:
            raise AssertionError(f"stuck {family} wait: unexpected records {recs[family]}")
        ctx.close()
    emit({"phase": "stuck_wait_a2a", "records": recs})


def phase_serve_moe_ep(counters: Counters) -> tuple[dict, dict]:
    """``serve_moe_ep4``: ``ServingEngine`` at world 4 on the one card on
    ``preset("mixtral-8x7b:ep", n_layers=8)`` (whole experts, two a rank;
    ``serve_moe``'s weights and its 8 requests; bf16, s_max 1024, 16-token
    pages, bulk prefill): K27 in every MoE layer's dispatch and combine,
    K8 on each rank's received rows, K6/K7 attention, K3/K5 decode; the
    share of K8's rows that are slab padding (the padded contract); its
    bf16 prefill logits against the world-1 plain forward under the served
    path's expert choices; a profile of one admission and three decode
    steps. Then ``serve_moe_ep4_q``: the same serve with the int8 wire
    (``ep_quant="int8"``) over int8 banks (``quantize_moe_serving_params``,
    the float banks freed first; K24 at each rank), and its logits."""
    import torch
    from triton_dist_tpu_torch.layers.ep_moe_mlp import EPMoEMLP
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import (
        init_moe_params, quantize_moe_serving_params, shard_params,
    )
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers = 8
    cfg = presets.preset(EP_MODEL, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
    params = init_moe_params(cfg, seed=30)  # serve_moe's weights
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, 32, seed=31)
    L = 128
    flat = _prompt_tokens(reqs, cfg.batch, L)
    rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
    m_loc = flat.numel() // WORLD
    make_served, make_plain = _moe_models()
    ctx = initialize_distributed(WORLD)
    out = {}
    for name, quant in (("serve_moe_ep4", None), ("serve_moe_ep4_q", "int8")):
        if quant is not None:
            cfg = dataclasses.replace(cfg, ep_quant=quant,
                                      gg_config=GroupGemmConfig(MOE_BLOCK, w8=True))
            params = quantize_moe_serving_params(params)  # the float banks go
            torch.cuda.empty_cache()
        EPMoEMLP.rows = EPMoEMLP.assignments = 0
        res = _serve(cfg, params, reqs, counters, ctx=ctx)
        gemm_rows, assigned = EPMoEMLP.rows, EPMoEMLP.assignments
        launches = res["launches"]
        experts = "group_gemm" if quant is None else "group_gemm_scaled"
        used = ("all_to_all", experts, "ag_gemm", "gemm_rs", "gemm", "all_gather",
                "paged_flash_decode", "barrier")
        unused = ("ag_group_gemm", "moe_reduce_rs", "ag_group_gemm_scaled",
                  "moe_reduce_rs_scaled", "all_to_all_chunked", "group_gemm_ragged",
                  "group_gemm_scaled" if quant is None else "group_gemm")
        if any(launches[k] <= 0 for k in used) or any(launches[k] for k in unused):
            raise AssertionError(f"{name} took the wrong kernels: {launches}")
        emit({"phase": name, "model": EP_MODEL, "n_layers": n_layers, "world": WORLD,
              "wire": quant or "bf16", "banks": "int8" if quant else "bf16", "batch": 8,
              "s_max": 1024, "page_size": 16, "prompt_lens": lengths, "max_new_tokens": 32,
              "expert_bank_gb": _bank_gb(params), "expert_gemm_rows": gemm_rows,
              "assignments": assigned, "padding_row_share": 1 - assigned / gemm_rows, **res})
        SERVES[name] = dict(res, padding_row_share=1 - assigned / gemm_rows,
                            outputs=_serve.outputs)
        out[name] = launches
        pcfg = dataclasses.replace(cfg, seq=L)
        shards = shard_params(params, WORLD, ctx.devices, cfg=pcfg)

        def rank_logits():
            r = ctx.rank
            model = make_served(pcfg, ctx=ctx)
            logits = model(flat[r * m_loc:(r + 1) * m_loc], shards[r])
            return logits[rows].float(), model.routes

        outs = ctx.run(rank_logits)
        del shards
        # the ranks route their own token shards: rank order is token order
        routes = [tuple(torch.cat([o[1][li][j] for o in outs]) for j in (0, 1))
                  for li in range(n_layers)]
        _check_moe_logits(f"{name}_logits", torch.cat([o[0] for o in outs], dim=1), routes,
                          make_plain, pcfg, flat, params, rows)
        del outs
        if quant is None:
            phase_moe_profile(cfg, params, ctx)
    ctx.close()
    return out["serve_moe_ep4"], out["serve_moe_ep4_q"]


def phase_f32_parity_ep() -> None:
    """f32, one layer at full Mixtral width, world 4: greedy tokens of
    expert-parallel serving on the card (K27, K8 f32, K6, K7, K3, K5)
    identical to the plain path on the CPU, on the f32 and on the int8
    wire (``tests/test_decode.py``'s EP tokens check). Batch 4 (one decode
    row a rank), 2 requests, paged, bulk prefill; TF32 off."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = presets.preset(EP_MODEL, n_layers=1, batch=4, dtype=torch.float32)
    params = init_moe_params(base, seed=37)
    cpu = {k: v.cpu() for k, v in params.items() if k != "layers"}
    cpu["layers"] = [{k: v.cpu() for k, v in p.items()} for p in params["layers"]]
    lengths, max_new = [12, 33], 4

    def run(cfg, p, device):
        ctx = initialize_distributed(WORLD, device=device)
        b = ContinuousBatcher(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                              ctx=ctx)
        for r in _requests(cfg.vocab, lengths, max_new, seed=38):
            b.submit(r)
        got = dict(b.run())
        ctx.close()
        return got

    times = {}
    for wire in (None, "int8"):
        cfg = dataclasses.replace(base, ep_quant=wire)
        t0 = time.perf_counter()
        want = run(cfg, cpu, "cpu")
        t1 = time.perf_counter()
        got = run(cfg, params, "cuda")
        times[wire or "f32"] = (t1 - t0, time.perf_counter() - t1)
        if got != want:
            raise AssertionError(f"EP {wire or 'f32'} wire: greedy tokens differ: {got} vs {want}")
    emit({"phase": "f32_parity_ep", "model": EP_MODEL, "n_layers": 1, "world": WORLD,
          "wires": list(times), "requests": len(lengths), "max_new_tokens": max_new,
          "identical": True, "cpu_reference_s": {k: t[0] for k, t in times.items()},
          "card_s": {k: t[1] for k, t in times.items()}})


def phase_layers_ep(counters: Counters) -> dict:
    """The EP layer at full width, world 4 (one counted run): ``EPMoEMLP``
    at Mixtral widths (512 tokens a rank, two whole experts a rank, top-2,
    bf16) with the chunked transport ``A2AConfig(chunks_per_shard=2)`` and
    ``3`` (K28 in dispatch and combine, K8), each bit-identical to the
    whole-slab layer (K27: the exchange is a copy, so the schedule cannot
    change a bit); then each layer call timed."""
    import torch
    from triton_dist_tpu_torch.layers.ep_moe_mlp import EPMoEMLP
    from triton_dist_tpu_torch.ops.all_to_all import A2AConfig
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.ops.moe_utils import select_experts
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    m_loc, n_exp, topk, f = 512, 8, 2, 14336
    epr = n_exp // WORLD
    g = torch.Generator(device="cuda").manual_seed(91)
    x = [torch.randn((m_loc, EP_HIDDEN), generator=g, device="cuda").to(torch.bfloat16)
         for _ in range(WORLD)]
    w_up = [(torch.randn((epr, EP_HIDDEN, f), generator=g, device="cuda") * EP_HIDDEN**-0.5)
            .to(torch.bfloat16) for _ in range(WORLD)]
    w_down = [(torch.randn((epr, f, EP_HIDDEN), generator=g, device="cuda") * f**-0.5)
              .to(torch.bfloat16) for _ in range(WORLD)]
    routes = [select_experts(torch.randn((m_loc, n_exp), generator=g, device="cuda"), topk)
              for _ in range(WORLD)]
    tw, ids = [r[0] for r in routes], [r[1] for r in routes]
    ctx = initialize_distributed(WORLD)

    def layer(chunks):
        def call():
            r = ctx.rank
            mlp = EPMoEMLP(n_exp, topk, m_loc * topk, ctx, gg_config=GroupGemmConfig(MOE_BLOCK),
                           a2a_config=A2AConfig(chunks_per_shard=chunks))
            return mlp(x[r], w_up[r], w_down[r], ids[r], tw[r])
        return call

    counters.reset()
    chunked = {c: ctx.run(layer(c)) for c in (2, 3)}
    counts = counters.read()["launches"]
    if counts["all_to_all_chunked"] <= 0 or counts["group_gemm"] <= 0 or counts["all_to_all"]:
        raise AssertionError(f"layers_ep took the wrong kernels: {counts}")
    whole = ctx.run(layer(1))
    for c, outs in chunked.items():
        if not all(torch.equal(a, b) for a, b in zip(outs, whole)):
            raise AssertionError(f"EPMoEMLP with {c} spans differs from the whole-slab layer")
    timings = {f"chunks_{c}_ms": dist_ms(ctx, layer(c), iters=5) for c in (1, 2, 3)}
    ctx.close()
    emit({"phase": "layers_ep", "world": WORLD, "tokens_a_rank": m_loc, "experts": n_exp,
          "bit_identical_to_whole_slab": True, "launches": counts, "timings": timings})
    return counts


# ------------------------------------------------------------ ragged rows ----

RAGGED_FORMATS = ("bf16", "int8", "fp8")
EP_TOKENS, EP_EPR = 8 * 256, 2  # serve_moe_ep4's prefill; two whole experts a rank


def _ragged_bank(gen, shape, fmt, dtype=None):
    """A float bank in `dtype` (bf16) with no scale, or a one-byte pool
    with its scale: ``(bank, scale)``."""
    import torch

    if fmt == "bf16":
        b = torch.randn(shape, generator=gen, device="cuda") / shape[1]**0.5
        return b.to(dtype or torch.bfloat16), None
    return _quant_bank(gen, shape, fmt)


def _ep_receiver_alignment(gen):
    """Rank 0's received rows in ``serve_moe_ep4``'s prefill: 2048 tokens,
    512 a rank, routed top-2 over 8 experts from seeded logits; each
    source's assignments to experts 0 and 1, in dispatch order, fill its
    slab of ``max_m`` 1024, aligned by local expert with the ragged map
    (``_align_received``: the virtual padding expert's blocks dead).
    Returns ``(alignment, assignments received)``."""
    import torch
    from triton_dist_tpu_torch.layers.ep_a2a_layer import _align_received

    _, ids = _moe_route(gen, EP_TOKENS, 8, 2)
    m_loc = EP_TOKENS // WORLD
    max_m = 2 * m_loc
    recv = torch.full((WORLD, max_m), -1, dtype=torch.int32, device="cuda")
    splits = torch.zeros(WORLD, dtype=torch.int32, device="cuda")
    for s in range(WORLD):
        flat = ids[s * m_loc:(s + 1) * m_loc].reshape(-1)
        mine = flat[flat // EP_EPR == 0] % EP_EPR
        recv[s, :mine.numel()] = mine
        splits[s] = mine.numel()
    al = _align_received(recv, splits, max_m, EP_EPR, MOE_BLOCK, ragged=True)
    return al, int(splits.sum().item())


def _live_mask(valid, bm):
    """The rows before their block's live count, over the aligned layout."""
    import torch

    rows = torch.arange(valid.numel() * bm, device=valid.device)
    return rows % bm < valid.reshape(-1).long().repeat_interleave(bm)


def _expert_counts(expert_ids, valid, n_exp):
    """Live rows a expert under the ragged map."""
    import torch

    return torch.zeros(n_exp, dtype=torch.long, device=valid.device).index_add_(
        0, expert_ids.reshape(-1).long(), valid.reshape(-1).long())


def _check_ragged(name, got, padded, plain, live, factor=1.0):
    """The ragged kernels' checks: dead rows exact zeros, live rows
    bit-equal to the padded kernel on the same inputs, and the whole within
    `factor` bf16 ulps of the output scale of the plain twin."""
    live_err = (got[live].float() - padded[live].float()).abs().max().item()
    dead_nonzero = int((got[~live] != 0).any(dim=-1).sum().item())
    if live_err != 0.0 or dead_nonzero:
        raise AssertionError(f"{name}: live rows off the padded kernel by {live_err}, "
                             f"{dead_nonzero} dead rows nonzero")
    err, tol = _check_bf16(name, got, plain, factor)
    return dict(max_abs_err=err, tol=tol, live_vs_padded_max_abs_err=live_err,
                dead_rows_nonzero=dead_nonzero)


def _packed_library(a, counts, b, scale, act, out_dtype):
    """The library yardstick of a ragged grouped GEMM: ``torch._grouped_mm``
    over the packed live rows `a` (expert-sorted, ``counts`` a expert)
    against the bank (a one-byte pool upcast to bf16 in the call, its scale
    folded after), or a ``torch.matmul`` per expert where this torch
    refuses the offsets. Returns ``(fn, name)``."""
    import torch

    offs = torch.cumsum(counts, 0).to(torch.int32)
    row_e = torch.repeat_interleave(torch.arange(counts.numel(), device=a.device), counts)
    ends = offs.tolist()

    def operands():
        x = a if act is None else act(a.float()).to(a.dtype)
        return x, (b if scale is None else b.to(torch.bfloat16))

    def finish(y):
        return (y if scale is None else y.float() * scale[row_e, 0]).to(out_dtype)

    def grouped():
        x, bank = operands()
        return finish(torch._grouped_mm(x, bank, offs=offs))

    def per_expert():
        x, bank = operands()
        return finish(torch.cat([x[lo:hi] @ bank[e] for e, (lo, hi)
                                 in enumerate(zip([0] + ends[:-1], ends))]))

    tail = "" if scale is None else " (pool upcast, scale fold)"
    try:
        grouped()
        torch.cuda.synchronize()
        return grouped, "torch._grouped_mm over the packed live rows" + tail
    except Exception:  # noqa: BLE001 — this torch refuses these offsets
        return per_expert, "torch.matmul per expert over the packed live rows" + tail


def _ragged_entry(name, source, replaces, per_fmt, shapes, library):
    """One kernels-line entry of a ragged kernel: the bf16 readings as its
    columns, all three formats' under ``formats``, the worst error."""
    head = per_fmt["bf16"]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, policy="ragged rows",
        max_abs_err=max(f["max_abs_err"] for f in per_fmt.values()),
        ms=head["ms"], padded_ms=head["padded_ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        library=library, formats=per_fmt, shapes=shapes,
    )


def _sum_rows(rows):
    keys = ("ms", "padded_ms", "plain_ms", "library_ms", "flops", "bytes")
    keys += ("all_dead_ms",) if "all_dead_ms" in rows[0] else ()
    out = {k: sum(r[k] for r in rows) for k in keys}
    out["bound_ms"], out["bound_by"] = bound(out.pop("flops"), out.pop("bytes"))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["dead_rows_nonzero"] = sum(r["dead_rows_nonzero"] for r in rows)
    return out


def phase_group_gemm_ragged() -> dict:
    """K29 in bf16, int8 and fp8 at ``serve_moe_ep4``'s prefill shapes:
    rank 0's received slab (``_ep_receiver_alignment``, t_pad 4480) against
    its two whole experts, the up-projection [4480, 4096] x [2, 4096, 14336]
    and the down-projection with the GELU fused [4480, 14336] x [2, 14336,
    4096], bf16 out, as ``EPMoEMLP`` runs them; first the f32 engine and
    256-row blocks at small shapes. Each against its plain twin, against
    K8/K24 on the same inputs (live rows bit-equal, dead rows zero), timed
    beside K8/K24, the plain twin, the library over the packed live rows,
    and itself with every tile dead (what the skipped tiles cost: one map
    read each and their zero stores); the bound counts the live work
    only."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(101)
    bf16, f32 = torch.bfloat16, torch.float32
    small = {}
    for fmt in RAGGED_FORMATS:
        worst = 0.0
        for tokens, k, n, dtype, bm, act in ((100, 256, 304, f32, 128, gg.gelu),
                                             (150, 192, 272, bf16, 256, None)):
            _, ids = _moe_route(g, tokens, 4, 2)
            al = mu.moe_align_block_size(ids.reshape(-1), 4, bm, ragged=True)
            a = torch.randn((al.sorted_token_ids.shape[0], k), generator=g,
                            device="cuda").to(dtype)
            b, sc = _ragged_bank(g, (4, k, n), fmt, dtype)
            got = gg.group_gemm(a, b, al.expert_ids, valid_rows=al.valid_rows, scale=sc,
                                config=gg.GroupGemmConfig(bm, ragged=True), act_fn=act)
            pad = gg.group_gemm(a, b, al.expert_ids, scale=sc, config=gg.GroupGemmConfig(bm),
                                act_fn=act)
            ref = gg._group_gemm_plain(a, b, al.expert_ids, bm, dtype, act, sc, al.valid_rows)
            live = _live_mask(al.valid_rows, bm)
            name = f"group_gemm_ragged {fmt} {tokens}x{k}x{n} bm {bm}"
            if dtype == bf16:
                _check_ragged(name, got, pad, ref, live)
                continue
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not (rel <= (1e-4 if sc is None else 1e-5) and torch.equal(got[live], pad[live])
                    and not got[~live].any()):
                raise AssertionError(f"{name}: rel {rel}, or live/dead rows off")
            worst = max(worst, rel)
        small[fmt] = worst

    al, assigned = _ep_receiver_alignment(g)
    t_pad = al.sorted_token_ids.shape[0]
    valid = al.valid_rows
    live = _live_mask(valid, MOE_BLOCK)
    live_idx = live.nonzero().squeeze(1)
    counts = _expert_counts(al.expert_ids, valid, EP_EPR)
    used = int((counts > 0).sum().item())
    dead = torch.zeros_like(valid)  # every tile dead: what the skipped tiles cost
    cfg, pcfg = gg.GroupGemmConfig(MOE_BLOCK, ragged=True), gg.GroupGemmConfig(MOE_BLOCK)
    per_fmt, rows, lib_name = {}, [], ""
    for fmt in RAGGED_FORMATS:
        fmt_rows = []
        for name, (k, n, act) in {"up": (4096, 14336, None),
                                  "down_gelu": (14336, 4096, gg.gelu)}.items():
            a = torch.randn((t_pad, k), generator=g, device="cuda").to(bf16)
            b, sc = _ragged_bank(g, (EP_EPR, k, n), fmt)

            def kern():
                return gg.group_gemm(a, b, al.expert_ids, valid_rows=valid, scale=sc,
                                     config=cfg, act_fn=act)

            def padded():
                return gg.group_gemm(a, b, al.expert_ids, scale=sc, config=pcfg, act_fn=act)

            def plain():
                return gg._group_gemm_plain(a, b, al.expert_ids, MOE_BLOCK, bf16, act, sc,
                                            valid)

            chk = _check_ragged(f"group_gemm_ragged {fmt} {name}", kern(), padded(), plain(),
                                live)
            lib_fn, lib_name = _packed_library(a[live_idx], counts, b, sc, act, bf16)
            flops = 2.0 * assigned * k * n
            nbytes = (2.0 * assigned * k + (2.0 if sc is None else 1.0) * used * k * n
                      + (0.0 if sc is None else 4.0 * used * n) + 2.0 * assigned * n)
            row = dict(format=fmt, gemm=name, shape=[t_pad, k, n], live_rows=assigned, **chk,
                       ms=cuda_ms(kern, iters=10), padded_ms=cuda_ms(padded, iters=10),
                       all_dead_ms=cuda_ms(lambda: gg.group_gemm(
                           a, b, al.expert_ids, valid_rows=dead, scale=sc, config=cfg,
                           act_fn=act), iters=10),
                       plain_ms=event_ms(plain, iters=2), library_ms=event_ms(lib_fn, iters=5),
                       bound_ms=bound(flops, nbytes)[0], flops=flops, bytes=nbytes)
            fmt_rows.append(row)
            rows.append({k_: v for k_, v in row.items() if k_ not in ("flops", "bytes")})
            del a, b, sc
        per_fmt[fmt] = _sum_rows(fmt_rows)
        per_fmt[fmt]["f32_engine_rel_err"] = small[fmt]
    emit({"phase": "kernel", "kernel": "group_gemm_ragged", "t_pad": t_pad,
          "live_rows": assigned, "row_tiles": t_pad // MOE_BLOCK,
          "live_row_tiles": int((valid > 0).sum().item()), "per_shape": rows})
    return _ragged_entry(
        "group_gemm_ragged", "triton_dist_tpu_torch/csrc/group_gemm.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:87", per_fmt,
        f"serve_moe_ep4's prefill slab of rank 0: t_pad {t_pad}, {assigned} live rows, "
        f"2 experts; up 4096->14336 and down 14336->4096 with GELU, bf16 out (summed)",
        lib_name)


def _tp4_ragged_inputs(gen, m_loc):
    """``serve_moe_tp4``'s prefill routing at world 4 (512 tokens a rank,
    top-2 over 8 experts), aligned per rank with the ragged map."""
    from triton_dist_tpu_torch.ops import moe_utils as mu

    tw, ids = _moe_route(gen, WORLD * m_loc, 8, 2)
    return mu.moe_align_ranked(ids.reshape(WORLD, -1), 8, MOE_BLOCK, m_loc, ragged=True), tw


def phase_ag_group_gemm_ragged(ctx) -> dict:
    """K30 in bf16, int8 and fp8 at ``serve_moe_tp4``'s shard shapes (world
    4, 512 tokens a rank, t_pad_loc 2048, H 4096 -> F shard 3584, bf16
    slabs): every rank's output against the plain twin over the gathered
    slabs and against K9/K25 on the same inputs (live rows bit-equal, dead
    rows zero); timed beside K9/K25, the plain twin and the library (the
    gather, then ``torch._grouped_mm`` over each source slab's packed live
    rows); the bound counts the live rows only."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import group_gemm as gg

    g = torch.Generator(device="cuda").manual_seed(102)
    m_loc, k, n_loc, n_exp = 512, 4096, 3584, 8
    ral, _ = _tp4_ragged_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    x = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16() for _ in range(WORLD)]
    slabs = [x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(WORLD)]
    gathered = torch.cat(slabs)
    ids_flat, valid_flat = ral.expert_ids.reshape(-1), ral.valid_rows.reshape(-1)
    live = _live_mask(valid_flat, MOE_BLOCK)
    live_c = [_live_mask(ral.valid_rows[c], MOE_BLOCK).nonzero().squeeze(1)
              for c in range(WORLD)]
    counts_c = [_expert_counts(ral.expert_ids[c], ral.valid_rows[c], n_exp)
                for c in range(WORLD)]
    n_live = int(valid_flat.sum().item())
    cfg, pcfg = gg.GroupGemmConfig(MOE_BLOCK, ragged=True), gg.GroupGemmConfig(MOE_BLOCK)
    per_fmt, lib_name = {}, ""
    for fmt in RAGGED_FORMATS:
        banks = [_ragged_bank(g, (n_exp, k, n_loc), fmt) for _ in range(WORLD)]

        def call(config):
            def run():
                b, sc = banks[ctx.rank]
                return aggg.ag_group_gemm_overlap(x[ctx.rank], b, ral, ctx=ctx, config=config,
                                                  scale=sc)
            return run

        def plain():
            b, sc = banks[ctx.rank]
            return aggg._ag_overlap_xla(aggg.presort_local_rows(x[ctx.rank], ral, ctx), b, ral,
                                        ctx, False, torch.bfloat16, sc, True)

        outs = ctx.run(lambda: (call(cfg)(), call(pcfg)()))
        checks = [_check_ragged(f"ag_group_gemm_ragged {fmt} rank {r}", got, pad,
                                gg._group_gemm_plain(gathered, banks[r][0], ids_flat, MOE_BLOCK,
                                                     torch.bfloat16, None, banks[r][1],
                                                     valid_flat), live)
                  for r, (got, pad) in enumerate(outs)]
        del outs
        libs = [[_packed_library(slabs[c][live_c[c]], counts_c[c], banks[r][0], banks[r][1],
                                 None, torch.bfloat16) for c in range(WORLD)]
                for r in range(WORLD)]
        lib_name = "torch.cat + " + libs[0][0][1] + ", per source slab"

        def library():
            for r in range(WORLD):
                torch.cat(slabs)
                for fn, _ in libs[r]:
                    fn()

        wbytes = 2.0 if banks[0][1] is None else 1.0
        flops = WORLD * 2.0 * n_live * k * n_loc
        nbytes = (2.0 * n_live * k + WORLD * wbytes * n_exp * k * n_loc
                  + 2.0 * WORLD * n_live * n_loc)
        b_ms, by = bound(flops, nbytes)
        per_fmt[fmt] = dict(
            ms=dist_ms(ctx, call(cfg), iters=5), padded_ms=dist_ms(ctx, call(pcfg), iters=5),
            plain_ms=dist_ms(ctx, plain, iters=2), library_ms=event_ms(library, iters=3),
            bound_ms=b_ms, bound_by=by, **{k_: max(c[k_] for c in checks) for k_ in (
                "max_abs_err", "tol", "live_vs_padded_max_abs_err", "dead_rows_nonzero")})
        del banks, libs
    emit({"phase": "kernel", "kernel": "ag_group_gemm_ragged", "world": WORLD,
          "t_pad_loc": t_pad_loc, "live_rows": n_live, "formats": per_fmt})
    return _ragged_entry(
        "ag_group_gemm_ragged", "triton_dist_tpu_torch/csrc/dist.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:288", per_fmt,
        f"world {WORLD}: [{m_loc}, {k}] tokens a rank, t_pad_loc {t_pad_loc} ({n_live} live "
        f"rows of {WORLD * t_pad_loc}), w_up shard [{n_exp}, {k}, {n_loc}]", lib_name)


def phase_moe_reduce_rs_ragged(ctx) -> dict:
    """K31 in bf16, int8 and fp8 at ``serve_moe_tp4``'s shard shapes (world
    4: rank-major rows [4 x 2048, 3584] bf16 against the W_down shard [8,
    3584, 4096], 512 tokens out a rank): bit-equal to K10/K26 on the same
    inputs, within two bf16 ulps of its plain twin; its grouped GEMM (K29)
    on one destination's slab with zero nonzero dead rows; timed beside
    K10/K26, the plain twin and the library over the packed live rows."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(103)
    m_loc, f_loc, h, n_exp = 512, 3584, 4096, 8
    ral, tw = _tp4_ragged_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, m_loc, 2)
    hs = [torch.randn((WORLD * t_pad_loc, f_loc), generator=g, device="cuda").bfloat16()
          for _ in range(WORLD)]
    live_c = [_live_mask(ral.valid_rows[c], MOE_BLOCK).nonzero().squeeze(1)
              for c in range(WORLD)]
    counts_c = [_expert_counts(ral.expert_ids[c], ral.valid_rows[c], n_exp)
                for c in range(WORLD)]
    n_live = int(ral.valid_rows.sum().item())
    dst_l = [dst[c].reshape(-1).long()[live_c[c]] for c in range(WORLD)]
    w_l = [w_rows[c].reshape(-1, 1)[live_c[c]] for c in range(WORLD)]
    cfg, pcfg = gg.GroupGemmConfig(MOE_BLOCK, ragged=True), gg.GroupGemmConfig(MOE_BLOCK)
    per_fmt, lib_name = {}, ""
    for fmt in RAGGED_FORMATS:
        banks = [_ragged_bank(g, (n_exp, f_loc, h), fmt) for _ in range(WORLD)]

        def call(config, valid):
            def run():
                wd, sc = banks[ctx.rank]
                return mrs.moe_reduce_rs_overlap(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows,
                                                 ctx=ctx, m_out=m_loc, combine_rows=inv,
                                                 valid_rows=valid, config=config, scale=sc)
            return run

        def plain():
            wd, sc = banks[ctx.rank]
            return mrs._moe_rs_overlap_xla(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows, ctx,
                                           m_loc, torch.bfloat16, sc, ral.valid_rows)

        kernel, padded = call(cfg, ral.valid_rows), call(pcfg, None)
        outs = ctx.run(lambda: (kernel(), padded(), plain()))
        if not all(torch.equal(got, pad) for got, pad, _ in outs):
            raise AssertionError(f"moe_reduce_rs_ragged {fmt}: not bit-equal to the padded K10")
        err, tol = max(_check_bf16(f"moe_reduce_rs_ragged {fmt} rank {r}", got, want, 2.0)
                       for r, (got, _, want) in enumerate(outs))
        del outs
        # its grouped GEMM on destination 0's slab: dead rows exact zeros
        y = gg.group_gemm(hs[0][:t_pad_loc], banks[0][0], ral.expert_ids[0],
                          valid_rows=ral.valid_rows[0], scale=banks[0][1], config=cfg,
                          out_dtype=torch.float32)
        dead_nonzero = int((y[~_live_mask(ral.valid_rows[0], MOE_BLOCK)] != 0).any(-1)
                           .sum().item())
        if dead_nonzero:
            raise AssertionError(f"moe_reduce_rs_ragged {fmt}: {dead_nonzero} dead rows nonzero")
        del y
        libs = [[_packed_library(hs[r][c * t_pad_loc:(c + 1) * t_pad_loc][live_c[c]],
                                 counts_c[c], banks[r][0], banks[r][1], None, torch.float32)[0]
                 for c in range(WORLD)] for r in range(WORLD)]
        lib_name = ("torch._grouped_mm over the packed live rows per (rank, destination) + "
                    "index_add_ + a sum")

        def library():
            parts = [[torch.zeros((m_loc, h), device="cuda").index_add_(
                0, dst_l[c], libs[r][c]() * w_l[c]) for c in range(WORLD)] for r in range(WORLD)]
            return [sum(parts[r][c] for r in range(WORLD)).bfloat16() for c in range(WORLD)]

        wbytes = 2.0 if banks[0][1] is None else 1.0
        flops = WORLD * 2.0 * n_live * f_loc * h
        nbytes = (2.0 * WORLD * n_live * f_loc + WORLD * wbytes * n_exp * f_loc * h
                  + 2.0 * WORLD * m_loc * h)
        b_ms, by = bound(flops, nbytes)
        per_fmt[fmt] = dict(
            ms=dist_ms(ctx, kernel, iters=5), padded_ms=dist_ms(ctx, padded, iters=5),
            plain_ms=dist_ms(ctx, plain, iters=2), library_ms=event_ms(library, iters=3),
            bound_ms=b_ms, bound_by=by, max_abs_err=err, tol=tol, bit_equal_to_padded=True,
            dead_rows_nonzero=dead_nonzero)
        del banks, libs
    emit({"phase": "kernel", "kernel": "moe_reduce_rs_ragged", "world": WORLD,
          "t_pad_loc": t_pad_loc, "live_rows": n_live, "formats": per_fmt})
    return _ragged_entry(
        "moe_reduce_rs_ragged", "triton_dist_tpu_torch/csrc/dist.cu",
        "triton_dist_tpu/ops/gg_pipeline.py:576", per_fmt,
        f"world {WORLD}: h [{WORLD * t_pad_loc}, {f_loc}] a rank ({n_live} live rows), W_down "
        f"shard [{n_exp}, {f_loc}, {h}], {m_loc} tokens out a rank", lib_name)


def phase_stuck_wait_ragged() -> None:
    """K30 at world 2 with every block of rank 1 dead and rank 1's stream
    held 2 s (wait timeout 0.2 s): rank 0 still waits for rank 1 (its entry
    barrier, site 1, and the slab it skips, site 2 + 1) and the run must
    raise with records naming rank 1, not hang or finish early."""
    import dataclasses as dc

    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(2)
    g = torch.Generator(device="cuda").manual_seed(104)
    _, ids = _moe_route(g, 32, 8, 2)
    ral = mu.moe_align_ranked(ids.reshape(2, -1), 8, MOE_BLOCK, 16, ragged=True)
    valid = ral.valid_rows.clone()
    valid[1] = 0
    ral = dc.replace(ral, valid_rows=valid)
    x = torch.randn((16, 64), generator=g, device="cuda")
    b = torch.randn((8, 64, 32), generator=g, device="cuda")
    cfg = gg.GroupGemmConfig(MOE_BLOCK, ragged=True)
    stuck = False

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return aggg.ag_group_gemm_overlap(x, b, ral, ctx=ctx, config=cfg)

    ctx.run(call)
    stuck = True
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck K30 wait did not raise")
    if not recs or any((r["pe"], r["family"]) != (0, "ag_group_gemm") or r["site"] not in (1, 3)
                       for r in recs):
        raise AssertionError(f"stuck K30 wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_ragged", "records": recs})
    ctx.close()


# --------------------------------------------- chunked schedules (K32, K33) ----

# (label, format, ragged, chunks_per_shard, span_policy, gather_group_blocks)
AG_CHUNK_CELLS = (
    ("bf16 contig c2", "bf16", False, 2, "contig", None),
    ("bf16 window c2", "bf16", False, 2, "window", None),
    ("bf16 torus2d c2", "bf16", False, 2, "torus2d", None),
    ("bf16 contig c3 g4", "bf16", False, 3, "contig", 4),
    ("bf16 window c3 g4", "bf16", False, 3, "window", 4),
    ("bf16 torus2d c3 g4", "bf16", False, 3, "torus2d", 4),
    ("int8 contig c2", "int8", False, 2, "contig", None),
    ("fp8 contig c2", "fp8", False, 2, "contig", None),
    ("bf16 ragged contig c2", "bf16", True, 2, "contig", None),
)
RS_CHUNK_CELLS = tuple((f"bf16 {p} c{c}", "bf16", False, c, p, None)
                       for c in (2, 3) for p in ("contig", "window", "interleave", "torus2d"))
RS_CHUNK_CELLS += (("int8 contig c2", "int8", False, 2, "contig", None),
                   ("fp8 contig c2", "fp8", False, 2, "contig", None),
                   ("bf16 ragged contig c2", "bf16", True, 2, "contig", None))


def _chunk_entry(name, replaces, cells, head, plain_ms, library_ms, library, shapes, b_ms, by):
    """One kernels-line entry of a chunked kernel: the readings of its
    bf16 contig two-span cell as its columns, every cell's under
    ``cells``, the worst error of any."""
    return dict(name=name, route="cuda", source="triton_dist_tpu_torch/csrc/dist.cu",
                replaces=replaces, policy="chunked spans",
                max_abs_err=max(c["max_abs_err"] for c in cells.values()),
                ms=cells[head]["ms"], one_span_ms=cells[head]["one_span_ms"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                library=library, cells=cells, shapes=shapes)


def phase_ag_group_gemm_chunked(ctx) -> dict:
    """K32 at K9's served shapes (world 4, 512 tokens a rank, top-2 over 8
    experts, t_pad_loc 2048, H 4096 -> F shard 3584, bf16 slabs): two spans
    a slab at the default gather group (8 blocks) and three or four with
    ``gather_group_blocks=4``, under ``contig``, ``window`` and
    ``torus2d``; int8, fp8 and ragged rows at two spans. Each cell
    bit-equal to the one-span kernel (K9/K25/K30) on the same inputs,
    within one bf16 ulp of the output scale of the plain twin, and timed
    beside that one-span kernel in this run."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_group_gemm as aggg
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops.common import resolve_spans

    g = torch.Generator(device="cuda").manual_seed(110)
    m_loc, k, n_loc, n_exp = 512, 4096, 3584, 8
    ral, _ = _tp4_ragged_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    x = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16() for _ in range(WORLD)]
    slabs = [x[r][(ral.src_rows[r] - r * m_loc).long()] for r in range(WORLD)]
    gathered = torch.cat(slabs)
    ids_flat, valid_flat = ral.expert_ids.reshape(-1), ral.valid_rows.reshape(-1)
    banks = {fmt: [_ragged_bank(g, (n_exp, k, n_loc), fmt) for _ in range(WORLD)]
             for fmt in RAGGED_FORMATS}
    cells = {}
    for label, fmt, ragged, chunks, policy, groups in AG_CHUNK_CELLS:
        one = gg.GroupGemmConfig(MOE_BLOCK, ragged=ragged)
        cfg = dataclasses.replace(one, chunks_per_shard=chunks, span_policy=policy)
        bpg = groups or aggg.gather_group_blocks_for(ral.blocks_per_rank, MOE_BLOCK, k, 2)
        spans = resolve_spans(t_pad_loc, chunks, bpg * MOE_BLOCK, policy=policy, world=WORLD,
                              side="ag")
        if len(spans) < 2:
            raise AssertionError(f"ag_group_gemm_chunked {label}: one span {spans}")

        def call(config):
            def run():
                b, sc = banks[fmt][ctx.rank]
                return aggg.ag_group_gemm_overlap(x[ctx.rank], b, ral, ctx=ctx, config=config,
                                                  scale=sc, gather_group_blocks=groups)
            return run

        before = aggg.ag_group_gemm_overlap.chunked_launches
        outs = ctx.run(lambda: (call(cfg)(), call(one)()))
        if aggg.ag_group_gemm_overlap.chunked_launches != before + WORLD:
            raise AssertionError(f"ag_group_gemm_chunked {label}: K32 was not launched")
        if not all(torch.equal(got, ref) for got, ref in outs):
            raise AssertionError(f"ag_group_gemm_chunked {label}: not bit-equal to one span")
        err, tol = max(_check_bf16(f"ag_group_gemm_chunked {label} rank {r}", got,
                                   gg._group_gemm_plain(gathered, banks[fmt][r][0], ids_flat,
                                                        MOE_BLOCK, torch.bfloat16, None,
                                                        banks[fmt][r][1],
                                                        valid_flat if ragged else None))
                       for r, (got, _) in enumerate(outs))
        del outs
        cells[label] = dict(spans=[list(sp) for sp in spans], max_abs_err=err, tol=tol,
                            bit_equal_to_one_span=True, ms=dist_ms(ctx, call(cfg), iters=5),
                            one_span_ms=dist_ms(ctx, call(one), iters=5))
    b0 = banks["bf16"]
    plain_ms = dist_ms(ctx, lambda: aggg._ag_overlap_xla(
        aggg.presort_local_rows(x[ctx.rank], ral, ctx), b0[ctx.rank][0], ral, ctx, False,
        torch.bfloat16), iters=2)
    libs = [[_grouped_mm_library(slabs[c], b0[r][0], ral.expert_ids[c], None, torch.bfloat16)
             for c in range(WORLD)] for r in range(WORLD)]

    def library():
        for r in range(WORLD):
            torch.cat(slabs)
            for fn, _ in libs[r]:
                fn()

    library_ms = event_ms(library, iters=3)
    rows = WORLD * t_pad_loc
    b_ms, by = bound(WORLD * 2.0 * rows * k * n_loc,
                     2.0 * (rows * k + WORLD * n_exp * k * n_loc + WORLD * rows * n_loc))
    emit({"phase": "kernel", "kernel": "ag_group_gemm_chunked", "world": WORLD,
          "t_pad_loc": t_pad_loc, "cells": cells, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": b_ms})
    return _chunk_entry(
        "ag_group_gemm_chunked", "triton_dist_tpu/ops/gg_pipeline.py:288", cells,
        "bf16 contig c2", plain_ms, library_ms,
        "torch.cat + " + libs[0][0][1] + " per source slab",
        f"world {WORLD}: [{m_loc}, {k}] tokens a rank, t_pad_loc {t_pad_loc}, w_up shard "
        f"[{n_exp}, {k}, {n_loc}]", b_ms, by)


def phase_moe_reduce_rs_chunked(ctx) -> dict:
    """K33 at K10's served shapes (world 4: rank-major rows [4 x 2048, 3584]
    bf16 against the W_down shard [8, 3584, 4096], 512 tokens out a rank):
    two and three chunks under all four policies (two to four 128-row-quantum
    spans of the 512 token rows; ``interleave`` issues them from both
    ends), int8, fp8 and ragged rows at two; each cell bit-equal to the
    one-span kernel (K10/K26/K31) on the same inputs, within two bf16 ulps
    of the plain twin, and timed beside the one-span kernel."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.ops.common import resolve_spans

    g = torch.Generator(device="cuda").manual_seed(111)
    m_loc, f_loc, h, n_exp = 512, 3584, 4096, 8
    ral, tw = _tp4_ragged_inputs(g, m_loc)
    t_pad_loc = ral.t_pad_loc
    dst, w_rows = mu.ranked_scatter_meta(ral, tw)
    inv = mu.ranked_combine_rows(ral, m_loc, 2)
    hs = [torch.randn((WORLD * t_pad_loc, f_loc), generator=g, device="cuda").bfloat16()
          for _ in range(WORLD)]
    banks = {fmt: [_ragged_bank(g, (n_exp, f_loc, h), fmt) for _ in range(WORLD)]
             for fmt in RAGGED_FORMATS}
    cells = {}
    for label, fmt, ragged, chunks, policy, _ in RS_CHUNK_CELLS:
        one = gg.GroupGemmConfig(MOE_BLOCK, ragged=ragged)
        cfg = dataclasses.replace(one, chunks_per_shard=chunks, span_policy=policy)
        spans = resolve_spans(m_loc, chunks, 128, policy=policy, world=WORLD)
        valid = ral.valid_rows if ragged else None

        def call(config):
            def run():
                wd, sc = banks[fmt][ctx.rank]
                return mrs.moe_reduce_rs_overlap(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows,
                                                 ctx=ctx, m_out=m_loc, combine_rows=inv,
                                                 valid_rows=valid, config=config, scale=sc)
            return run

        def plain():
            wd, sc = banks[fmt][ctx.rank]
            return mrs._moe_rs_overlap_xla(hs[ctx.rank], wd, ral.expert_ids, dst, w_rows, ctx,
                                           m_loc, torch.bfloat16, sc, valid)

        before = mrs.moe_reduce_rs_overlap.chunked_launches
        outs = ctx.run(lambda: (call(cfg)(), call(one)(), plain()))
        if mrs.moe_reduce_rs_overlap.chunked_launches != before + WORLD:
            raise AssertionError(f"moe_reduce_rs_chunked {label}: K33 was not launched")
        if not all(torch.equal(got, ref) for got, ref, _ in outs):
            raise AssertionError(f"moe_reduce_rs_chunked {label}: not bit-equal to one span")
        err, tol = max(_check_bf16(f"moe_reduce_rs_chunked {label} rank {r}", got, want, 2.0)
                       for r, (got, _, want) in enumerate(outs))
        del outs
        cells[label] = dict(spans=[list(sp) for sp in spans], max_abs_err=err, tol=tol,
                            bit_equal_to_one_span=True, ms=dist_ms(ctx, call(cfg), iters=5),
                            one_span_ms=dist_ms(ctx, call(one), iters=5))
    b0 = banks["bf16"]
    plain_ms = dist_ms(ctx, lambda: mrs._moe_rs_overlap_xla(
        hs[ctx.rank], b0[ctx.rank][0], ral.expert_ids, dst, w_rows, ctx, m_loc,
        torch.bfloat16), iters=2)
    libs = [[_grouped_mm_library(hs[r][c * t_pad_loc:(c + 1) * t_pad_loc], b0[r][0],
                                 ral.expert_ids[c], None, torch.float32)[0]
             for c in range(WORLD)] for r in range(WORLD)]
    dst_l = dst.reshape(WORLD, -1).long()
    w_l = w_rows.reshape(WORLD, -1, 1)

    def library():
        parts = [[torch.zeros((m_loc, h), device="cuda").index_add_(0, dst_l[c], libs[r][c]()
                                                                    * w_l[c])
                  for c in range(WORLD)] for r in range(WORLD)]
        return [sum(parts[r][c] for r in range(WORLD)).bfloat16() for c in range(WORLD)]

    library_ms = event_ms(library, iters=3)
    rows = WORLD * t_pad_loc
    b_ms, by = bound(WORLD * 2.0 * rows * f_loc * h,
                     2.0 * (WORLD * rows * f_loc + WORLD * n_exp * f_loc * h + WORLD * m_loc * h))
    emit({"phase": "kernel", "kernel": "moe_reduce_rs_chunked", "world": WORLD,
          "t_pad_loc": t_pad_loc, "cells": cells, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": b_ms})
    return _chunk_entry(
        "moe_reduce_rs_chunked", "triton_dist_tpu/ops/gg_pipeline.py:576", cells,
        "bf16 contig c2", plain_ms, library_ms,
        "_grouped_mm_library per (rank, destination) + index_add_ + a sum",
        f"world {WORLD}: h [{rows}, {f_loc}] a rank, w_down shard [{n_exp}, {f_loc}, {h}], "
        f"{m_loc} tokens out a rank", b_ms, by)


def phase_serve_moe_chunked(counters: Counters) -> dict:
    """``serve_moe_tp4_chunked``: ``serve_moe_tp4``'s model, weights and
    requests (Mixtral-8x7B widths, 8 of 32 layers, bf16, world 4 on the one
    card, batch 8, 32 new tokens) under ``gg_config=GroupGemmConfig(128,
    chunks_per_shard=2)``: K32 and K33 wherever a slab or a partial holds
    two spans (the bulk prefill), K9/K10 where it holds one (decode).
    Prints tokens/s, TTFT, peak GB and both ``chunked_launches`` counts,
    whether its greedy tokens equal ``serve_moe_tp4``'s of this run, and
    whether the served forward's bf16 prefill logits (256 tokens a
    sequence: two spans on both sides) equal the one-span forward's bit
    for bit."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers, L = 8, 256
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    base = presets.preset(MOE_MODEL, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
    cfg = dataclasses.replace(base, gg_config=GroupGemmConfig(MOE_BLOCK, chunks_per_shard=2))
    params = init_moe_params(cfg, seed=30)  # serve_moe_tp4's weights
    reqs = _requests(cfg.vocab, lengths, 32, seed=31)
    ctx = initialize_distributed(WORLD)
    res = _serve(cfg, params, reqs, counters, ctx=ctx)
    launches = res["launches"]
    used = ("ag_group_gemm_chunked", "moe_reduce_rs_chunked", "ag_group_gemm", "moe_reduce_rs",
            "group_gemm", "ag_gemm", "gemm_rs", "gemm", "all_gather", "paged_flash_decode",
            "barrier")
    if any(launches[k] <= 0 for k in used):
        raise AssertionError(f"serve_moe_tp4_chunked took the wrong kernels: {launches}")
    twin = SERVES["serve_moe_tp4"]
    same = _serve.outputs == twin["outputs"]
    emit({"phase": "serve_moe_tp4_chunked", "model": MOE_MODEL, "n_layers": n_layers,
          "world": WORLD, "gg_config": "GroupGemmConfig(128, chunks_per_shard=2)", "batch": 8,
          "s_max": 1024, "page_size": 16, "prompt_lens": lengths, "max_new_tokens": 32,
          "tokens_equal_one_span": same,
          "one_span_twin": {k: twin[k] for k in ("tokens_per_s", "ttft_ms", "peak_mem_gb",
                                                 "wall_s")},
          **res})
    if not same:
        raise AssertionError("serve_moe_tp4_chunked: greedy tokens differ from serve_moe_tp4's")
    make_served, _ = _moe_models()
    flat = _prompt_tokens(reqs, cfg.batch, L)
    rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
    counters.reset()
    got, _ = _served_logits(make_served, dataclasses.replace(cfg, seq=L), params, flat, rows,
                            ctx, n_layers)
    chunked = counters.read()["launches"]
    one, _ = _served_logits(make_served, dataclasses.replace(base, seq=L), params, flat, rows,
                            ctx, n_layers)
    equal = torch.equal(got, one)
    emit({"phase": "serve_moe_tp4_chunked_vs_one_span", "logits_bit_equal": equal,
          "max_abs_diff": (got - one).abs().max().item(),
          "chunked_launches": {k: chunked[k] for k in ("ag_group_gemm_chunked",
                                                       "moe_reduce_rs_chunked")}})
    if not (equal and got.isfinite().all().item() and chunked["ag_group_gemm_chunked"] > 0
            and chunked["moe_reduce_rs_chunked"] > 0):
        raise AssertionError("serve_moe_tp4_chunked: prefill logits not bit-equal to the "
                             "one-span forward's, or the forward ran one span")
    del params, got, one
    ctx.close()
    return launches


def _served_logits(make_served, pcfg, params, flat, rows, ctx, n_layers):
    """The served forward's prefill logits at world 4 (each rank its token
    shard) and its layers' routing, rank order being token order."""
    import torch
    from triton_dist_tpu_torch.models.tp_transformer import (
        EPMoETransformerConfig, shard_params,
    )

    ep = isinstance(pcfg, EPMoETransformerConfig)
    shards = shard_params(params, WORLD, ctx.devices, cfg=pcfg if ep else None)
    m_loc = flat.numel() // WORLD

    def rank_logits():
        r = ctx.rank
        model = make_served(pcfg, ctx=ctx)
        logits = model(flat[r * m_loc:(r + 1) * m_loc], shards[r])
        return logits[rows].float(), model.routes

    with torch.inference_mode():
        outs = ctx.run(rank_logits)
    routes = [tuple(torch.cat([o[1][li][j] for o in outs]) for j in (0, 1))
              for li in range(n_layers)]
    return torch.cat([o[0] for o in outs], dim=1), routes


def phase_serve_moe_ragged(counters: Counters) -> tuple[dict, dict]:
    """``serve_moe_ep4_ragged`` and ``serve_moe_tp4_ragged``: the padded
    serves' models, weights and requests (Mixtral-8x7B widths, 8 of 32
    layers, bf16, world 4 on the one card) under ``gg_config=
    GroupGemmConfig(ragged=True)``: EP with K27 and K29 (no K8), TP with K30
    and K31 (K29 inside; no K9/K10). Each prints tokens/s, TTFT, peak GB and
    the padding share of the rows computed beside its padded twin's of this
    run, whether its greedy tokens equal the padded serve's, its bf16
    prefill logits against the world-1 plain forward under its own expert
    choices, and whether those logits are bit-equal to the padded served
    forward's."""
    import torch
    from triton_dist_tpu_torch.layers.ep_moe_mlp import EPMoEMLP
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.ops.moe_mlp import tp_moe_mlp
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.utils import tally

    n_layers, L = 8, 128
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    ragged = GroupGemmConfig(MOE_BLOCK, ragged=True)
    make_served, make_plain = _moe_models()
    ctx = initialize_distributed(WORLD)
    out = {}
    cells = (("serve_moe_ep4_ragged", EP_MODEL, "serve_moe_ep4", EPMoEMLP,
              ("all_to_all", "group_gemm_ragged"),
              ("group_gemm", "ag_group_gemm", "moe_reduce_rs", "ag_group_gemm_ragged",
               "moe_reduce_rs_ragged")),
             ("serve_moe_tp4_ragged", MOE_MODEL, "serve_moe_tp4", tp_moe_mlp,
              ("ag_group_gemm_ragged", "moe_reduce_rs_ragged", "group_gemm_ragged"),
              ("group_gemm", "ag_group_gemm", "moe_reduce_rs", "all_to_all")))
    for name, model, twin, counted, used, unused in cells:
        base = presets.preset(model, n_layers=n_layers, batch=8, dtype=torch.bfloat16)
        cfg = dataclasses.replace(base, gg_config=ragged)
        params = init_moe_params(cfg, seed=30)  # the padded serves' weights
        reqs = _requests(cfg.vocab, lengths, 32, seed=31)
        counted.rows = counted.assignments = 0
        counted.live_rows = {}
        res = _serve(cfg, params, reqs, counters, ctx=ctx)
        share = 1 - counted.assignments / tally(counted.live_rows)
        launches = res["launches"]
        used = used + ("ag_gemm", "gemm_rs", "gemm", "all_gather", "paged_flash_decode",
                       "barrier")
        if any(launches[k] <= 0 for k in used) or any(launches[k] for k in unused):
            raise AssertionError(f"{name} took the wrong kernels: {launches}")
        pad = SERVES[twin]
        emit({"phase": name, "model": model, "n_layers": n_layers, "world": WORLD,
              "gg_config": "GroupGemmConfig(128, ragged=True)", "batch": 8, "s_max": 1024,
              "page_size": 16, "prompt_lens": lengths, "max_new_tokens": 32,
              "layout_rows": counted.rows, "computed_rows": tally(counted.live_rows),
              "assignments": counted.assignments, "padding_row_share": share,
              "tokens_equal_padded": _serve.outputs == pad["outputs"],
              "padded_twin": {k: pad[k] for k in ("tokens_per_s", "ttft_ms", "peak_mem_gb",
                                                  "wall_s", "padding_row_share")},
              **res})
        out[name] = launches
        flat = _prompt_tokens(reqs, cfg.batch, L)
        rows = torch.arange(cfg.batch, device="cuda") * L + L - 1
        got, routes = _served_logits(make_served, dataclasses.replace(cfg, seq=L), params, flat,
                                     rows, ctx, n_layers)
        _check_moe_logits(f"{name}_logits", got, routes, make_plain,
                          dataclasses.replace(cfg, seq=L), flat, params, rows)
        padded, _ = _served_logits(make_served, dataclasses.replace(base, seq=L), params, flat,
                                   rows, ctx, n_layers)
        emit({"phase": f"{name}_vs_padded", "logits_bit_equal": torch.equal(got, padded),
              "max_abs_diff": (got - padded).abs().max().item()})
        del params, got, padded
        torch.cuda.empty_cache()
    ctx.close()
    return out["serve_moe_ep4_ragged"], out["serve_moe_tp4_ragged"]


def phase_f32_parity_ragged() -> None:
    """f32, one layer at full Mixtral width, world 4: greedy tokens of the
    ragged EP and TP serves on the card (K29; K30, K31) identical to the
    CPU plain path's (the ragged twins) and to the padded serve's on the
    card. Batch 4, 2 requests, paged, bulk prefill; TF32 off."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lengths, max_new = [12, 33], 4

    def run(cfg, p, device):
        ctx = initialize_distributed(WORLD, device=device)
        b = ContinuousBatcher(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                              ctx=ctx)
        for r in _requests(cfg.vocab, lengths, max_new, seed=38):
            b.submit(r)
        got = dict(b.run())
        ctx.close()
        return got

    times = {}
    for model in (EP_MODEL, MOE_MODEL):
        base = presets.preset(model, n_layers=1, batch=4, dtype=torch.float32)
        params = init_moe_params(base, seed=37)
        cpu = {k: v.cpu() for k, v in params.items() if k != "layers"}
        cpu["layers"] = [{k: v.cpu() for k, v in p.items()} for p in params["layers"]]
        cfg = dataclasses.replace(base, gg_config=GroupGemmConfig(MOE_BLOCK, ragged=True))
        t0 = time.perf_counter()
        want = run(cfg, cpu, "cpu")
        t1 = time.perf_counter()
        got = run(cfg, params, "cuda")
        t2 = time.perf_counter()
        padded = run(base, params, "cuda")
        times[model] = dict(cpu_reference_s=t1 - t0, card_s=t2 - t1)
        if not got == want == padded:
            raise AssertionError(f"{model} ragged f32 greedy tokens: card {got}, CPU {want}, "
                                 f"padded {padded}")
        del params, cpu
    emit({"phase": "f32_parity_ragged", "models": list(times), "n_layers": 1, "world": WORLD,
          "requests": len(lengths), "max_new_tokens": max_new, "identical": True,
          "times": times})



# ---------------------------------- ragged MoE training, ring attention ----

RING_S, RING_HEADS, RING_D = 16384, 32, 128  # Llama-3.1-8B attention widths: s_loc 4096
SP_MODEL, SP_S = "llama-3.1-8b", 8192        # train_sp: s_loc 2048 a rank
TRAIN_READINGS = {}  # the padded train_moe's world-1 readings, for train_moe_ragged


def phase_group_gemm_dw_ragged() -> dict:
    """K34 at K11's shapes, the Mixtral backward (2048 tokens top-2 over 8
    experts, t_pad 5120) under the ragged alignment of a real routing:
    dw_up [5120, 4096] x [5120, 14336] and dw_down [5120, 14336] x [5120,
    4096], bf16, f32 out. Checks: within K11's tolerance (1e-4 x max|ref|)
    of the plain version; bit-equal to K11 on the same A and G with their
    dead rows zeroed (an f32 acc + 0 is exact); NaN in G's dead rows
    changes nothing; an all-dead map gives exact zeros. K11's ms on the
    same inputs beside K34's. The bound counts the live rows; the library
    is one torch.matmul per expert over its packed live rows."""
    import torch
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_utils as mu

    g = torch.Generator(device="cuda").manual_seed(81)
    n_exp, bm, bf16 = 8, MOE_BLOCK, torch.bfloat16
    _, ids = _moe_route(g, TRAIN_B * TRAIN_S, n_exp, 2)
    al = mu.moe_align_block_size(ids.reshape(-1), n_exp, bm, ragged=True)
    eids, valid = al.expert_ids, al.valid_rows
    t_pad = eids.numel() * bm
    live = (torch.arange(t_pad, device="cuda") % bm) < valid.long().repeat_interleave(bm)
    n_live = int(live.sum())
    rows_of = [torch.nonzero(live & (eids.long().repeat_interleave(bm) == e))[:, 0]
               for e in range(n_exp)]
    cfg = gg.GroupGemmConfig(bm, ragged=True)
    rows = {}
    total = dict(ms=0.0, k11_ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for name, (k, n) in {"dw_up": (4096, 14336), "dw_down": (14336, 4096)}.items():
        a = torch.randn((t_pad, k), generator=g, device="cuda").to(bf16)
        gr = torch.randn((t_pad, n), generator=g, device="cuda").to(bf16)

        def k34(a=a, gr=gr):
            return gg.group_gemm_dw(a, gr, eids, n_exp, valid_rows=valid, config=cfg)

        got = k34()
        ref = gg._group_gemm_dw_plain(a, gr, eids, n_exp, bm, valid)
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        del ref
        zeroed = [torch.where(live[:, None], x, 0) for x in (a, gr)]
        bit_equal = torch.equal(got, gg.group_gemm_dw(*zeroed, eids, n_exp))
        del zeroed
        junk = torch.where(live[:, None], gr, float("nan"))
        nan_unchanged = torch.equal(got, gg.group_gemm_dw(a, junk, eids, n_exp, valid_rows=valid,
                                                          config=cfg))
        del junk
        all_dead = bool(torch.all(gg.group_gemm_dw(a, gr, eids, n_exp,
                                                   valid_rows=torch.zeros_like(valid),
                                                   config=cfg) == 0))
        del got
        if not (err <= tol and bit_equal and nan_unchanged and all_dead):
            raise AssertionError(f"group_gemm_dw ragged {name}: err {err} (tol {tol}), bit-equal "
                                 f"to K11 {bit_equal}, NaN dead rows unchanged {nan_unchanged}, "
                                 f"all-dead zeros {all_dead}")
        a_e, g_e = [a[r] for r in rows_of if r.numel()], [gr[r] for r in rows_of if r.numel()]

        def library():  # one matmul per expert over its packed live rows
            return [torch.matmul(x.t(), y) for x, y in zip(a_e, g_e)]

        flops = 2.0 * n_live * k * n
        nbytes = 2.0 * n_live * (k + n) + 4.0 * n_exp * k * n
        row = dict(shape=[t_pad, k, n], live_rows=n_live, max_abs_err=err, tol=tol,
                   bit_equal_k11_on_zeroed_rows=bit_equal, nan_dead_rows_unchanged=nan_unchanged,
                   all_dead_zero=all_dead, ms=cuda_ms(k34, iters=5),
                   k11_ms=cuda_ms(lambda: gg.group_gemm_dw(a, gr, eids, n_exp), iters=5),
                   plain_ms=event_ms(lambda: gg._group_gemm_dw_plain(a, gr, eids, n_exp, bm,
                                                                     valid), iters=1),
                   library_ms=event_ms(library, iters=5), bound_ms=bound(flops, nbytes)[0])
        rows[name] = row
        for key in ("ms", "k11_ms", "plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, gr, a_e, g_e
    emit({"phase": "kernel", "kernel": "group_gemm_dw_ragged", "per_shape": rows,
          "tol": "1e-4 x max|ref|; bit-equal to K11 on zeroed dead rows"})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="group_gemm_dw_ragged", route="cuda",
        source="triton_dist_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_dist_tpu/ops/gg_pipeline.py:159",
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=total["ms"], k11_ms=total["k11_ms"], plain_ms=total["plain_ms"], bound_ms=b_ms,
        bound_by=by, library_ms=total["library_ms"],
        library="torch.matmul(a_e^T, g_e) per expert over its packed live rows",
        shapes=f"t_pad 5120 (2048 tokens, top-2 of 8), {n_live} live rows, ragged: dw_up "
               f"[8, 4096, 14336] + dw_down [8, 14336, 4096], f32 out (summed)",
    )


def _check_attention(name, got, got_lse, plain, plain_lse, golden):
    """K35's bf16 output against its plain version (one bf16 ulp of the
    output scale), its lse against the plain lse (1e-5 x its scale), and
    the SDPA golden over the gathered sequence (two ulps: both round P to
    bf16 for P.V, in other tiles)."""
    scale = plain.float().abs().max().item()
    err = (got.float() - plain.float()).abs().max().item()
    err_lse = (got_lse - plain_lse).abs().max().item()
    err_lib = (got.float() - golden.float()).abs().max().item()
    tol, tol_lse = 2.0**-7 * scale, 1e-5 * plain_lse.abs().max().item()
    if not (err <= tol and err_lse <= tol_lse and err_lib <= 2 * tol):
        raise AssertionError(f"{name}: max abs err {err} (tol {tol}), lse {err_lse} (tol "
                             f"{tol_lse}), against SDPA {err_lib} (tol {2 * tol})")
    return dict(max_abs_err=err, lse_err=err_lse, max_abs_err_sdpa=err_lib)


def phase_ring_attention(ctx) -> dict:
    """K35 at world 4 on the one card with Llama-3.1-8B attention widths
    (32 heads after the GQA repeat, head_dim 128), b 1, S 16384 (s_loc
    4096), bf16, in three cells: causal contiguous, causal zigzag (the
    shards of the permuted sequence) and non-causal. Each cell is held to
    the plain version on every rank and to F.scaled_dot_product_attention
    over the gathered sequence (the golden, timed as library_ms: the port
    never calls it), with its ms (CUDA events on the ranks' streams) and
    bound (operations: 4 b h s_loc S d a rank, half under the causal mask,
    summed over the ranks at one card's bf16 peak). Then one world-1 call
    (S 4096, causal). The entry's columns are the causal contiguous cell's;
    every cell is under ``cells``."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import ring_attention as ra

    g = torch.Generator(device="cuda").manual_seed(91)
    S, h, d, n = RING_S, RING_HEADS, RING_D, WORLD
    s_loc = S // n
    q, k, v = (torch.randn((1, h, S, d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    cells = {}
    for name, (causal, layout) in {"causal contig": (True, "contig"),
                                   "causal zigzag": (True, "zigzag"),
                                   "full": (False, "contig")}.items():
        perm = (torch.from_numpy(ra.zigzag_permutation(n, S)[0]).long().cuda()
                if layout == "zigzag" else torch.arange(S, device="cuda"))
        shards = [[x[:, :, perm[r * s_loc:(r + 1) * s_loc]].contiguous() for x in (q, k, v)]
                  for r in range(n)]

        def call(causal=causal, layout=layout, shards=shards):
            return ra.ring_attention(*shards[ctx.rank], ctx=ctx, causal=causal, layout=layout,
                                     return_lse=True)

        def plain(causal=causal, layout=layout, shards=shards):
            q3, k3, v3 = (x.reshape(h, s_loc, d) for x in shards[ctx.rank])
            out, m, l_ = ra._ring_attention_plain(q3, k3, v3, ctx, causal, layout)
            return out.reshape(1, h, s_loc, d), ra.lse_of(m, l_).reshape(1, h, s_loc)

        def library(causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        golden = library()[:, :, perm]
        got, want = ctx.run(call), ctx.run(plain)
        errs = [_check_attention(f"ring_attention {name} rank {r}", o, lse, p, p_lse,
                                 golden[:, :, r * s_loc:(r + 1) * s_loc])
                for r, ((o, lse), (p, p_lse)) in enumerate(zip(got, want))]
        del got, want, golden
        flops = 4.0 * h * s_loc * S * d * n * (0.5 if causal else 1.0)
        nbytes = 2.0 * 4 * h * S * d + 4.0 * h * S
        b_ms, by = bound(flops, nbytes)
        cells[name] = dict(
            max_abs_err=max(e["max_abs_err"] for e in errs),
            lse_err=max(e["lse_err"] for e in errs),
            max_abs_err_sdpa=max(e["max_abs_err_sdpa"] for e in errs),
            ms=dist_ms(ctx, call, iters=3), plain_ms=dist_ms(ctx, plain, iters=1, warmup=1),
            library_ms=cuda_ms(library, iters=5), bound_ms=b_ms, bound_by=by)
        emit({"phase": "kernel", "kernel": "ring_attention", "cell": name, "world": n,
              **cells[name]})
        del shards
    q1, k1, v1 = (x[:, :, :s_loc].contiguous() for x in (q, k, v))
    got, lse = ra.ring_attention(q1, k1, v1, return_lse=True)
    out, m, l_ = ra._ring_attention_plain(*(x.reshape(h, s_loc, d) for x in (q1, k1, v1)), None,
                                          True, "contig")
    golden = F.scaled_dot_product_attention(q1, k1, v1, is_causal=True)
    one = _check_attention("ring_attention world 1", got, lse, out.reshape(got.shape),
                           ra.lse_of(m, l_).reshape(lse.shape), golden)
    b_ms, by = bound(2.0 * h * s_loc * s_loc * d, 2.0 * 4 * h * s_loc * d + 4.0 * h * s_loc)
    one.update(ms=cuda_ms(lambda: ra.ring_attention(q1, k1, v1), iters=5),
               plain_ms=event_ms(lambda: ra._ring_attention_plain(
                   *(x.reshape(h, s_loc, d) for x in (q1, k1, v1)), None, True, "contig"),
                   iters=2),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q1, k1, v1,
                                                                         is_causal=True),
                                  iters=5), bound_ms=b_ms, bound_by=by)
    cells["world 1, S 4096 causal"] = one
    emit({"phase": "kernel", "kernel": "ring_attention", "cell": "world 1", **one})
    head = cells["causal contig"]
    return dict(
        name="ring_attention", route="cuda", source="triton_dist_tpu_torch/csrc/ring_attention.cu",
        replaces="triton_dist_tpu/ops/ring_attention.py:145",
        max_abs_err=max(c["max_abs_err"] for c in cells.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        library="F.scaled_dot_product_attention over the gathered sequence", cells=cells,
        shapes=f"world {n}: b 1, {h} heads, d {d}, S {S} (s_loc {s_loc}), bf16, causal "
               f"contiguous (the columns); zigzag, non-causal and world 1 under cells",
    )


def phase_stuck_wait_ring_attention() -> None:
    """Ring attention at world 4 whose rank 1 never comes in time (its
    stream held 2 s, the wait timeout 0.2 s): rank 0's blocks wait first
    for their right neighbour's arrival and record (0, ring_attention,
    site 1); rank 2 waits first for the chunk of its left neighbour, rank
    1 (its step-0 put), and records site world + 0. Rank 3 may also time
    out on rank 2's step-1 put, which rank 2 issues only after its own
    wait expired."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import ring_attention as ra
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    ctx = initialize_distributed(WORLD)
    g = torch.Generator(device="cuda").manual_seed(92)
    xs = [[torch.randn((1, 4, 256, 128), generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(3)] for _ in range(WORLD)]

    def call():
        if ctx.rank == 1 and stuck:
            common.sleep_on_stream(2_000_000_000)
        return ra.ring_attention(*xs[ctx.rank], ctx=ctx)

    stuck = False
    ctx.run(call)  # the buffers and flags exist
    stuck = True
    t0 = time.perf_counter()
    try:
        with config.wait_timeout(0.2):
            ctx.run(call)
    except DistTimeoutError as err:
        recs = err.records
    else:
        raise AssertionError("a stuck ring-attention wait did not raise")
    got = {(r["pe"], r["family"], r["site"]) for r in recs}
    fixed = {(0, "ring_attention", 1), (2, "ring_attention", WORLD)}
    if not (fixed <= got and got - fixed <= {(3, "ring_attention", WORLD + 16)}):
        raise AssertionError(f"stuck ring-attention wait: unexpected records {recs}")
    emit({"phase": "stuck_wait_ring_attention", "raised_after_s": time.perf_counter() - t0,
          "records": recs})
    ctx.close()


def phase_train_moe_ragged(counters: Counters) -> tuple[dict, dict]:
    """``train_moe``'s configuration (Mixtral-8x7B widths, 8 of 32 layers,
    bf16, 2 x 1024 tokens, SGD at TRAIN_LR, the same weights and batch)
    under ``GroupGemmConfig(ragged=True)``: a warm-up and 3 timed steps at
    world 1 (losses finite and falling; K29 and K34 launched, K8 and K11
    not; the step-1 loss within 2e-2 relative of the padded run's), its
    step wall, tokens/s and peak GB beside the padded run's of the same
    call; then one step at world 4 on the one card (K30, K31, K29, K34)."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    n_layers = 8
    cfg = presets.preset(MOE_MODEL, n_layers=n_layers, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16, gg_config=GroupGemmConfig(MOE_BLOCK, ragged=True))
    tokens, targets = _train_batch(cfg.vocab, seed=51)
    one = _train_world1("train_moe_ragged", ttm.TPMoETransformer(cfg),
                        lambda: ttm.init_moe_params(cfg, seed=50), tokens, targets, counters,
                        TRAIN_LR)
    padded = TRAIN_READINGS["train_moe"]
    rel = abs(one["losses"][0] - padded["losses"][0]) / abs(padded["losses"][0])
    one.update(model=MOE_MODEL, n_layers=n_layers, padded=padded,
               step1_loss_rel_err_vs_padded=rel, tol_step1_loss_rel=2e-2)
    emit(one)
    _check_train("train_moe_ragged", one["losses"], one["launches"], one["plain_calls"],
                 ("gemm", "group_gemm_ragged", "group_gemm_dw_ragged"))
    if one["launches"]["group_gemm"] or one["launches"]["group_gemm_dw"] or not rel <= 2e-2:
        raise AssertionError(f"train_moe_ragged: K8 {one['launches']['group_gemm']} / K11 "
                             f"{one['launches']['group_gemm_dw']} launches, step-1 loss "
                             f"{one['losses'][0]} against the padded {padded['losses'][0]}")
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
                                        targets, lr=TRAIN_LR, dp_axis=None)
        return loss.item()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    loss = ctx.run(step, grad=True)[0]
    wall = time.perf_counter() - t0
    counts = counters.read()
    four = dict(phase="train_moe_ragged_tp4", world=WORLD, loss=loss, step_wall_s=wall,
                train_tokens_per_s=TRAIN_B * TRAIN_S / wall,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **counts)
    emit(four)
    used = ("ag_group_gemm_ragged", "moe_reduce_rs_ragged", "group_gemm_ragged",
            "group_gemm_dw_ragged")
    if (not math.isfinite(loss) or any(counts["launches"][k] <= 0 for k in used)
            or counts["launches"]["group_gemm_dw"] or any(counts["plain_calls"].values())):
        raise AssertionError(f"train_moe_ragged_tp4: loss {loss}, {counts}")
    del state, models
    ctx.close()
    return one["launches"], counts["launches"]


def _sp_batch(vocab, batch, seq, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, vocab, (batch, seq), generator=g, device="cuda")
    return tokens, torch.roll(tokens, -1, 1)


def _sp_config(base, zigzag):
    from triton_dist_tpu_torch.models.sp_transformer import SPTransformerConfig

    return SPTransformerConfig(**{f.name: getattr(base, f.name)
                                  for f in dataclasses.fields(base)}, zigzag=zigzag)


def phase_train_sp(counters: Counters) -> dict:
    """``SPTransformer`` at Llama-3.1-8B widths cut to 2 of 32 layers (the
    train_dense cut), world 4 on the one card, b 1, S 8192 (s_loc 2048),
    bf16, seeded weights (the dense tree, replicated), contiguous and
    zigzag: a warm-up and 3 SGD steps at DENSE_LR each (losses finite and
    falling), K35 launched and no plain attention, step wall, tokens/s
    (b S / step wall) and peak GB."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import sp_transformer as spm
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.ops import ring_attention as ra
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    base = presets.preset(SP_MODEL, n_layers=2, batch=1, seq=SP_S, dtype=torch.bfloat16)
    params = ttm.init_params(base, seed=56)
    tokens, targets = _sp_batch(base.vocab, 1, SP_S, seed=57)
    ctx = initialize_distributed(WORLD)
    s_loc = SP_S // WORLD
    launches, runs = {}, {}
    for layout in ("contig", "zigzag"):
        cfg = _sp_config(base, layout == "zigzag")
        perm = (torch.from_numpy(ra.zigzag_permutation(WORLD, SP_S)[0]).long().cuda()
                if layout == "zigzag" else torch.arange(SP_S, device="cuda"))
        t, y = tokens[:, perm], targets[:, perm]
        models = [spm.SPTransformer(cfg, ctx=ctx) for _ in range(WORLD)]
        state = [params] * WORLD

        def step(t=t, y=y, models=models, state=state):
            r = ctx.rank
            rows = slice(r * s_loc, (r + 1) * s_loc)
            state[r], loss = spm.sp_train_step(models[r], state[r], t[:, rows], y[:, rows],
                                               lr=DENSE_LR)
            return loss.item()

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
        del state, models
        torch.cuda.empty_cache()
        wall = sorted(walls)[len(walls) // 2]
        runs[layout] = dict(phase=f"train_sp_{layout}", model=SP_MODEL, n_layers=2, world=WORLD,
                            batch=1, seq=SP_S, s_loc=s_loc, lr=DENSE_LR, losses=losses,
                            step_wall_s=walls, step_wall_s_median=wall,
                            train_tokens_per_s=SP_S / wall, peak_mem_gb=peak, **counts)
        emit(runs[layout])
        _check_train(f"train_sp_{layout}", losses, counts["launches"], counts["plain_calls"],
                     ("ring_attention",))
        for key, value in counts["launches"].items():
            launches[key] = launches.get(key, 0) + value
    ctx.close()
    return launches


def _dense_attention(q, k, v, *, ctx=None, causal=True, config=None, layout="contig"):
    """The plain path's attention (world 1, natural order): dense causal
    softmax attention differentiated by PyTorch's autograd."""
    import torch

    del ctx, config, layout
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, -1) @ v


def phase_f32_parity_sp() -> None:
    """f32, SP at small width on the card (vocab 2048, hidden 512, 8 query
    and 2 kv heads of 128, 2 layers, batch 2 x 1024 tokens), world 4,
    contiguous and zigzag: the logits of every rank's rows, the ranks' mean
    loss, every gradient and every updated parameter of ``sp_train_step``
    against the plain path on the card — the same model at world 1 over
    the whole sequence with dense attention, differentiated by PyTorch —
    on the same weights, TF32 off: logits, gradients and parameters within
    1e-4 relative L2, the loss within 1e-5 relative."""
    import torch
    from unittest import mock
    from triton_dist_tpu_torch.models import sp_transformer as spm
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.ops import ring_attention as ra
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ttm.TransformerConfig(vocab=2048, hidden=512, ffn=1024, n_layers=2, n_q_heads=8,
                                 n_kv_heads=2, head_dim=128, batch=2, seq=1024)
    params = ttm.init_params(base, seed=58)
    tokens, targets = _sp_batch(base.vocab, base.batch, base.seq, seed=59)
    lr, s_loc = 0.1, base.seq // WORLD
    with mock.patch.object(spm, "ring_attention_grad", _dense_attention):
        plain = spm.SPTransformer(_sp_config(base, False))
        with torch.no_grad():
            logits_ref = plain(tokens, params)
        loss_ref, g_ref = spm._sp_loss_and_grads(plain, params, tokens, targets)
    leaves = ttm._tree_leaves(params)
    ctx = initialize_distributed(WORLD)
    report = {}
    for layout in ("contig", "zigzag"):
        cfg = _sp_config(base, layout == "zigzag")
        perm = (torch.from_numpy(ra.zigzag_permutation(WORLD, base.seq)[0]).long().cuda()
                if layout == "zigzag" else torch.arange(base.seq, device="cuda"))

        def rank(cfg=cfg, perm=perm):
            r = ctx.rank
            rows = perm[r * s_loc:(r + 1) * s_loc]
            model = spm.SPTransformer(cfg, ctx=ctx)
            t, y = tokens[:, rows], targets[:, rows]
            with torch.no_grad():
                logits = model(t, params)
            loss, grads = spm._sp_loss_and_grads(model, params, t, y)
            new, step_loss = spm.sp_train_step(model, params, t, y, lr=lr)
            return logits, loss.item(), grads, ttm._tree_leaves(new), step_loss.item()

        outs = ctx.run(rank, grad=True)
        logits = torch.empty_like(logits_ref)
        for r, o in enumerate(outs):
            logits[:, perm[r * s_loc:(r + 1) * s_loc]] = o[0]
        worst = dict(logits_rel_l2=_rel_l2(logits, logits_ref), loss_rel=0.0, grad_rel_l2=0.0,
                     param_rel_l2=0.0)
        for _, loss, grads, new, step_loss in outs:
            worst["loss_rel"] = max(worst["loss_rel"], abs(loss - loss_ref.item()) / abs(
                loss_ref.item()), abs(step_loss - loss_ref.item()) / abs(loss_ref.item()))
            for g_, want, p, q_ in zip(grads, g_ref, leaves, new):
                worst["grad_rel_l2"] = max(worst["grad_rel_l2"], _rel_l2(g_, want))
                worst["param_rel_l2"] = max(worst["param_rel_l2"], _rel_l2(q_, p - lr * want))
        del outs, logits
        report[layout] = worst
        if not (worst["logits_rel_l2"] <= 1e-4 and worst["loss_rel"] <= 1e-5
                and worst["grad_rel_l2"] <= 1e-4 and worst["param_rel_l2"] <= 1e-4):
            raise AssertionError(f"f32 SP parity ({layout}): {worst}")
    ctx.close()
    emit({"phase": "f32_parity_sp", "world": WORLD, "dims": dataclasses.asdict(base) | {
        "dtype": "float32"}, "reference": "world 1 over the whole sequence, dense attention, "
          "PyTorch autograd, on the card", "worst": report,
          "tol": {"logits_rel_l2": 1e-4, "loss_rel": 1e-5, "grad_rel_l2": 1e-4,
                  "param_rel_l2": 1e-4}})


# ------------------------------------------- the 2-D rank runtime (slice 13) ----

PAIR = {"dp": 2, "tp": 2}
GRIDS_2D = {  # name: (mesh shape, the axes gathered over: None is the runtime's own)
    "2x2": ({"dp": 2, "tp": 2}, None),
    "2x4": ({"dp": 2, "tp": 4}, None),
    "4x2": ({"dp": 4, "tp": 2}, None),
    "2x2 (tp, dp)": ({"dp": 2, "tp": 2}, ("tp", "dp")),
}
HIER_MODEL = "mixtral-8x7b:ep-hier"
HIER_MESH = {"dcn": 2, "tp": 2}


def _pair_order(shape, axes):
    """The global ranks in the gathered order of a tuple of axes."""
    import itertools

    names = list(shape)
    axes = axes or tuple(names)
    order = []
    for idx in itertools.product(*(range(shape[a]) for a in axes)):
        c = dict(zip(axes, idx))
        r = 0
        for a in names:
            r = r * shape[a] + c[a]
        order.append(r)
    return order


def phase_all_gather_2d() -> dict:
    """K36 (``csrc/ring.cu``) over a (dp, tp) pair at K19's payloads (the SP
    combine [516, 128] f32 and the Mixtral token slab [512, 4096] bf16 a
    rank), at 2 x 2, 2 x 4, 4 x 2 (world 8 on the one card: rings of four
    name a wrong neighbour that rings of two hide) and over the swapped
    pair ("tp", "dp"): bit-exact against the plain gather (a copy), and
    against K19 over the flattened ring of the same ranks; a 3-axis gather
    on 2 x 2 x 2 (two pair groups at once, then the staged outer gather).
    Timed at 2 x 2 beside K19 at world 4 in this call; the bound is K19's
    (the same bytes), the library ``torch.cat`` of the shards."""
    import torch
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    g = torch.Generator(device="cuda").manual_seed(130)
    shapes = _gather_shapes()
    checked = {}
    for grid, (mesh, axes) in GRIDS_2D.items():
        n = math.prod(mesh.values())
        ctx = initialize_distributed(mesh_shape=mesh)
        flat = initialize_distributed(n)
        flat.full_mesh = False
        order = _pair_order(mesh, axes)
        for name, (shape, dtype, _) in shapes.items():
            x = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(n)]
            want = torch.cat([x[r] for r in order])
            outs = ctx.run(lambda: ag.all_gather(x[ctx.rank], ctx=ctx, axis=axes))
            if not all(torch.equal(got, want) for got in outs):
                raise AssertionError(f"all_gather_2d {grid} {name}: not bit-exact")
            if axes is None:
                ring = flat.run(lambda: ag.all_gather(x[flat.rank], ctx=flat, method="ring_1d"))
                if not all(torch.equal(a, b) for a, b in zip(outs, ring)):
                    raise AssertionError(f"all_gather_2d {grid} {name}: differs from K19")
            del outs, x
        checked[grid] = "bit-exact" + (", = K19" if axes is None else "")
        ctx.close()
        flat.close()
    ctx = initialize_distributed(mesh_shape={"pp": 2, "dp": 2, "tp": 2})
    x = [torch.randn((512, 128), generator=g, device="cuda") for _ in range(8)]
    if not all(torch.equal(got, torch.cat(x))
               for got in ctx.run(lambda: ag.all_gather(x[ctx.rank], ctx=ctx))):
        raise AssertionError("all_gather over (pp, dp, tp): not bit-exact")
    checked["2x2x2 (pp, dp, tp)"] = "bit-exact"
    ctx.close()

    ctx = initialize_distributed(mesh_shape=PAIR)
    flat = initialize_distributed(WORLD)
    flat.full_mesh = False
    per_shape, total = {}, dict(ms=0.0, k19_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0)
    for name, (shape, dtype, _) in shapes.items():
        x = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(WORLD)]
        shard = x[0].numel() * x[0].element_size()
        row = dict(
            ms=dist_ms(ctx, lambda: ag.all_gather(x[ctx.rank], ctx=ctx), iters=20),
            k19_ms=dist_ms(flat, lambda: ag.all_gather(x[flat.rank], ctx=flat,
                                                       method="ring_1d"), iters=20),
            plain_ms=dist_ms(ctx, lambda: ag._all_gather_xla(x[ctx.rank], ctx), iters=20),
            library_ms=cuda_ms(lambda: [torch.cat(x) for _ in range(WORLD)], iters=20),
            bytes=WORLD * shard * (1.0 + WORLD))
        per_shape[name] = row
        for key in total:
            total[key] += row[key]
        del x
    ctx.close()
    flat.close()
    b_ms, by = bound(0.0, total["bytes"])
    entry = dict(
        name="all_gather_2d", route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
        replaces="triton_dist_tpu/ops/allgather.py:284", max_abs_err=0.0, ms=total["ms"],
        plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"], library="torch.cat of the shards",
        k19_ms_world4_ring=total["k19_ms"], checks=checked, per_shape=per_shape,
        shapes="(dp 2, tp 2): [516, 128] f32 + [512, 4096] bf16 a rank (summed); checked "
               "also at 2 x 4, 4 x 2, (tp, dp) and 2 x 2 x 2")
    emit({"phase": "kernel", "kernel": "all_gather_2d", **{k: entry[k] for k in (
        "checks", "per_shape", "ms", "k19_ms_world4_ring", "plain_ms", "bound_ms",
        "library_ms", "shapes")}})
    return entry


def phase_ag_gemm_2d() -> dict:
    """K37 over a (dp, tp) pair at K6's shapes (a 4-way Llama-3.1-70B
    prefill's column projections: a [512, 8192] a rank, n_loc 2560, 14336,
    32064), bf16: every output bit-equal to K15's over the flattened ring
    (one span: the same K loop over the same rows), within one bf16 ulp of
    the output scale of its 2-D-order plain version, the gathered A
    bit-exact; timed beside K6 (full mesh) and K15 in this call, the bound
    K6's (the same work), the library ``torch.cat`` + ``torch.matmul``.
    Then 2 x 4, 4 x 2 and (tp, dp) at the wqkv shape, f32 at 2 x 2."""
    import torch
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    g = torch.Generator(device="cuda").manual_seed(131)
    m_loc, k = 512, 8192

    def check(grid, ctx, flat, a, b, dtype, axes=None):
        outs = ctx.run(lambda: (
            agg.ag_gemm(a[ctx.rank], b, ctx=ctx, axis=axes, gather_output=True),
            agg._ag_gemm_2d_plain(a[ctx.rank], b, ctx.group(axes) if axes else ctx, False,
                                  dtype)))
        order = _pair_order(ctx.mesh_shape, axes)
        a_full = torch.cat([a[r] for r in order])
        k15 = None if axes else flat.run(lambda: agg.ag_gemm(a[flat.rank], b, ctx=flat))
        err = 0.0
        for r, ((out, ag), plain) in enumerate(outs):
            if not torch.equal(ag, a_full):
                raise AssertionError(f"ag_gemm_2d {grid}: gathered A not bit-exact")
            if k15 is not None and not torch.equal(out, k15[r]):
                raise AssertionError(f"ag_gemm_2d {grid} rank {r}: not bit-equal to K15")
            err = max(err, _check_ring(f"ag_gemm_2d {grid} rank {r}", out, plain, plain,
                                       ctx.world)[0])
        return err

    checks = {}
    for grid, (mesh, axes) in GRIDS_2D.items():
        if grid == "2x2":
            continue
        n = math.prod(mesh.values())
        ctx = initialize_distributed(mesh_shape=mesh)
        flat = initialize_distributed(n)
        flat.full_mesh = False
        a = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16() for _ in range(n)]
        b = (torch.randn((k, 2560), generator=g, device="cuda") / k**0.5).bfloat16()
        checks[f"{grid} wqkv bf16"] = check(grid, ctx, flat, a, b, torch.bfloat16, axes)
        del a, b
        ctx.close()
        flat.close()
    ctx = initialize_distributed(mesh_shape=PAIR)
    flat = initialize_distributed(WORLD)
    flat.full_mesh = False
    mesh = initialize_distributed(WORLD)
    a = [torch.randn((m_loc, k), generator=g, device="cuda") for _ in range(WORLD)]
    b = torch.randn((k, 2560), generator=g, device="cuda") / k**0.5
    checks["2x2 wqkv f32"] = check("2x2 f32", ctx, flat, a, b, torch.float32)
    rows, worst = [], 0.0
    total = dict(ms=0.0, k15_ms=0.0, k6_ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                 bytes=0.0)
    for name, n_loc in (("wqkv", 2560), ("gate_up", 14336), ("lm_head", 32064)):
        a = [torch.randn((m_loc, k), generator=g, device="cuda").bfloat16()
             for _ in range(WORLD)]
        b = (torch.randn((k, n_loc), generator=g, device="cuda") / k**0.5).bfloat16()
        err = check(f"2x2 {name}", ctx, flat, a, b, torch.bfloat16)
        worst = max(worst, err)
        flops = WORLD * 2.0 * WORLD * m_loc * k * n_loc
        nbytes = 2.0 * (WORLD * m_loc * k + WORLD * k * n_loc + WORLD * WORLD * m_loc * n_loc)
        row = dict(
            shape=[m_loc, k, n_loc], max_abs_err=err,
            ms=dist_ms(ctx, lambda: agg.ag_gemm(a[ctx.rank], b, ctx=ctx), iters=5),
            k15_ms=dist_ms(flat, lambda: agg.ag_gemm(a[flat.rank], b, ctx=flat), iters=5),
            k6_ms=dist_ms(mesh, lambda: agg.ag_gemm(a[mesh.rank], b, ctx=mesh), iters=5),
            plain_ms=dist_ms(ctx, lambda: agg._ag_gemm_2d_plain(a[ctx.rank], b, ctx, False,
                                                                torch.bfloat16), iters=2),
            library_ms=cuda_ms(lambda: [torch.matmul(torch.cat(a), b) for _ in range(WORLD)],
                               iters=3),
            bound_ms=bound(flops, nbytes)[0])
        row["tflops"] = flops / row["ms"] / 1e9
        rows.append({name: row})
        for key in ("ms", "k15_ms", "k6_ms", "plain_ms", "library_ms"):
            total[key] += row[key]
        total["flops"] += flops
        total["bytes"] += nbytes
        del a, b
    checks["2x2 bf16 (three shapes)"] = worst
    for c in (ctx, flat, mesh):
        c.close()
    emit({"phase": "kernel", "kernel": "ag_gemm_2d", "per_shape": rows, "checks": checks,
          "k15_ms_summed": total["k15_ms"], "k6_ms_summed": total["k6_ms"]})
    b_ms, by = bound(total["flops"], total["bytes"])
    return dict(
        name="ag_gemm_2d", route="cuda", source="triton_dist_tpu_torch/csrc/ring.cu",
        replaces="triton_dist_tpu/ops/allgather_gemm.py:179", max_abs_err=worst,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=b_ms, bound_by=by,
        library_ms=total["library_ms"], library="torch.cat + torch.matmul",
        k15_ms_world4_ring=total["k15_ms"], k6_ms_world4=total["k6_ms"], checks=checks,
        shapes="(dp 2, tp 2): a [512, 8192] a rank; n_loc 2560, 14336, 32064 (summed); "
               "checked also at 2 x 4, 4 x 2, (tp, dp), f32")


def phase_stuck_wait_2d() -> None:
    """K36 and K37 at 2 x 2 with rank 1's stream held 2 s before the launch
    (wait timeout 0.2 s): every other rank's entry barrier waits for the
    pair's ranks in rank order, so ranks 0, 2 and 3 each record site 1
    (the arrival of rank 1), naming their global rank and the group."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    a = torch.randn((64, 128), device="cuda")
    b = torch.randn((128, 64), device="cuda")
    report = {}
    for family, op in (("all_gather_2d", lambda ctx: ag.all_gather(a, ctx=ctx)),
                       ("ag_gemm_2d", lambda ctx: agg.ag_gemm(a, b, ctx=ctx))):
        ctx = initialize_distributed(mesh_shape=PAIR)
        ctx.run(lambda: op(ctx))  # the buffers and flags exist

        def body():
            if ctx.rank == 1:
                common.sleep_on_stream(2_000_000_000)
            return op(ctx)

        t0 = time.perf_counter()
        try:
            with config.wait_timeout(0.2):
                ctx.run(body)
        except DistTimeoutError as err:
            recs = err.records
        else:
            raise AssertionError(f"a stuck {family} wait did not raise")
        got = sorted((r["pe"], r["family"], r["site"], r["rank"], r["group"]) for r in recs)
        if got != [(p, family, 1, p, "dp,tp") for p in (0, 2, 3)]:
            raise AssertionError(f"stuck {family} wait: unexpected records {recs}")
        report[family] = dict(raised_after_s=time.perf_counter() - t0, records=recs)
        ctx.close()
    emit({"phase": "stuck_wait_2d", **report})


def phase_layers_2d(counters: Counters) -> dict:
    """The layer tier over an axis pair, world 4 as (dp 2, tp 2), one
    counted run: ``TPMLP(axis=("dp", "tp"))`` at Llama-3.1-70B widths (2048
    tokens, 512 a rank; H 8192, F 28672 over the four ranks: K37, then the
    2-D GEMM-RS, K7 over tp and K12 over dp) and ``TPMoEMLP(axis=("dp",
    "tp"))`` at Mixtral widths (2048 tokens, H 4096, F 14336 over the four
    ranks, 8 experts, top-2) overlapped (K9/K10 over the flattened pair)
    and sequential (K36, K8, K8, the 2-D reduce-scatter), bf16, each
    against the world-1 plain forward on the card (5e-2 relative L2) and
    timed a call."""
    import torch
    from triton_dist_tpu_torch.layers import TPMLP, TPMoEMLP
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig, gelu
    from triton_dist_tpu_torch.ops.moe_utils import select_experts
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    axes = ("dp", "tp")
    g = torch.Generator(device="cuda").manual_seed(132)
    m_tot = 2048
    m_loc = m_tot // WORLD
    ctx = initialize_distributed(mesh_shape=PAIR)
    # TPMLP at 70B widths
    h, f = 8192, 28672
    f_loc = f // WORLD
    x = torch.randn((m_tot, h), generator=g, device="cuda").bfloat16()
    w_up = (torch.randn((h, f), generator=g, device="cuda") / h**0.5).bfloat16()
    w_down = (torch.randn((f, h), generator=g, device="cuda") / f**0.5).bfloat16()
    ref_mlp = _matmul_plain(gelu(_matmul_plain(x, w_up, torch.float32)).bfloat16(), w_down,
                            torch.bfloat16)
    ups = [w_up[:, r * f_loc:(r + 1) * f_loc].contiguous() for r in range(WORLD)]
    downs = [w_down[r * f_loc:(r + 1) * f_loc].contiguous() for r in range(WORLD)]
    del w_up, w_down
    mlp = TPMLP(ctx, axis=axes)

    def run_mlp():
        r = ctx.axis_index(axes)
        return mlp(x[r * m_loc:(r + 1) * m_loc], ups[r], downs[r])

    # TPMoEMLP at Mixtral widths
    hm, fm, n_exp, topk = 4096, 14336, 8, 2
    fm_loc = fm // WORLD
    xm = torch.randn((m_tot, hm), generator=g, device="cuda").bfloat16()
    wu = (torch.randn((n_exp, hm, fm), generator=g, device="cuda") / hm**0.5).bfloat16()
    wd = (torch.randn((n_exp, fm, hm), generator=g, device="cuda") / fm**0.5).bfloat16()
    tw, ids = select_experts(torch.randn((m_tot, n_exp), generator=g, device="cuda"), topk)
    ref_moe = _moe_mlp_plain(xm.float(), wu.float(), wd.float(), ids, tw).bfloat16()
    wus = [wu[:, :, r * fm_loc:(r + 1) * fm_loc].contiguous() for r in range(WORLD)]
    wds = [wd[:, r * fm_loc:(r + 1) * fm_loc].contiguous() for r in range(WORLD)]
    del wu, wd
    moes = {ov: TPMoEMLP(ctx, gg_config=GroupGemmConfig(MOE_BLOCK), overlap=ov, axis=axes)
            for ov in (True, False)}

    def run_moe(ov):
        r = ctx.axis_index(axes)
        rows = slice(r * m_loc, (r + 1) * m_loc)
        return moes[ov](xm[rows], wus[r], wds[r], ids[rows], tw[rows])

    counters.reset()
    outs = ctx.run(lambda: (run_mlp(), run_moe(True), run_moe(False)))
    torch.cuda.synchronize()
    counts = counters.read()
    errs = {
        "tp_mlp": _rel_l2(torch.cat([o[0] for o in outs]), ref_mlp),
        "tp_moe_mlp_overlap": _rel_l2(torch.cat([o[1] for o in outs]), ref_moe),
        "tp_moe_mlp_sequential": _rel_l2(torch.cat([o[2] for o in outs]), ref_moe),
    }
    del outs
    launches = counts["launches"]
    used = ("ag_gemm_2d", "gemm_rs", "reduce_scatter", "all_gather_2d", "group_gemm",
            "ag_group_gemm", "moe_reduce_rs")
    if any(launches[k] <= 0 for k in used) or any(counts["plain_calls"].values()):
        raise AssertionError(f"layers_2d: launches {launches}, plain {counts['plain_calls']}")
    if not all(e <= 5e-2 for e in errs.values()):
        raise AssertionError(f"layers_2d: relative L2 against the world-1 plain forward {errs}")
    ms = dict(tp_mlp=dist_ms(ctx, run_mlp, iters=3),
              tp_moe_mlp_overlap=dist_ms(ctx, lambda: run_moe(True), iters=3),
              tp_moe_mlp_sequential=dist_ms(ctx, lambda: run_moe(False), iters=3))
    ctx.close()
    emit({"phase": "layers_2d", "mesh": PAIR, "tokens": m_tot, "rel_l2": errs,
          "tol_rel_l2": 5e-2, "ms_a_call": ms,
          "widths": {"tp_mlp": "llama-3.1-70b H 8192 F 28672",
                     "tp_moe_mlp": "mixtral-8x7b H 4096 F 14336, 8 experts, top-2"},
          **counts})
    return launches


def phase_serve_moe_ep_hier(counters: Counters) -> dict:
    """``serve_moe_ep_hier``: ``ServingEngine`` on a ``{"dcn": 2, "tp": 2}``
    runtime serving ``preset("mixtral-8x7b:ep-hier", n_layers=8)`` with
    ``serve_moe``'s weights and requests (batch 8, s_max 1024, 16-token
    pages, 8 requests of 32-256 prompt tokens, 32 new, bulk prefill): each
    dcn group serves 4 of the 8 slots with TP attention over its tp pair
    (K6/K7, K3/K5), the experts spread over the four ranks (two whole
    experts a rank), the MoE layers' two-phase dispatch over (dcn, tp):
    K27 in both phases (the dcn and the tp groups' all-to-all epochs both
    rise) and K8 on the received rows, no plain transport. Reported beside
    ``serve_moe_ep4`` (the flat EP serve of this call): tokens/s, TTFT,
    peak and expert-bank GB, and the share of greedy tokens equal to it."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models.tp_transformer import init_moe_params
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    cfg = presets.preset(HIER_MODEL, n_layers=8, batch=8, dtype=torch.bfloat16)
    params = init_moe_params(cfg, seed=30)  # serve_moe's weights
    lengths = [32, 48, 64, 100, 128, 160, 200, 256]
    reqs = _requests(cfg.vocab, lengths, 32, seed=31)
    ctx = initialize_distributed(mesh_shape=HIER_MESH)
    res = _serve(cfg, params, reqs, counters, ctx=ctx)
    launches = res["launches"]
    used = ("all_to_all", "group_gemm", "ag_gemm", "gemm_rs", "all_gather",
            "paged_flash_decode", "barrier")
    unused = ("ag_group_gemm", "moe_reduce_rs", "all_to_all_chunked", "group_gemm_ragged")
    if any(launches[k] <= 0 for k in used) or any(launches[k] for k in unused):
        raise AssertionError(f"serve_moe_ep_hier took the wrong kernels: {launches}")
    phases = {f"{axis}_all_to_all_launches": sum(e[f"{axis}:all_to_all"] for e in ctx._epochs)
              for axis in HIER_MESH}
    if not all(v > 0 for v in phases.values()):
        raise AssertionError(f"serve_moe_ep_hier: a dispatch phase did not run K27: {phases}")
    flat = SERVES.get("serve_moe_ep4", {})
    same = None
    if "outputs" in flat:
        pairs = [(a, b) for uid in flat["outputs"]
                 for a, b in zip(flat["outputs"][uid], _serve.outputs[uid])]
        same = sum(a == b for a, b in pairs) / len(pairs)
    ctx.close()
    emit({"phase": "serve_moe_ep_hier", "model": HIER_MODEL, "n_layers": 8, "mesh": HIER_MESH,
          "batch": 8, "s_max": 1024, "page_size": 16, "prompt_lens": lengths,
          "max_new_tokens": 32, "expert_bank_gb": _bank_gb(params), **phases,
          "serve_moe_ep4": {k: flat.get(k) for k in ("tokens_per_s", "ttft_ms", "peak_mem_gb",
                                                     "wall_s")},
          "greedy_token_share_equal_to_serve_moe_ep4": same, **res})
    del params
    return launches


def phase_train_dp_tp(counters: Counters) -> dict:
    """``train_dp_tp``: ``train_step(dp_axis="dp")`` on a ``{"dp": 2, "tp":
    2}`` runtime at Llama-3.1-8B widths cut to 2 of 32 layers (the
    train_dense cut), bf16, seeded weights, 2 x 1024 tokens a dp group (1024
    a rank), SGD at DENSE_LR: a warm-up and 3 steps, losses finite and
    falling, every parameter bitwise equal on the two dp groups after each
    step (the replicas do not drift), K6/K7 over the tp groups, no plain
    projection; step wall, tokens/s and peak GB."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    cfg = presets.preset("llama-3.1-8b", n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16)
    dp, tp = PAIR["dp"], PAIR["tp"]
    m = TRAIN_B * TRAIN_S
    tokens = torch.cat([_train_batch(cfg.vocab, seed=60 + d)[0] for d in range(dp)])
    targets = torch.cat([_train_batch(cfg.vocab, seed=60 + d)[1] for d in range(dp)])
    ctx = initialize_distributed(mesh_shape=PAIR)
    shards = ttm.shard_params(ttm.init_params(cfg, seed=52), cfg=cfg, ctx=ctx)
    m_loc = m // tp
    models = [ttm.TPTransformer(cfg, ctx=ctx) for _ in range(WORLD)]

    def step():
        r, d = ctx.rank, ctx.axis_index("dp")
        shards[r], loss = ttm.train_step(models[r], shards[r],
                                         tokens[r * m_loc:(r + 1) * m_loc],
                                         targets[d * m:(d + 1) * m], lr=DENSE_LR)
        return loss.item()

    def replicas_equal():
        for r in range(tp):
            for a, b in zip(ttm._tree_leaves(shards[r]), ttm._tree_leaves(shards[tp + r])):
                if not torch.equal(a, b):
                    raise AssertionError("train_dp_tp: the dp replicas drifted apart")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [ctx.run(step, grad=True)[0]], []
    replicas_equal()
    counters.reset()
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(ctx.run(step, grad=True)[0])
        walls.append(time.perf_counter() - t0)
        replicas_equal()
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ctx.close()
    del shards, models
    wall = sorted(walls)[len(walls) // 2]
    emit({"phase": "train_dp_tp", "model": "llama-3.1-8b", "n_layers": 2, "mesh": PAIR,
          "tokens_a_dp_group": m, "lr": DENSE_LR, "losses": losses, "step_wall_s": walls,
          "step_wall_s_median": wall, "train_tokens_per_s": dp * m / wall,
          "peak_mem_gb": peak, "replicas_bitwise_equal": True, **counts})
    _check_train("train_dp_tp", losses, counts["launches"], counts["plain_calls"],
                 ("ag_gemm", "gemm_rs"))
    return counts["launches"]


def phase_f32_parity_2d() -> None:
    """f32 at small width on the card, TF32 off: (1) hierarchical EP
    serving on ``{"dcn": 2, "tp": 2}`` (2 MoE layers, vocab 2048, hidden
    512, 8 experts, top-2, batch 4, 3 requests, paged, bulk prefill):
    greedy tokens identical to the flat EP serve at world 4 on the card and
    to the hierarchical plain path on the CPU; (2) one ``train_step(dp_axis
    ="dp")`` of a dense 2-layer model (hidden 512, 2 x 256 tokens a dp
    group) on ``{"dp": 2, "tp": 2}``: the loss and every rank's updated
    shard within 1e-4 relative L2 of the plain path (world 1 on the card,
    plain GEMMs, the mean of the two groups' losses differentiated by
    PyTorch)."""
    import torch
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.models.decode import ContinuousBatcher
    from triton_dist_tpu_torch.ops.gemm import _matmul_plain
    from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hier = ttm.EPMoETransformerConfig(vocab=2048, hidden=512, ffn=1024, n_layers=2,
                                      n_q_heads=8, n_kv_heads=4, head_dim=64, batch=4,
                                      seq=256, n_experts=8, topk=2, ep_outer="dcn",
                                      gg_config=GroupGemmConfig(MOE_BLOCK))
    params = ttm.init_moe_params(hier, seed=64)
    cpu = ttm._tree_map(lambda t: t.cpu(), params)
    lengths, max_new = [12, 33, 70], 4

    def serve(cfg, p, ctx, device):
        b = ContinuousBatcher(cfg, p, s_max=256, page_size=16, prefill=True, device=device,
                              ctx=ctx)
        for r in _requests(cfg.vocab, lengths, max_new, seed=65):
            b.submit(r)
        got = dict(b.run())
        ctx.close()
        return got

    t0 = time.perf_counter()
    want = serve(hier, cpu, initialize_distributed(mesh_shape=HIER_MESH, device="cpu"), "cpu")
    t1 = time.perf_counter()
    got = serve(hier, params, initialize_distributed(mesh_shape=HIER_MESH), "cuda")
    flat = serve(dataclasses.replace(hier, ep_outer=None), params,
                 initialize_distributed(WORLD), "cuda")
    if not got == want == flat:
        raise AssertionError(f"hierarchical EP greedy tokens differ: card {got}, CPU {want}, "
                             f"flat {flat}")
    del params, cpu

    class Plain(ttm.TPTransformer):
        def _col(self, x, w):
            return _matmul_plain(x, w, x.dtype)

        _row = _col

    cfg = ttm.TransformerConfig(vocab=2048, hidden=512, ffn=1024, n_layers=2, n_q_heads=8,
                                n_kv_heads=2, head_dim=64, batch=2, seq=256)
    params = ttm.init_params(cfg, seed=66)
    dp, tp, lr = PAIR["dp"], PAIR["tp"], 0.1
    m = cfg.batch * cfg.seq
    gen = torch.Generator(device="cuda").manual_seed(67)
    tokens = torch.randint(0, cfg.vocab, (dp * m,), generator=gen, device="cuda")
    targets = torch.randint(0, cfg.vocab, (dp * m,), generator=gen, device="cuda")
    with torch.enable_grad():
        work = ttm._tree_map(lambda p: p.detach().requires_grad_(), params)
        loss_ref = sum(Plain(cfg).loss(tokens[d * m:(d + 1) * m], targets[d * m:(d + 1) * m],
                                       work) for d in range(dp)) / dp
        g_ref = torch.autograd.grad(loss_ref, ttm._tree_leaves(work))
    new_ref = ttm._tree_map(lambda p, g: (p - lr * g).detach(), params,
                            _unflatten(params, g_ref))
    ctx = initialize_distributed(mesh_shape=PAIR)
    want_shards = ttm.shard_params(new_ref, cfg=cfg, ctx=ctx)
    shards = ttm.shard_params(params, cfg=cfg, ctx=ctx)
    m_loc = m // tp

    def rank():
        r, d = ctx.rank, ctx.axis_index("dp")
        new, loss = ttm.train_step(ttm.TPTransformer(cfg, ctx=ctx), shards[r],
                                   tokens[r * m_loc:(r + 1) * m_loc],
                                   targets[d * m:(d + 1) * m], lr=lr)
        return loss.item(), new

    worst = dict(loss_rel=0.0, param_rel_l2=0.0)
    for r, (loss, new) in enumerate(ctx.run(rank, grad=True)):
        worst["loss_rel"] = max(worst["loss_rel"],
                                abs(loss - loss_ref.item()) / abs(loss_ref.item()))
        for a, b in zip(ttm._tree_leaves(new), ttm._tree_leaves(want_shards[r])):
            worst["param_rel_l2"] = max(worst["param_rel_l2"], _rel_l2(a, b))
    ctx.close()
    if not (worst["loss_rel"] <= 1e-4 and worst["param_rel_l2"] <= 1e-4):
        raise AssertionError(f"f32 dp x tp parity: {worst}")
    emit({"phase": "f32_parity_2d", "hier_serve": {
        "mesh": HIER_MESH, "n_layers": 2, "requests": len(lengths), "max_new_tokens": max_new,
        "identical_to": ["flat EP serve at world 4 (card)", "hierarchical plain path (CPU)"],
        "cpu_reference_s": t1 - t0},
        "dp_tp_step": {"mesh": PAIR, "n_layers": 2, "tokens_a_dp_group": m, "worst": worst,
                       "reference": "world 1 on the card, plain GEMMs, mean of the dp "
                                    "groups' losses, PyTorch autograd",
                       "tol": {"loss_rel": 1e-4, "param_rel_l2": 1e-4}}})


# ------------------------------------------- quantized KV caches (K38-K40) ----

KV_FORMATS = ("int8", "fp8")
QUANT_LENS = (0, 1, 17, 300, 513, 777, 1000, 1024)      # K2's lengths
QUANT_PAGED_LENS = (1024, 0, 16, 17, 255, 600, 999, 1)  # K3's


def _kv_quantize(fmt, k, v):
    from triton_dist_tpu_torch.ops import flash_decode as fd

    return (fd.quantize_kv if fmt == "int8" else fd.quantize_kv_fp8)(k, v)


def _dequant_bf16(xq, scale):
    """The library yardstick's first half: a one-byte cache [.., s, d] back
    to bf16 with its row scales [.., 1, s]."""
    import torch

    return (xq.float() * scale.transpose(-1, -2)).to(torch.bfloat16)


def _quant_tol(ref) -> float:
    """One bf16 ulp of the output scale: the kernels round ``p * v_scale`` to
    bf16 at each 64-position tile's running max, the plain versions at the
    row's final max, so single terms may round apart."""
    import torch

    scale = ref[torch.isfinite(ref)].abs().max().item()
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _check_quant_kv(name, got, ref, empty) -> float:
    """out within one bf16 ulp of its scale, lse within 1e-4 of its scale
    (the same unrounded sums, in f32, in another order); rows with no cache
    exactly out 0, lse -inf. Returns the worse error over its tolerance."""
    import torch

    (o, l), (ro, rl) = got, ref
    live = ~empty
    err_o, err_l = (o - ro).abs().max().item(), (l[live] - rl[live]).abs().max().item()
    tol_o, tol_l = _quant_tol(ro), 1e-4 * rl[live].abs().max().item()
    if not (err_o <= tol_o and err_l <= tol_l):
        raise AssertionError(f"{name}: out err {err_o} (tol {tol_o}), lse err {err_l} "
                             f"(tol {tol_l})")
    if empty.any() and not ((o[empty] == 0).all().item()
                            and torch.isneginf(l[empty]).all().item()):
        raise AssertionError(f"{name}: kv_len == 0 must give out 0, lse -inf")
    return max(err_o / tol_o, err_l / tol_l)


def _quant_decode_bytes(lens, hq, h_kv, d) -> float:
    """The bytes a one-byte decode must move: q (bf16) read, each sequence's
    cache up to its length read once (d payload bytes and a 4-byte scale a
    position, k and v), out and lse written."""
    b = lens.shape[0]
    n = float(lens.sum().item())
    return 2.0 * b * hq * d + 2.0 * h_kv * n * (d + 4) + 4.0 * b + 4.0 * b * hq * (d + 1)


def _quant_entry(name, source, replaces, per_fmt, shapes, bf16_ms, bf16_name):
    entry = _format_entry(name, source, replaces, per_fmt, shapes,
                          "dequantize to bf16 + SDPA")
    entry["bf16_kernel"] = {"name": bf16_name, "ms": bf16_ms}
    return entry


def phase_flash_decode_quant() -> dict:
    """K38, int8 and fp8, at K2's served shapes (batch 8, 32 query / 8 kv
    heads, d 128, s_max 1024, lengths 0-1024), each against its plain
    version, timed beside its byte bound, the plain version, the library
    (dequantize to bf16, SDPA) and K2 on the bf16 cache; first the soft cap,
    g = 1, d = 96 and d = 24 (one-byte rows of 24 bytes: value-by-value
    loads) at smaller shapes; the card's quantizer equal to the CPU's."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    worst = 0.0
    for fmt in KV_FORMATS:
        for (bb, qh, kh, dd, ss, cap) in ((4, 8, 8, 96, 300, 0.0), (3, 8, 2, 128, 1000, 5.0),
                                          (2, 8, 2, 24, 130, 0.0)):
            l2 = torch.tensor([ss, 0, ss // 3, ss - 1][:bb], dtype=torch.int32, device="cuda")
            q2, k2, v2 = _decode_inputs(bb, qh, kh, dd, ss, torch.float32, seed=5)
            qz = _kv_quantize(fmt, k2, v2)
            cfg = fd.FlashDecodeConfig(soft_cap=cap)
            worst = max(worst, _check_quant_kv(
                f"flash_decode_quant {fmt} d={dd} g={qh // kh} cap={cap}",
                fd.flash_decode_quant(q2, *qz, l2, config=cfg, return_lse=True),
                fd._plain_decode_quant(q2, *qz, l2, return_lse=True, soft_cap=cap),
                (l2 == 0)[:, None].expand(bb, qh)))

    b, hq, h_kv, d, s = 8, 32, 8, 128, 1024
    lens = torch.tensor(QUANT_LENS, dtype=torch.int32, device="cuda")
    q, k, v = _decode_inputs(b, hq, h_kv, d, s, torch.float32, seed=2)
    qb, kb, vb = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    empty = (lens == 0)[:, None].expand(b, hq)
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    b_ms, by = bound(4.0 * hq * d * float(lens.sum().item()),
                     _quant_decode_bytes(lens, hq, h_kv, d))
    per_fmt, cpu_equal = {}, {}
    for fmt in KV_FORMATS:
        qz = _kv_quantize(fmt, kb, vb)
        cpu = _kv_quantize(fmt, kb.cpu(), vb.cpu())
        cpu_equal[fmt] = all(
            torch.equal(g.cpu().view(torch.uint8) if g.element_size() == 1 else g.cpu(),
                        c.view(torch.uint8) if c.element_size() == 1 else c)
            for g, c in zip(qz, cpu))
        if not cpu_equal[fmt]:
            raise AssertionError(f"quantize_kv {fmt}: the card's bytes or scales differ "
                                 f"from the CPU quantizer's")
        got = fd.flash_decode_quant(qb, *qz, lens, return_lse=True)
        ref = fd._plain_decode_quant(qb, *qz, lens, return_lse=True)
        err = _check_quant_kv(f"flash_decode_quant {fmt}", got, ref, empty)
        kq, vq, ks, vs = qz
        per_fmt[fmt] = dict(
            max_abs_err=(got[0] - ref[0]).abs().max().item(), err_over_tol=err,
            ms=cuda_ms(lambda: fd.flash_decode_quant(qb, *qz, lens, return_lse=True),
                       iters=50),
            plain_ms=cuda_ms(lambda: fd._plain_decode_quant(qb, *qz, lens, return_lse=True),
                             iters=10),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qb[:, :, None, :], _dequant_bf16(kq, ks), _dequant_bf16(vq, vs),
                attn_mask=mask, enable_gqa=True), iters=50),
            bound_ms=b_ms, bound_by=by)
    bf16_ms = cuda_ms(lambda: fd.flash_decode(qb, kb, vb, lens, return_lse=True), iters=50)
    emit({"phase": "kernel", "kernel": "flash_decode_quant", "small_worst_err_over_tol": worst,
          "card_quantizer_equals_cpu": cpu_equal, "bf16_k2_ms": bf16_ms, "formats": per_fmt})
    return _quant_entry(
        "flash_decode_quant", "triton_dist_tpu_torch/csrc/flash_decode.cu",
        "triton_dist_tpu/ops/flash_decode.py:1231", per_fmt,
        f"b={b} hq={hq} h_kv={h_kv} d={d} s_max={s} lens={list(QUANT_LENS)}; int8 and fp8 "
        f"e4m3 caches", bf16_ms, "flash_decode (K2, bf16 cache)")


def _page_layout(gen, lens, b, s, page):
    """A pool of `page`-token pages behind a shuffled block table with junk
    (in-range) entries past each length: ``(pool, table)``, where
    ``pool(x)`` lays a cache ``[b, h_kv, s, e]`` out as ``[b * s / page,
    h_kv, page, e]`` and ``pool(scales, scale=True)`` its row scales."""
    import torch

    pps = s // page
    perm = torch.randperm(b * pps, generator=gen, device="cuda")
    inv = torch.argsort(perm)

    def pool(x, scale=False):
        if scale:
            return pool(x.transpose(2, 3)).transpose(2, 3).contiguous()
        h_kv, e = x.shape[1], x.shape[-1]
        return x.reshape(b, h_kv, pps, page, e).transpose(1, 2).reshape(
            b * pps, h_kv, page, e)[inv].contiguous()

    junk = torch.randint(0, b * pps, (b, pps), generator=gen, device="cuda")
    used = torch.arange(pps, device="cuda")[None, :] < ((lens + page - 1) // page)[:, None]
    table = torch.where(used, perm.reshape(b, pps), junk).to(torch.int32).contiguous()
    return pool, table


def _quant_pool(pool, kq, vq, ks, vs):
    return pool(kq), pool(vq), pool(ks, scale=True), pool(vs, scale=True)


def phase_paged_flash_decode_quant() -> dict:
    """K39, int8 and fp8, at K3's served shapes: 16-token pages, a shuffled
    block table, junk entries past each length; against its plain version
    (and the pool read through its table equal to the contiguous plain
    version), timed beside the byte bound (pages below each length), the
    plain version, the library (gather + dequantize + SDPA) and K3."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s, page = 8, 32, 8, 128, 1024, 16
    lens = torch.tensor(QUANT_PAGED_LENS, dtype=torch.int32, device="cuda")
    q, k, v = _decode_inputs(b, hq, h_kv, d, s, torch.bfloat16, seed=4)
    empty = (lens == 0)[:, None].expand(b, hq)
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    b_ms, by = bound(4.0 * hq * d * float(lens.sum().item()),
                     _quant_decode_bytes(lens, hq, h_kv, d))
    pool, table = _page_layout(torch.Generator(device="cuda").manual_seed(44), lens, b, s,
                               page)
    per_fmt = {}
    for fmt in KV_FORMATS:
        qz = _kv_quantize(fmt, k, v)
        kp, vp, ksp, vsp = _quant_pool(pool, *qz)
        got = fd.paged_flash_decode(q, kp, vp, lens, table, k_scales=ksp, v_scales=vsp,
                                    return_lse=True)
        ref = fd._plain_paged_decode_quant(q, kp, vp, ksp, vsp, lens, table, return_lse=True)
        if not torch.equal(ref[0], fd._plain_decode_quant(q, *qz, lens, return_lse=True)[0]):
            raise AssertionError("paged quant pool through its table != contiguous cache")
        err = _check_quant_kv(f"paged_flash_decode_quant {fmt}", got, ref, empty)

        def library():
            kc, vc = fd._paged_to_contiguous(kp, table), fd._paged_to_contiguous(vp, table)
            ksc = fd._paged_scales_to_contiguous(ksp, table)
            vsc = fd._paged_scales_to_contiguous(vsp, table)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], _dequant_bf16(kc, ksc), _dequant_bf16(vc, vsc),
                attn_mask=mask, enable_gqa=True)

        per_fmt[fmt] = dict(
            max_abs_err=(got[0] - ref[0]).abs().max().item(), err_over_tol=err,
            ms=cuda_ms(lambda: fd.paged_flash_decode(q, kp, vp, lens, table, k_scales=ksp,
                                                     v_scales=vsp, return_lse=True), iters=50),
            plain_ms=cuda_ms(lambda: fd._plain_paged_decode_quant(
                q, kp, vp, ksp, vsp, lens, table, return_lse=True), iters=10),
            library_ms=cuda_ms(library, iters=20), bound_ms=b_ms, bound_by=by)
    kp, vp = pool(k), pool(v)
    bf16_ms = cuda_ms(lambda: fd.paged_flash_decode(q, kp, vp, lens, table, return_lse=True),
                      iters=50)
    emit({"phase": "kernel", "kernel": "paged_flash_decode_quant", "bf16_k3_ms": bf16_ms,
          "formats": per_fmt})
    return _quant_entry(
        "paged_flash_decode_quant", "triton_dist_tpu_torch/csrc/flash_decode.cu",
        "triton_dist_tpu/ops/flash_decode.py:1414", per_fmt,
        f"b={b} hq={hq} h_kv={h_kv} d={d} page={page} pages/seq={s // page} shuffled, junk "
        f"past each length, lens={list(QUANT_PAGED_LENS)}; int8 and fp8 e4m3 pools",
        bf16_ms, "paged_flash_decode (K3, bf16 pool)")


def _quant_verify_bound(lens, S, hq, h_kv, d) -> tuple[float, str]:
    """K40's least time: 4 FLOPs a (row, head, cached position, column) at
    the bf16 tensor-core peak (the products run in bf16) against q (bf16)
    read, each sequence's cache up to its longest row read once in one byte
    plus a 4-byte scale a position, out and lse written."""
    b = lens.shape[0]
    flops = 4.0 * hq * d * float(lens.sum().item())
    max_len = float(lens.max(dim=1).values.sum().item())
    nbytes = (2.0 * b * S * hq * d + 2.0 * h_kv * max_len * (d + 4)
              + 4.0 * b * S * hq * (d + 1) + 4.0 * b * S)
    return bound(flops, nbytes)


def phase_flash_verify_quant() -> dict:
    """K40, int8 and fp8, at K13's served shapes (8B widths, batch 8, a
    2048-position cache, S 256 and 8, parked-full, ragged and empty rows),
    plus a soft-cap and a d = 96 case; each against its plain version; the
    fp8 ranged-prefill chunk calls bit-equal to the whole-range call;
    timed at S 256 beside its bound, the plain version, the library
    (dequantize + SDPA) and K13 on the bf16 cache."""
    import torch
    import torch.nn.functional as F
    from triton_dist_tpu_torch.ops import flash_decode as fd

    worst = 0.0
    for fmt in KV_FORMATS:
        for S, cap, d in ((256, 0.0, None), (8, 0.0, None), (64, 30.0, None), (37, 5.0, 96)):
            q, k, v, lens = _verify_inputs(S, torch.float32, seed=51 + S, d=d)
            qz = _kv_quantize(fmt, k, v)
            cfg = fd.FlashDecodeConfig(soft_cap=cap)
            empty = (lens == 0)[..., None].expand(*lens.shape, q.shape[2])
            worst = max(worst, _check_quant_kv(
                f"flash_verify_quant {fmt} S={S} cap={cap} d={q.shape[-1]}",
                fd.flash_verify(q, qz[0], qz[1], lens, config=cfg, return_lse=True,
                                scales=qz[2:]),
                fd._plain_verify_quant(q, *qz, lens, return_lse=True, soft_cap=cap), empty))
    # the fp8 ranged prefill: chunk calls bit-equal to the whole-range call
    b, S, hq, h_kv, d, s = 4, 256, 32, 8, 128, 2048
    gen = torch.Generator(device="cuda").manual_seed(53)
    qr = torch.randn((b, S, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    qz = fd.quantize_kv_fp8(torch.randn((b, h_kv, s, d), generator=gen, device="cuda"),
                            torch.randn((b, h_kv, s, d), generator=gen, device="cuda"))
    pos0 = torch.tensor([0, 300, 1792, s], device="cuda")
    whole = fd.flash_verify_fp8(qr, *qz, fd._ranged_local_lens(pos0, S, 0, s), return_lse=True)
    for lo, hi in ((0, 1), (1, 100), (100, 256)):
        part = fd.flash_verify_fp8(qr[:, lo:hi].contiguous(), *qz,
                                   fd._ranged_local_lens(pos0 + lo, hi - lo, 0, s),
                                   return_lse=True)
        if not (torch.equal(part[0], whole[0][:, lo:hi])
                and torch.equal(part[1], whole[1][:, lo:hi])):
            raise AssertionError(f"flash_verify_fp8: chunk [{lo}, {hi}) differs from the "
                                 f"whole-range call")

    S = 256
    q, k, v, lens = _verify_inputs(S, torch.bfloat16, seed=11 + S)
    sh = VERIFY_SHAPE
    b_ms, by = _quant_verify_bound(lens, S, sh["hq"], sh["h_kv"], sh["d"])
    empty = (lens == 0)[..., None].expand(*lens.shape, sh["hq"])
    mask = (torch.arange(sh["s"], device="cuda")[None, None, :] < lens[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    per_fmt = {}
    for fmt in KV_FORMATS:
        kq, vq, ks, vs = _kv_quantize(fmt, k, v)
        got = fd.flash_verify(q, kq, vq, lens, return_lse=True, scales=(ks, vs))
        ref = fd._plain_verify_quant(q, kq, vq, ks, vs, lens, return_lse=True)
        err = _check_quant_kv(f"flash_verify_quant {fmt} served", got, ref, empty)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, _dequant_bf16(kq, ks), _dequant_bf16(vq, vs), attn_mask=mask, enable_gqa=True)
        per_fmt[fmt] = dict(
            max_abs_err=(got[0] - ref[0]).abs().max().item(), err_over_tol=err,
            ms=cuda_ms(lambda: fd.flash_verify(q, kq, vq, lens, return_lse=True,
                                               scales=(ks, vs)), iters=10),
            plain_ms=cuda_ms(lambda: fd._plain_verify_quant(q, kq, vq, ks, vs, lens,
                                                            return_lse=True),
                             iters=3, warmup=1),
            library_ms=cuda_ms(lib, iters=10), bound_ms=b_ms, bound_by=by)
    bf16_ms = cuda_ms(lambda: fd.flash_verify(q, k, v, lens, return_lse=True), iters=10)
    emit({"phase": "kernel", "kernel": "flash_verify_quant", "worst_err_over_tol": worst,
          "fp8_chunks_bit_equal": True, "bf16_k13_ms": bf16_ms, "formats": per_fmt})
    return _quant_entry(
        "flash_verify_quant", "triton_dist_tpu_torch/csrc/flash_verify.cu",
        "triton_dist_tpu/ops/flash_decode.py:628", per_fmt,
        f"b=8 S={S} hq=32 h_kv=8 d=128 s=2048, 6 of 8 sequences parked (full cache); int8 "
        f"and fp8 e4m3 caches", bf16_ms, "flash_verify (K13, bf16 cache)")


QUANT_SP_LENS = (0, 1, 1500, 4096, 3000, 17, 2048, 4095)   # global, over 4 x 1024


def phase_quant_kv_path(counters: Counters, ctx) -> dict:
    """The slice's main path, one counted run: the op-level entries a user
    calls at the served 8B widths — world 1: ``flash_decode_quant``,
    ``flash_decode_fp8``, ``paged_flash_decode_quant``/``_fp8``,
    ``flash_verify(scales=)`` (int8) and ``flash_verify_fp8`` (S 256, and S 8
    as a speculative verify); world 4 on the one card: the int8 and fp8 SP
    decode over a 4096-position cache sharded 4 x 1024 (full-mesh push, and
    the bidirectional ring gather), the fp8 ranged prefill (S 256 straddling
    shards) and ``flash_decode_op`` (bf16). Then each output against the
    world-1 plain path over the whole cache, and the SP entries timed (the
    slowest rank)."""
    import torch
    from triton_dist_tpu_torch.ops import flash_decode as fd

    b, hq, h_kv, d, s, page = 8, 32, 8, 128, 1024, 16
    q, k, v = _decode_inputs(b, hq, h_kv, d, s, torch.bfloat16, seed=61)
    lens = torch.tensor(QUANT_LENS, dtype=torch.int32, device="cuda")
    caches = {fmt: _kv_quantize(fmt, k, v) for fmt in KV_FORMATS}
    pool, table = _page_layout(torch.Generator(device="cuda").manual_seed(62), lens, b, s,
                               page)
    pools = {fmt: _quant_pool(pool, *caches[fmt]) for fmt in KV_FORMATS}
    vrq, vk, vv, vlens = _verify_inputs(256, torch.bfloat16, seed=63)
    vcaches = {fmt: _kv_quantize(fmt, vk, vv) for fmt in KV_FORMATS}
    sq, sl_lens = vrq[:, :8].contiguous(), vlens[:, :8].contiguous()
    n, s_g = ctx.world, 4 * 1024
    s_loc = s_g // n
    sp_q, sp_k, sp_v = _decode_inputs(b, hq, h_kv, d, s_g, torch.bfloat16, seed=64)
    sp_lens = torch.tensor(QUANT_SP_LENS, dtype=torch.int32, device="cuda")
    sp_caches = {fmt: _kv_quantize(fmt, sp_k, sp_v) for fmt in KV_FORMATS}
    shard = lambda x, r: x[..., r * s_loc:(r + 1) * s_loc, :].contiguous()  # noqa: E731
    shard_s = lambda x, r: x[..., r * s_loc:(r + 1) * s_loc].contiguous()  # noqa: E731
    sp_shards = {fmt: [(shard(kq, r), shard(vq, r), shard_s(ks, r), shard_s(vs, r))
                       for r in range(n)] for fmt, (kq, vq, ks, vs) in sp_caches.items()}
    rq = torch.randn((b, 256, hq, d), generator=torch.Generator(device="cuda").manual_seed(65),
                     device="cuda").to(torch.bfloat16)
    pos0 = torch.tensor([0, 900, 2000, s_g - 256, 3000, 1, 1023, 4096 - 300], device="cuda")
    entries = {"int8": fd.flash_decode_quant_distributed, "fp8": fd.flash_decode_fp8_distributed}

    def sp_decode(fmt, method):
        r = ctx.rank
        local = torch.clamp(sp_lens - r * s_loc, 0, s_loc).to(torch.int32)
        return entries[fmt](sp_q, *sp_shards[fmt][r], local, ctx=ctx, ag_method=method)

    def sp_ranged():
        return fd.flash_ranged_prefill_fp8_distributed(rq, *sp_shards["fp8"][ctx.rank], pos0,
                                                       ctx=ctx)

    torch.cuda.synchronize()
    counters.reset()
    out = {}
    for fmt in KV_FORMATS:
        kq, vq, ks, vs = caches[fmt]
        dec = fd.flash_decode_quant if fmt == "int8" else fd.flash_decode_fp8
        out[f"decode_{fmt}"] = dec(q, kq, vq, ks, vs, lens)
        pdec = fd.paged_flash_decode_quant if fmt == "int8" else fd.paged_flash_decode_fp8
        out[f"paged_{fmt}"] = pdec(q, *pools[fmt], lens, table)
        vkq, vvq, vks, vvs = vcaches[fmt]
        if fmt == "int8":
            out[f"verify_{fmt}"] = fd.flash_verify(vrq, vkq, vvq, vlens, scales=(vks, vvs))
            out[f"spec_{fmt}"] = fd.flash_verify(sq, vkq, vvq, sl_lens, scales=(vks, vvs))
        else:
            out[f"verify_{fmt}"] = fd.flash_verify_fp8(vrq, vkq, vvq, vks, vvs, vlens)
            out[f"spec_{fmt}"] = fd.flash_verify_fp8(sq, vkq, vvq, vks, vvs, sl_lens)
        for method in ("full_mesh_push", "ring_bidir"):
            out[f"sp_{fmt}_{method}"] = ctx.run(lambda: sp_decode(fmt, method))
    out["sp_ranged_fp8"] = ctx.run(sp_ranged)
    out["op_bf16"] = fd.flash_decode_op(sp_q, sp_k, sp_v, sp_lens, ctx=ctx)
    torch.cuda.synchronize()
    counts = counters.read()

    errs = {}

    def check(name, got, ref, factor=1.0):
        for g in (got if isinstance(got, list) else [got]):
            if not torch.isfinite(g).all().item():
                raise AssertionError(f"quant_kv_path {name}: non-finite output")
            err = (g - ref).abs().max().item()
            tol = factor * _quant_tol(ref)
            if not err <= tol:
                raise AssertionError(f"quant_kv_path {name}: err {err} > {tol}")
            errs[name] = max(errs.get(name, 0.0), err / tol)

    for fmt in KV_FORMATS:
        ref = fd._plain_decode_quant(q, *caches[fmt], lens, return_lse=False)
        check(f"decode_{fmt}", out[f"decode_{fmt}"], ref)
        check(f"paged_{fmt}", out[f"paged_{fmt}"], ref)
        check(f"verify_{fmt}", out[f"verify_{fmt}"],
              fd._plain_verify_quant(vrq, *vcaches[fmt], vlens, return_lse=False))
        check(f"spec_{fmt}", out[f"spec_{fmt}"],
              fd._plain_verify_quant(sq, *vcaches[fmt], sl_lens, return_lse=False))
        sp_ref = fd._plain_decode_quant(sp_q, *sp_caches[fmt], sp_lens, return_lse=False)
        for method in ("full_mesh_push", "ring_bidir"):
            # each rank's partial rounds at its own tiles, then the f32 merge
            check(f"sp_{fmt}_{method}", out[f"sp_{fmt}_{method}"], sp_ref, factor=2.0)
    ranged_ref = fd._plain_verify_quant(rq, *sp_caches["fp8"],
                                        fd._ranged_local_lens(pos0, 256, 0, s_g),
                                        return_lse=False)
    check("sp_ranged_fp8", out["sp_ranged_fp8"], ranged_ref, factor=2.0)
    op_ref = fd._xla_decode(sp_q, sp_k, sp_v, sp_lens, return_lse=False)
    op_err = (out["op_bf16"] - op_ref).abs().max().item()
    if not op_err <= DECODE_TOL:
        raise AssertionError(f"flash_decode_op: err {op_err} > {DECODE_TOL}")

    sp_ms = {f"sp_{fmt}_{method}": dist_ms(ctx, lambda: sp_decode(fmt, method), iters=20)
             for fmt in KV_FORMATS for method in ("full_mesh_push", "ring_bidir")}
    sp_ms["sp_ranged_fp8"] = dist_ms(ctx, sp_ranged, iters=10)
    sp_ms["sp_bf16_full_mesh_push"] = dist_ms(ctx, lambda: fd.flash_decode_distributed(
        sp_q, shard(sp_k, ctx.rank), shard(sp_v, ctx.rank),
        torch.clamp(sp_lens - ctx.rank * s_loc, 0, s_loc).to(torch.int32), ctx=ctx), iters=20)
    launches = counts["launches"]
    for key in ("flash_decode_quant", "paged_flash_decode_quant", "flash_verify_quant"):
        if launches[key] <= 0:
            raise AssertionError(f"quant_kv_path: {key} was not launched")
    for key in ("decode_quant", "verify_quant"):
        if counts["plain_calls"][key]:
            raise AssertionError(f"quant_kv_path: the plain {key} ran on the card path")
    emit({"phase": "quant_kv_path", "launches": {k_: launches[k_] for k_ in (
              "flash_decode_quant", "paged_flash_decode_quant", "flash_verify_quant",
              "flash_decode", "all_gather", "all_gather_ring_bidir")},
          "plain_calls": {k_: counts["plain_calls"][k_] for k_ in ("decode_quant",
                                                                  "verify_quant", "decode")},
          "err_over_tol": errs, "flash_decode_op_err": op_err, "sp_ms": sp_ms,
          "shapes": f"world 1: b={b} hq={hq} h_kv={h_kv} d={d} s={s}, verify S 256 / 8 over "
                    f"2048; world {n}: s {s_g} as {n} x {s_loc}, lens={list(QUANT_SP_LENS)}"})
    return launches


# ----------------------------------------- the KV stream, training on 2-D ----

KV_M, KV_W = 65536, 1024  # one Llama-3.1-8B prompt's KV: 32 layers x (K, V) x 1024 positions, 8 x 128
KV_WIRES = ("native", "int8", "fp8")
KV_CHUNKS = (1, 2, 4)


def _kv_parts(world, wire, seed):
    """Every rank's bf16 slab [KV_M, KV_W] (rows over six decades) in the
    wire's form: ``(payload, scales or None)``."""
    import torch
    from triton_dist_tpu_torch.ops import kv_stream as kvs

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(world):
        x = (torch.randn((KV_M, KV_W), generator=g, device="cuda")
             * torch.logspace(-3, 3, KV_M, device="cuda")[:, None]).to(torch.bfloat16)
        out.append((x, None) if wire == "native" else kvs.quantize_kv_wire_for(wire, x))
    return out


def _same_bytes(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def phase_kv_stream() -> list[dict]:
    """K41 (native wire) and K42 (int8 and fp8) at full width: every rank's
    [65536, 1024] slab (the KV of one Llama-3.1-8B prompt, 128 MiB bf16;
    64 MiB + 256 KiB of scales on the one-byte wires) exchanged with its
    mirror at world 2 and 4 on the one card, chunks 1, 2 and 4; every cell
    bit-exact against the plain exchange (a copy), then timed beside the
    plain version, the bound (every rank's slab and scales read once and
    written once at the HBM rate) and the library yardstick:
    ``Tensor.copy_`` of the mirror's payload (and, on the one-byte wires,
    its scales) on every rank, the same bytes the kernel moves; on the
    one-byte wires the round trip a bf16 slab would take without the wire
    format (quantize, copy, dequantize) is reported beside it, not as the
    yardstick."""
    import torch
    from triton_dist_tpu_torch.ops import kv_stream as kvs
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    cells = {}
    for world in (2, 4):
        ctx = initialize_distributed(world)
        for wire in KV_WIRES:
            parts = _kv_parts(world, wire, seed=100 + world)
            plain = ctx.run(lambda: kvs._kv_stream_xla(*parts[ctx.rank], ctx=ctx))
            nbytes = 2.0 * world * sum(t.numel() * t.element_size()
                                       for t in parts[0] if t is not None)
            b_ms, by = bound(0.0, nbytes)
            ms = {}
            for chunks in KV_CHUNKS:
                cfg = kvs.KVStreamConfig(chunks_per_shard=chunks, wire=wire)

                def call(cfg=cfg):
                    return kvs.kv_stream(*parts[ctx.rank], ctx=ctx, config=cfg)

                for r, got in enumerate(ctx.run(call)):
                    want = plain[r]
                    ok = (_same_bytes(got, want) if wire == "native" else
                          _same_bytes(got[0], want[0]) and _same_bytes(got[1], want[1]))
                    mirror = parts[kvs.mirror_peer(r, world)][0]
                    if not ok or not _same_bytes(got if wire == "native" else got[0], mirror):
                        raise AssertionError(f"kv_stream {wire} world {world} chunks {chunks}: "
                                             f"rank {r} not bit-exact")
                del got
                ms[chunks] = dist_ms(ctx, call, iters=10)
            plain_ms = dist_ms(ctx, lambda: kvs._kv_stream_xla(*parts[ctx.rank], ctx=ctx),
                               iters=3)
            mirrors = [t for r in range(world) for t in parts[kvs.mirror_peer(r, world)]
                       if t is not None]
            outs = [torch.empty_like(t) for t in mirrors]
            library_ms = cuda_ms(lambda: [o.copy_(m) for o, m in zip(outs, mirrors)], iters=10)
            extra = {}
            if wire != "native":
                slabs = [kvs.dequantize_kv_wire(*p, torch.bfloat16) for p in parts]

                def roundtrip():
                    for r in range(world):
                        q, s = kvs.quantize_kv_wire_for(wire, slabs[kvs.mirror_peer(r, world)])
                        kvs.dequantize_kv_wire(q, s, torch.bfloat16)

                extra["roundtrip_ms"] = cuda_ms(
                    lambda: ([o.copy_(m) for o, m in zip(outs, mirrors)], roundtrip()), iters=5)
                del slabs
            cells[f"{wire} world {world}"] = dict(
                ms_by_chunks=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=library_ms, **extra, bytes_a_rank=nbytes / (2 * world))
            del parts, plain, outs, mirrors
            torch.cuda.empty_cache()
        ctx.close()
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "kv_stream", "shape": f"[{KV_M}, {KV_W}] a rank",
          "bit_exact": "every wire, world 2 and 4, chunks 1, 2, 4", "cells": cells})

    def entry(name, replaces, wire, library):
        head = cells[f"{wire} world 4"]
        return dict(name=name, route="cuda", source="triton_dist_tpu_torch/csrc/kv_stream.cu",
                    replaces=replaces, max_abs_err=0.0, ms=head["ms_by_chunks"][1],
                    plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                    bound_by=head["bound_by"], library_ms=head["library_ms"], library=library,
                    shapes=f"world 4 on one card, [{KV_M}, {KV_W}] a rank, one chunk",
                    cells={k: v for k, v in cells.items() if k.startswith(wire)
                           or wire == "int8" and k.startswith("fp8")})

    k41 = entry("kv_stream", "triton_dist_tpu/ops/kv_stream.py:172", "native",
                "Tensor.copy_ of the mirror's slab, every rank")
    k42 = entry("kv_stream_w8", "triton_dist_tpu/ops/kv_stream.py:204", "int8",
                "Tensor.copy_ of the mirror's payload and scales, every rank")
    heads = {w: cells[f"{w} world 4"] for w in ("int8", "fp8")}
    k42["formats"] = {w: dict(ms=c["ms_by_chunks"][1], library_ms=c["library_ms"],
                              roundtrip_ms=c["roundtrip_ms"]) for w, c in heads.items()}
    return [k41, k42]


def phase_kv_stream_path(counters: Counters) -> dict:
    """``kv_stream_path``: the counted run of the host-level entry
    ``kv_stream_op`` at full width, world 4 on the one card, two chunks a
    slab: a global [4 x 65536, 1024] bf16 tensor on each wire. The native
    output is the input with each rank's rows swapped with its mirror's
    (bit-exact); the one-byte wires equal the plain round trip of the
    mirror's rows (quantize, dequantize) computed on the card, and stay
    within the wire's rounding of the input. K41 and K42 launched, no
    plain exchange; the host wall of a call."""
    import torch
    from triton_dist_tpu_torch.ops import kv_stream as kvs
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    g = torch.Generator(device="cuda").manual_seed(110)
    x = (torch.randn((WORLD * KV_M, KV_W), generator=g, device="cuda")
         * torch.logspace(-3, 3, WORLD * KV_M, device="cuda")[:, None]).to(torch.bfloat16)
    swapped = torch.cat([x[kvs.mirror_peer(r, WORLD) * KV_M:][:KV_M] for r in range(WORLD)])
    ctx = initialize_distributed(WORLD)
    runs = {}
    counters.reset()
    for wire in KV_WIRES:
        cfg = kvs.KVStreamConfig(chunks_per_shard=2, wire=wire)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = kvs.kv_stream_op(x, ctx=ctx, config=cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if wire == "native":
            want = swapped
        else:
            want = kvs.dequantize_kv_wire(*kvs.quantize_kv_wire_for(wire, swapped),
                                          torch.bfloat16)
        if not _same_bytes(got, want):
            raise AssertionError(f"kv_stream_op {wire}: not the mirror's (round-tripped) rows")
        rel = (got.float() - swapped.float()).norm() / swapped.float().norm()
        runs[wire] = {"wall_ms": wall, "rel_l2_to_input_rows": rel.item()}
        del got, want
    counts = counters.read()
    ctx.close()
    launches = counts["launches"]
    if (launches["kv_stream"] != WORLD or launches["kv_stream_w8"] != 2 * WORLD
            or launches["kv_stream_fp8"] != WORLD or any(counts["plain_calls"].values())):
        raise AssertionError(f"kv_stream_path: launches {launches}, plain {counts['plain_calls']}")
    emit({"phase": "kv_stream_path", "world": WORLD, "shape": f"[{WORLD * KV_M}, {KV_W}] bf16",
          "chunks_per_shard": 2, "runs": runs, **counts})
    del x, swapped
    return launches


def phase_stuck_wait_kv_stream() -> None:
    """K41 and K42 (4 chunks) at world 2 with rank 1's stream held 2 s
    before its push (wait timeout 0.2 s): rank 0's collect must raise with
    the record of its wait for the mirror's payload chunk 0 (site 2 + 0),
    in the wire's family, not hang."""
    import torch
    from triton_dist_tpu_torch import config
    from triton_dist_tpu_torch.ops import common
    from triton_dist_tpu_torch.ops import kv_stream as kvs
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed
    from triton_dist_tpu_torch.resilience.records import DistTimeoutError

    x = torch.randn((512, 256), device="cuda").to(torch.bfloat16)
    recs = {}
    for wire, family in (("native", "kv_stream"), ("int8", "kv_stream_w8")):
        ctx = initialize_distributed(2)
        cfg = kvs.KVStreamConfig(chunks_per_shard=4, wire=wire)
        args = (x, None) if wire == "native" else kvs.quantize_kv_wire(x)
        stuck = False

        def call():
            if ctx.rank == 1 and stuck:
                common.sleep_on_stream(2_000_000_000)
            return kvs.kv_stream(*args, ctx=ctx, config=cfg)

        ctx.run(call)
        stuck = True
        try:
            with config.wait_timeout(0.2):
                ctx.run(call)
        except DistTimeoutError as err:
            recs[family] = err.records
        else:
            raise AssertionError(f"a stuck {family} wait did not raise")
        if [(r["pe"], r["family"], r["site"]) for r in recs[family]] != [(0, family, 2)]:
            raise AssertionError(f"stuck {family} wait: unexpected records {recs[family]}")
        ctx.close()
    emit({"phase": "stuck_wait_kv_stream", "records": recs})


ADAM_LR = 1e-4
F32_TRAIN = dict(vocab=2048, hidden=512, ffn=1024, n_layers=1, n_q_heads=8, n_kv_heads=4,
                 head_dim=64, batch=2, seq=256)


def _f32_train_vs_cpu(name, cfg, mesh, dp_axis=None, opt=None, steps=1, seed=70) -> dict:
    """`steps` f32 train steps of `cfg` on the card (TF32 off) against the
    same steps on the CPU (the plain versions, the ranks as threads): every
    rank's gradients at the first step (``_loss_and_grads``, what the step
    applies) within 1e-4 relative L2 a leaf, the loss within 1e-5 relative,
    every rank's parameters (and optimizer state) after the steps within
    1e-4 relative L2. The gradients carry the check where one step moves a
    leaf by less than 1e-4 of its norm: each leaf's step ``|p' - p| / |p|``
    on the CPU is reported beside it. `mesh` None is world 1. The tokens
    are each dp group's 2 x 256."""
    import numpy as np
    import torch
    from triton_dist_tpu_torch import optim
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    moe = isinstance(cfg, ttm.MoETransformerConfig)
    init = ttm.init_moe_params if moe else ttm.init_params
    params = init(cfg, seed=seed, device="cpu")
    n_dp = 1 if dp_axis is None else mesh[dp_axis]
    m = cfg.batch * cfg.seq
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, n_dp * m))
    targets = torch.from_numpy(rng.integers(0, cfg.vocab, n_dp * m))
    cls = (ttm.EPMoETransformer if isinstance(cfg, ttm.EPMoETransformerConfig)
           else ttm.TPMoETransformer if moe else ttm.TPTransformer)
    to_cpu = lambda tree: optim.tree_map(  # noqa: E731
        lambda x: None if x is None else x.detach().cpu(), tree)

    def run(device):
        t0 = time.perf_counter()
        p = ttm._tree_map(lambda x: x.to(device), params)
        tok, tgt = tokens.to(device), targets.to(device)
        if mesh is None:
            model = cls(cfg)
            firsts = [p]
            grads = [to_cpu(ttm._loss_and_grads(model, p, tok[:m], tgt[:m])[1])]
            state = None if opt is None else opt.init(p)
            losses = []
            for _ in range(steps):
                out = ttm.train_step(model, p, tok[:m], tgt[:m], lr=DENSE_LR, dp_axis=None,
                                     opt=opt, opt_state=state)
                p, state, loss = out if opt is not None else (out[0], None, out[1])
                losses.append(loss.item())
            outs = [(p, state)]
        else:
            ctx = initialize_distributed(mesh_shape=mesh, device=device)
            shards = firsts = ttm.shard_params(p, cfg=cfg, ctx=ctx)
            states = [None if opt is None else opt.init(s) for s in shards]
            m_loc = m // ctx.axis_size(cfg.axis)

            def rows(r):
                d = 0 if dp_axis is None else ctx.axis_index(dp_axis)
                return tok[r * m_loc:(r + 1) * m_loc], tgt[d * m:(d + 1) * m]

            def grad_body():
                dp = None if dp_axis is None else ctx.group(dp_axis)
                r = ctx.rank
                return to_cpu(ttm._loss_and_grads(cls(cfg, ctx=ctx), shards[r], *rows(r), dp)[1])

            grads = ctx.run(grad_body, grad=True)
            losses = []
            for _ in range(steps):
                def body():
                    r = ctx.rank
                    out = ttm.train_step(cls(cfg, ctx=ctx), shards[r], *rows(r), lr=DENSE_LR,
                                         dp_axis=dp_axis, opt=opt, opt_state=states[r])
                    return out if opt is not None else (out[0], None, out[1])

                res = ctx.run(body, grad=True)
                shards, states = [o[0] for o in res], [o[1] for o in res]
                losses.append(res[0][2].item())
            ctx.close()
            outs = list(zip(shards, states))
        moved = [_rel_l2(b, a) for first, (last, _) in zip(firsts, outs)
                 for a, b in zip(_leaves(first), _leaves(last)) if ttm._trainable(a)]
        return losses, [to_cpu(o) for o in outs], grads, moved, time.perf_counter() - t0

    want_losses, want, want_grads, moved, cpu_s = run("cpu")
    got_losses, got, got_grads, _, card_s = run("cuda")
    worst_grad = max(_rel_l2(x, y) for a, b in zip(got_grads, want_grads) for x, y in zip(a, b))
    worst = 0.0
    for a, b in zip(got, want):
        for x, y in zip(_leaves(a), _leaves(b)):
            worst = max(worst, _rel_l2(x, y))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    if not (worst_grad <= 1e-4 and loss_rel <= 1e-5 and worst <= 1e-4):
        raise AssertionError(f"{name}: f32 steps off the CPU plain path: gradients rel L2 "
                             f"{worst_grad}, loss rel {loss_rel}, worst rel L2 {worst}")
    return dict(steps=steps, losses=got_losses, worst_grad_rel_l2=worst_grad,
                loss_rel_err=loss_rel, worst_param_state_rel_l2=worst, tol_grad_rel_l2=1e-4,
                tol_loss_rel=1e-5, tol_rel_l2=1e-4, step_rel_min=min(moved),
                step_rel_median=sorted(moved)[len(moved) // 2], cpu_reference_s=cpu_s,
                card_s=card_s)


def _leaves(tree) -> list:
    from triton_dist_tpu_torch import optim

    out = []
    optim.tree_map(lambda x: out.append(x) if x is not None else None, tree)
    return out


def _train_counted(name, ctx, step, counters, steps=3) -> dict:
    """A warm-up step then `steps` counted ones of `step` (a rank body
    returning its loss) on `ctx`: losses, step walls, peak GB, counts."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [ctx.run(step, grad=True)[0]], []
    counters.reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(ctx.run(step, grad=True)[0])
        walls.append(time.perf_counter() - t0)
    counts = counters.read()
    wall = sorted(walls)[len(walls) // 2]
    return dict(phase=name, losses=losses, step_wall_s=walls, step_wall_s_median=wall,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **counts)


def _train_moe_ep(name, counters, model_name, mesh, dp_axis) -> dict:
    """An EP model at ``train_moe_tp4``'s depth (8 layers) and tokens (2 x
    1024 a dp group), bf16, seeded weights, SGD at TRAIN_LR on `mesh`: a
    warm-up and 3 steps (losses finite and falling), the router moved by
    the first step, K27 and the grouped GEMMs (K8 forward and dA, K11 dW)
    launched, no plain transport; then the f32 small-width step against
    the CPU plain path."""
    import torch
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    cfg = presets.preset(model_name, n_layers=8, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16)
    n_dp = 1 if dp_axis is None else mesh[dp_axis]
    m = TRAIN_B * TRAIN_S
    batches = [_train_batch(cfg.vocab, seed=80 + d) for d in range(n_dp)]
    tokens = torch.cat([t for t, _ in batches])
    targets = torch.cat([y for _, y in batches])
    ctx = initialize_distributed(mesh_shape=mesh)
    params = ttm.init_moe_params(cfg, seed=50)
    shards = ttm.shard_params(params, cfg=cfg, ctx=ctx)
    del params
    router0 = [s["layers"][0]["router"].clone() for s in shards]
    m_loc = m // ctx.axis_size(cfg.axis)
    models = [ttm.EPMoETransformer(cfg, ctx=ctx) for _ in range(ctx.world)]

    def step():
        r = ctx.rank
        d = 0 if dp_axis is None else ctx.axis_index(dp_axis)
        shards[r], loss = ttm.train_step(models[r], shards[r],
                                         tokens[r * m_loc:(r + 1) * m_loc],
                                         targets[d * m:(d + 1) * m], lr=TRAIN_LR,
                                         dp_axis=dp_axis)
        return loss.item()

    res = _train_counted(name, ctx, step, counters)
    moved = max((s["layers"][0]["router"].float() - r0.float()).abs().max().item()
                for s, r0 in zip(shards, router0))
    replicas = None
    if dp_axis is not None:
        tp = ctx.axis_size(cfg.axis)
        banks = ("w_up", "w_down")
        for r in range(tp):
            a, b = shards[r], shards[tp + r]
            for la, lb in zip(a["layers"], b["layers"]):
                for k in la:
                    if k not in banks and not torch.equal(la[k], lb[k]):
                        raise AssertionError(f"{name}: the dp replicas of {k} drifted apart")
            for k in ("embed", "final_norm", "lm_head"):
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"{name}: the dp replicas of {k} drifted apart")
        replicas = True
    ctx.close()
    del shards, models
    torch.cuda.empty_cache()
    small = dataclasses.replace(
        presets.preset(model_name, n_layers=1, dtype=torch.float32), **F32_TRAIN)
    res.update(model=model_name, n_layers=8, mesh=mesh, dp_axis=dp_axis, lr=TRAIN_LR,
               tokens_a_dp_group=m, train_tokens_per_s=n_dp * m / res["step_wall_s_median"],
               router_max_change=moved, replicas_bitwise_equal=replicas,
               f32=_f32_train_vs_cpu(f"{name} f32", small, mesh, dp_axis))
    emit(res)
    _check_train(name, res["losses"], res["launches"], res["plain_calls"],
                 ("all_to_all", "group_gemm", "group_gemm_dw", "ag_gemm", "gemm_rs"))
    if not moved > 0:
        raise AssertionError(f"{name}: the router did not move")
    return res["launches"]


def phase_train_moe_ep4(counters: Counters) -> dict:
    """``train_moe_ep4``: ``preset("mixtral-8x7b:ep")`` at ``train_moe_tp4``'s
    depth (8 layers) trained at world 4 on the one card (two whole experts
    a rank, attention TP over the four ranks), as ``_train_moe_ep``
    describes."""
    return _train_moe_ep("train_moe_ep4", counters, EP_MODEL, {"tp": WORLD}, None)


def phase_train_moe_ep_hier(counters: Counters) -> dict:
    """``train_moe_ep_hier``: ``serve_moe_ep_hier``'s model
    (``mixtral-8x7b:ep-hier``, outer axis ``"dcn"``) on ``{"dcn": 2, "tp":
    2}`` trained with ``dp_axis="dcn"``: the dispatch's two phases over
    (dcn, tp), each dcn group's 2 x 1024 tokens; the dp replicas of every
    replicated parameter stay bitwise equal. A step peaks at ~73 GB of the
    card's 80 (the relay's grouped GEMMs take 2 x 4096 rows a rank)."""
    return _train_moe_ep("train_moe_ep_hier", counters, HIER_MODEL, HIER_MESH, "dcn")


def phase_train_adam(counters: Counters) -> dict:
    """``train_adam``: ``train_dense``'s model (Llama-3.1-8B widths, 2
    layers, bf16, 2 x 1024 tokens a dp group) with ``optim.adam(ADAM_LR)``
    at world 1 and on ``{"dp": 2, "tp": 2}``: a warm-up and 3 steps each
    (losses finite and falling), K1 (world 1) and K6/K7 (the pair)
    launched, no plain projection, the step wall and the peak GB with the
    Adam state (two moments in the parameters' dtype); then f32 Adam steps
    at small width against the CPU plain path at both layouts."""
    import torch
    from triton_dist_tpu_torch import optim
    from triton_dist_tpu_torch.models import presets
    from triton_dist_tpu_torch.models import tp_transformer as ttm
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    cfg = presets.preset("llama-3.1-8b", n_layers=2, batch=TRAIN_B, seq=TRAIN_S,
                         dtype=torch.bfloat16)
    adam = optim.adam(ADAM_LR)
    out, launches = {}, {}
    tokens, targets = _train_batch(cfg.vocab, seed=61)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ttm.init_params(cfg, seed=52)
    state = adam.init(params)
    model = ttm.TPTransformer(cfg)
    params, state, loss = ttm.train_step(model, params, tokens, targets, dp_axis=None, opt=adam,
                                         opt_state=state)
    losses, walls = [loss.item()], []
    counters.reset()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = ttm.train_step(model, params, tokens, targets, dp_axis=None,
                                             opt=adam, opt_state=state)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
    counts = counters.read()
    wall = sorted(walls)[len(walls) // 2]
    out["world1"] = dict(losses=losses, step_wall_s=walls, step_wall_s_median=wall,
                         train_tokens_per_s=TRAIN_B * TRAIN_S / wall,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         state_gb=sum(t.numel() * t.element_size() for t in _leaves(state))
                         / 1e9, **counts)
    _check_train("train_adam world 1", losses, counts["launches"], counts["plain_calls"],
                 ("gemm",))
    del params, state
    torch.cuda.empty_cache()

    dp, tp = PAIR["dp"], PAIR["tp"]
    m = TRAIN_B * TRAIN_S
    tokens = torch.cat([_train_batch(cfg.vocab, seed=60 + d)[0] for d in range(dp)])
    targets = torch.cat([_train_batch(cfg.vocab, seed=60 + d)[1] for d in range(dp)])
    ctx = initialize_distributed(mesh_shape=PAIR)
    shards = ttm.shard_params(ttm.init_params(cfg, seed=52), cfg=cfg, ctx=ctx)
    states = [adam.init(s) for s in shards]
    m_loc = m // tp
    models = [ttm.TPTransformer(cfg, ctx=ctx) for _ in range(WORLD)]

    def step():
        r, d = ctx.rank, ctx.axis_index("dp")
        shards[r], states[r], loss = ttm.train_step(
            models[r], shards[r], tokens[r * m_loc:(r + 1) * m_loc], targets[d * m:(d + 1) * m],
            opt=adam, opt_state=states[r])
        return loss.item()

    res = _train_counted("train_adam_dp_tp", ctx, step, counters)
    for r in range(tp):
        for a, b in zip(_leaves((shards[r], states[r])), _leaves((shards[tp + r],
                                                                   states[tp + r]))):
            if not torch.equal(a, b):
                raise AssertionError("train_adam: the dp replicas drifted apart")
    res["state_gb_a_rank"] = sum(t.numel() * t.element_size() for t in _leaves(states[0])) / 1e9
    res["train_tokens_per_s"] = dp * m / res["step_wall_s_median"]
    ctx.close()
    del shards, states, models
    torch.cuda.empty_cache()
    out["dp_tp"] = res
    _check_train("train_adam dp x tp", res["losses"], res["launches"], res["plain_calls"],
                 ("ag_gemm", "gemm_rs"))
    small = dataclasses.replace(presets.preset("llama-3.1-8b", n_layers=1,
                                               dtype=torch.float32), **F32_TRAIN)
    out["f32_world1"] = _f32_train_vs_cpu("train_adam f32 world 1", small, None,
                                          opt=optim.adam(ADAM_LR), steps=2)
    out["f32_dp_tp"] = _f32_train_vs_cpu("train_adam f32 dp x tp", small, PAIR, "dp",
                                         opt=optim.adam(ADAM_LR), steps=2)
    emit({"phase": "train_adam", "model": "llama-3.1-8b", "n_layers": 2, "lr": ADAM_LR,
          "mesh": PAIR, "replicas_bitwise_equal": True, **out})
    for key in ("world1", "dp_tp"):
        for k, v in out[key]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def phase_usp_attention(counters: Counters) -> dict:
    """``usp_attention``: ``train_sp``'s attention widths (32 heads of 128,
    b 1) at S 8192 on ``{"sp": 2, "tp": 2}``: the Ulysses head exchange
    over tp (K27) composed with ring attention over sp (K35), bf16, causal,
    forward and backward in one counted run (K27 and K35 launched, no plain
    exchange or attention); its output against ring attention over the
    flat world 4 (K35 over 2048-row chunks) and SDPA over the whole
    sequence, each query row (a head's d-vector) on its own scale: every
    row within 2e-2 relative L2 of both (bf16 rounding is ~4e-3 a row; a
    ring step dropped for a row takes away a share of its keys, an error of
    the order of the row), the whole output within 1e-2; the forward timed
    beside both."""
    import torch
    from triton_dist_tpu_torch.ops import ring_attention as ra
    from triton_dist_tpu_torch.ops import ulysses
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    h, d, s = 32, 128, SP_S
    s_loc = s // WORLD
    g = torch.Generator(device="cuda").manual_seed(120)
    q, k, v, dout = (torch.randn((1, h, s, d), generator=g, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    rows = lambda x, r: x[:, :, r * s_loc:(r + 1) * s_loc].contiguous()  # noqa: E731
    mesh = {"sp": 2, "tp": 2}
    ctx = initialize_distributed(mesh_shape=mesh)

    def usp_step():
        r = ctx.rank
        leaves = [rows(x, r).requires_grad_() for x in (q, k, v)]
        out = ulysses.usp_attention(*leaves, ctx=ctx, outer="sp", inner="tp")
        grad = torch.autograd.grad(out, leaves, rows(dout, r))
        return out.detach(), grad

    ctx.run(usp_step, grad=True)
    counters.reset()
    res = ctx.run(usp_step, grad=True)
    counts = counters.read()
    got = torch.cat([o for o, _ in res], 2)
    usp_ms = dist_ms(ctx, lambda: ulysses.usp_attention(
        rows(q, ctx.rank), rows(k, ctx.rank), rows(v, ctx.rank), ctx=ctx, outer="sp",
        inner="tp"), iters=5)
    ctx.close()
    flat = initialize_distributed(WORLD)
    ring = torch.cat(flat.run(lambda: ra.ring_attention(
        rows(q, flat.rank), rows(k, flat.rank), rows(v, flat.rank), ctx=flat)), 2)
    ring_ms = dist_ms(flat, lambda: ra.ring_attention(
        rows(q, flat.rank), rows(k, flat.rank), rows(v, flat.rank), ctx=flat), iters=5)
    flat.close()
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10)
    errs = {}
    for ref_name, ref in (("flat_ring", ring), ("sdpa", sdpa)):
        diff, ref = got.float() - ref.float(), ref.float()
        rows_rel = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        errs[ref_name] = dict(worst_row_rel_l2=rows_rel.max().item(),
                              rel_l2=(diff.norm() / ref.norm()).item(),
                              max_abs_err=diff.abs().max().item())
    launches = counts["launches"]
    emit({"phase": "usp_attention", "mesh": mesh, "heads": h, "head_dim": d, "seq": s,
          "s_loc": s_loc, "errors": errs, "tol_row_rel_l2": 2e-2, "tol_rel_l2": 1e-2,
          "usp_forward_ms": usp_ms, "flat_ring_forward_ms": ring_ms, "sdpa_ms": sdpa_ms,
          **counts})
    if any(e["worst_row_rel_l2"] > 2e-2 or e["rel_l2"] > 1e-2 for e in errs.values()):
        raise AssertionError(f"usp_attention: off ring attention / SDPA: {errs}")
    if (launches["all_to_all"] <= 0 or launches["ring_attention"] <= 0
            or any(counts["plain_calls"].values())):
        raise AssertionError(f"usp_attention: launches {launches}, plain {counts['plain_calls']}")
    del q, k, v, dout, got, ring, sdpa
    return launches



def _unflatten(tree, leaves):
    """`leaves` (in ``_tree_leaves`` order) in `tree`'s structure."""
    from triton_dist_tpu_torch.models import tp_transformer as ttm

    it = iter(leaves)
    return ttm._tree_map(lambda _: next(it), tree)



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
    verify_entries = [phase_flash_verify(), phase_paged_flash_verify()]
    quant_entries = [phase_flash_decode_quant(), phase_paged_flash_decode_quant(),
                     phase_flash_verify_quant()]
    moe_entries = [phase_group_gemm()]
    scaled_entries = [phase_group_gemm_scaled()]
    ragged_entries = [phase_group_gemm_ragged()]
    train_entries = [phase_group_gemm_dw()]
    k34_k35_entries = [phase_group_gemm_dw_ragged()]
    torch.cuda.empty_cache()
    # the Adam and EP train steps first: they peak at ~61 and ~73 GB of the
    # 80, and the serving phases leave ~12 GB held behind them
    with expandable_segments():
        phase_train_adam(counters)
        torch.cuda.empty_cache()
        phase_train_moe_ep4(counters)
        torch.cuda.empty_cache()
        phase_train_moe_ep_hier(counters)
    paged = phase_serve(counters)
    torch.cuda.empty_cache()
    contiguous = phase_contiguous(counters)
    torch.cuda.empty_cache()
    phase_f32_parity()
    torch.cuda.empty_cache()
    chunked, prefix = phase_ranged_serving(counters)
    torch.cuda.empty_cache()
    chunked_contiguous = phase_chunked_contiguous(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_ranged()
    torch.cuda.empty_cache()
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    ctx = initialize_distributed(WORLD)
    dist_entries = [phase_barrier(ctx), phase_all_gather(ctx), phase_ag_gemm(ctx),
                    phase_gemm_rs(ctx)]
    moe_entries += [phase_ag_group_gemm(ctx), phase_moe_reduce_rs(ctx)]
    scaled_entries += [phase_ag_group_gemm_scaled(ctx), phase_moe_reduce_rs_scaled(ctx)]
    ragged_entries += [phase_ag_group_gemm_ragged(ctx), phase_moe_reduce_rs_ragged(ctx)]
    chunked_entries = [phase_ag_group_gemm_chunked(ctx), phase_moe_reduce_rs_chunked(ctx)]
    train_entries.append(phase_reduce_scatter(ctx))
    ep_entries = phase_all_to_all(ctx)
    torch.cuda.empty_cache()
    k34_k35_entries.append(phase_ring_attention(ctx))
    torch.cuda.empty_cache()
    quant_launches = phase_quant_kv_path(counters, ctx)
    torch.cuda.empty_cache()
    ctx.full_mesh = False  # the same ranks, declared a ring
    ring_entries = [phase_ag_gemm_ring(ctx), *phase_gemm_rs_ring(ctx),
                    phase_reduce_scatter_ring(ctx)]
    ctx.close()
    torch.cuda.empty_cache()
    entries_2d = [phase_all_gather_2d(), phase_ag_gemm_2d()]
    torch.cuda.empty_cache()
    kv_entries = phase_kv_stream()
    torch.cuda.empty_cache()
    kv_launches = phase_kv_stream_path(counters)
    torch.cuda.empty_cache()
    phase_stuck_wait()
    phase_stuck_wait_moe()
    phase_stuck_wait_rs()
    phase_stuck_wait_ring()
    phase_stuck_wait_a2a()
    phase_stuck_wait_ragged()
    phase_stuck_wait_ring_attention()
    phase_stuck_wait_2d()
    phase_stuck_wait_kv_stream()
    torch.cuda.empty_cache()
    tp4 = phase_serve_tp4(counters)
    torch.cuda.empty_cache()
    tp4_ring = phase_serve_tp4_ring(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_tp4()
    torch.cuda.empty_cache()
    phase_f32_parity_tp4(ring=True)
    torch.cuda.empty_cache()
    moe1, moe4 = phase_serve_moe(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_moe()
    torch.cuda.empty_cache()
    moe_w8, moe_fp8, moe_tp4_w8 = phase_serve_moe_quant(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_moe_quant()
    torch.cuda.empty_cache()
    moe_ep4, moe_ep4_q = phase_serve_moe_ep(counters)
    torch.cuda.empty_cache()
    moe_ep_hier = phase_serve_moe_ep_hier(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_ep()
    torch.cuda.empty_cache()
    moe_ep4_r, moe_tp4_r = phase_serve_moe_ragged(counters)
    torch.cuda.empty_cache()
    moe_tp4_c = phase_serve_moe_chunked(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_ragged()
    torch.cuda.empty_cache()
    train1, train4 = phase_train_moe(counters)
    torch.cuda.empty_cache()
    train_r1, train_r4 = phase_train_moe_ragged(counters)
    torch.cuda.empty_cache()
    phase_train_dense(counters)
    torch.cuda.empty_cache()
    phase_train_dp_tp(counters)
    torch.cuda.empty_cache()
    train_sp = phase_train_sp(counters)
    torch.cuda.empty_cache()
    phase_usp_attention(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_sp()
    torch.cuda.empty_cache()
    # its world-4 ragged step ran out of memory once with 13.3 GB of the 80
    # free but split (fixed-size segments), as the early training phases did
    with expandable_segments():
        phase_f32_parity_train()
    torch.cuda.empty_cache()
    train_ring = phase_train_ring(counters)
    torch.cuda.empty_cache()
    ctx = initialize_distributed(WORLD)
    ctx.full_mesh = False
    gather_entries = phase_ring_collectives(ctx)
    ctx.close()
    phase_stuck_wait_ring_bidir()
    torch.cuda.empty_cache()
    layers_ring = phase_layers_ring(counters)
    torch.cuda.empty_cache()
    layers_ep = phase_layers_ep(counters)
    torch.cuda.empty_cache()
    layers_2d = phase_layers_2d(counters)
    torch.cuda.empty_cache()
    phase_f32_parity_2d()
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
    verify_entries[0]["launches"] = chunked_contiguous["flash_verify"]
    verify_entries[1]["launches"] = (chunked["paged_flash_verify"]
                                     + prefix["paged_flash_verify"])
    entries += verify_entries
    ring_entries[0]["launches"] = tp4_ring["ag_gemm_ring"] + train_ring["ag_gemm_ring"]
    ring_entries[1]["launches"] = tp4_ring["gemm_rs_ring"] + train_ring["gemm_rs_ring"]
    ring_entries[2]["launches"] = (tp4_ring["gemm_rs_ring_chunked"]
                                   + train_ring["gemm_rs_ring_chunked"])
    ring_entries[3]["launches"] = train_ring["reduce_scatter_ring"]
    entries += ring_entries
    for entry in gather_entries:
        entry["launches"] = layers_ring[entry["name"]]
    entries += gather_entries
    scaled_entries[0]["launches"] = moe_w8["group_gemm_scaled"] + moe_fp8["group_gemm_scaled"]
    scaled_entries[1]["launches"] = moe_tp4_w8["ag_group_gemm_scaled"]
    scaled_entries[2]["launches"] = moe_tp4_w8["moe_reduce_rs_scaled"]
    entries += scaled_entries
    ep_entries[0]["launches"] = (moe_ep4["all_to_all"] + moe_ep4_q["all_to_all"]
                                 + moe_ep_hier["all_to_all"])
    ep_entries[1]["launches"] = layers_ep["all_to_all_chunked"]
    entries += ep_entries
    ragged_entries[0]["launches"] = (moe_ep4_r["group_gemm_ragged"]
                                     + moe_tp4_r["group_gemm_ragged"])
    ragged_entries[1]["launches"] = moe_tp4_r["ag_group_gemm_ragged"]
    ragged_entries[2]["launches"] = moe_tp4_r["moe_reduce_rs_ragged"]
    entries += ragged_entries
    chunked_entries[0]["launches"] = moe_tp4_c["ag_group_gemm_chunked"]
    chunked_entries[1]["launches"] = moe_tp4_c["moe_reduce_rs_chunked"]
    entries += chunked_entries
    k34_k35_entries[0]["launches"] = (train_r1["group_gemm_dw_ragged"]
                                      + train_r4["group_gemm_dw_ragged"])
    k34_k35_entries[1]["launches"] = train_sp["ring_attention"]
    entries += k34_k35_entries
    entries_2d[0]["launches"] = layers_2d["all_gather_2d"]
    entries_2d[1]["launches"] = layers_2d["ag_gemm_2d"]
    entries += entries_2d
    for entry in quant_entries:
        entry["launches"] = quant_launches[entry["name"]]
    entries += quant_entries
    kv_entries[0]["launches"] = kv_launches["kv_stream"]
    kv_entries[1]["launches"] = kv_launches["kv_stream_w8"]
    entries += kv_entries
    if any(e["launches"] <= 0 for e in entries):
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{[(e['name'], e['launches']) for e in entries]}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
