"""The wait-site numbering of the port's distributed kernels (≙
``triton_dist_tpu/resilience/sites.py``).

A bounded wait names itself in a timeout record by ``(family, site,
kind)``. The kind codes are the JAX package's; the device side
(``csrc/shmem.cuh``) burns the same numbers into the diagnostic buffer.

Site numbering per family, for a launch at world ``n``:

- ``barrier``, and the entry barriers of ``all_gather``, ``ag_gemm`` and
  ``gemm_rs``: site ``p`` is the wait for peer ``p``'s arrival (kind
  ``barrier_all``);
- ``all_gather``: site ``n + p`` is the wait for peer ``p``'s shard (kind
  ``signal_wait_until``);
- ``ag_gemm``: site ``n + c`` is a consumer block's wait for shard ``c``
  (kind ``wait``);
- ``gemm_rs``: site ``n + d`` is the wait for the chunk in landing slot
  ``d``, sent by rank ``me - d - 1`` (kind ``signal_wait_until``);
- ``ag_group_gemm``: site ``n + c`` is a consumer block's wait for the
  sorted slab of rank ``c`` (kind ``wait``);
- ``ag_group_gemm_chunked`` (K32, the epochs and entry barrier of
  ``ag_group_gemm``): site ``n + c * MAX_SPANS + j`` is a consumer block's
  wait for span ``j`` of rank ``c``'s sorted slab, chunk 0 of a slab first
  (kind ``wait``);
- ``moe_rs``: site ``n + p`` is the reduce's wait for the partial of rank
  ``p`` in landing slot ``p`` (kind ``signal_wait_until``);
- ``moe_rs_chunked`` (K33, the epochs and entry barrier of ``moe_rs``):
  site ``n + p * MAX_SPANS + j`` is the reduce's wait for span ``j`` (in
  the policy's list order) of rank ``p``'s partial, chunk 0 first (kind
  ``signal_wait_until``);
- ``reduce_scatter`` (and its entry barrier, sites ``p < n``): site ``n +
  d`` is the reduce's wait for the chunk in landing slot ``d``, sent by
  rank ``me - d - 1`` (kind ``signal_wait_until``);
- the ring kernels ``ag_gemm_ring``, ``gemm_rs_ring``,
  ``reduce_scatter_ring``, ``all_gather_ring_1d`` and
  ``all_gather_ring_bidir`` (``csrc/ring.cu``), and ``ring_attention``
  (``csrc/ring_attention.cu``, one chunk a step): site ``p < n`` is the wait
  for the arrival of the neighbour ``p`` before the first store into its
  buffers (kind ``barrier_all``; the right neighbour, and in the
  bidirectional ring then the left one); site ``n + s * MAX_SPANS + j`` is
  the wait for chunk ``j`` of the left neighbour's step-``s`` put, and in
  the bidirectional ring site ``n + (n - 1 + s) * MAX_SPANS + j`` the wait
  for chunk ``j`` of the right neighbour's step-``s`` put of the chunks
  that travel left (kind ``signal_wait_until``);
- ``all_to_all`` and ``all_to_all_chunked`` (``csrc/a2a.cu``; one epoch
  counter, one flag set): site ``n + p * MAX_SPANS + j`` is the collect's
  wait for chunk ``j`` of rank ``p``'s slab (one chunk, ``j`` 0, in the
  whole-slab kernel; kind ``signal_wait_until``);
- the 2-D rings ``all_gather_2d`` (K36) and ``ag_gemm_2d`` (K37,
  ``csrc/ring.cu``), over a pair group of ``n = n_o * n_i`` ranks: site
  ``p < n`` is the entry barrier's wait for group rank ``p``'s arrival,
  in rank order (kind ``barrier_all``); site ``n + s`` is the wait for the
  inner chunk put at the left inner neighbour's inner step ``s``, before
  this rank's inner step ``s + 1``; site ``n + MAX_SPANS * (1 + t) + s``
  the wait for inner chunk ``s`` that the outer neighbour above put at its
  outer round ``t``, before this rank's outer round ``t + 1`` (kind
  ``signal_wait_until``);
- the KV handoff stream ``kv_stream`` (K41), ``kv_stream_w8`` and
  ``kv_stream_fp8`` (K42, ``csrc/kv_stream.cu``): site ``n + j`` is the
  wait for payload chunk ``j`` of the mirror's slab, site ``n + MAX_SPANS
  + j`` the wait for its scale chunk ``j``; chunk 0's payload wait comes
  first (kind ``signal_wait_until``).
"""

from __future__ import annotations

KIND_SIGNAL = 1   # signal_wait_until
KIND_WAIT = 2     # wait (dl.wait parity)
KIND_BARRIER = 3  # a barrier_all arrival

KIND_NAMES = {
    KIND_SIGNAL: "signal_wait_until",
    KIND_WAIT: "wait",
    KIND_BARRIER: "barrier_all",
}

# kernel families: the small ints the device records carry
FAMILIES = {"barrier": 1, "all_gather": 2, "ag_gemm": 3, "gemm_rs": 4, "ag_group_gemm": 5,
            "moe_rs": 6, "reduce_scatter": 7, "ag_gemm_ring": 8, "gemm_rs_ring": 9,
            "reduce_scatter_ring": 10, "all_gather_ring_1d": 11, "all_gather_ring_bidir": 12,
            "all_to_all": 13, "all_to_all_chunked": 14, "ag_group_gemm_chunked": 15,
            "moe_rs_chunked": 16, "ring_attention": 17, "all_gather_2d": 18, "ag_gemm_2d": 19,
            "kv_stream": 20, "kv_stream_w8": 21, "kv_stream_fp8": 22}
KV_STREAM_FAMILIES = ("kv_stream", "kv_stream_w8", "kv_stream_fp8")
RING_2D_FAMILIES = ("all_gather_2d", "ag_gemm_2d")
RING_FAMILIES = ("ag_gemm_ring", "gemm_rs_ring", "reduce_scatter_ring", "all_gather_ring_1d",
                 "all_gather_ring_bidir", "ring_attention")
MAX_SPANS = 16  # csrc/shmem.cuh MAX_SPANS: the (step, chunk) flag slots a step owns
FAMILY_NAMES = {code: name for name, code in FAMILIES.items()}


def kind_name(code: int) -> str:
    return KIND_NAMES.get(int(code), f"<kind {int(code)}>")


def family_name(code: int) -> str:
    return FAMILY_NAMES.get(int(code), f"<family {int(code)}>")


def site_name(family: str, site: int, world: int) -> str:
    """What a site ordinal waits for, in words."""
    if site < world:
        return f"entry barrier: arrival of rank {site}"
    p = site - world
    if family in RING_2D_FAMILIES:
        if p < MAX_SPANS:
            return f"inner chunk of the left inner neighbour's inner step {p}"
        t, s = divmod(p - MAX_SPANS, MAX_SPANS)
        return f"inner chunk {s} of the outer neighbour's outer round {t}"
    if family in KV_STREAM_FAMILIES:
        what, j = ("scale", p - MAX_SPANS) if p >= MAX_SPANS else ("payload", p)
        return f"{what} chunk {j} of the mirror's slab"
    if family in RING_FAMILIES:
        step, chunk = divmod(p, MAX_SPANS)
        if step >= world - 1:
            return (f"chunk {chunk} of the right neighbour's step {step - (world - 1)} "
                    f"(travelling left)")
        return f"chunk {chunk} of the left neighbour's step {step}"
    if family == "all_gather":
        return f"shard of rank {p}"
    if family == "ag_gemm":
        return f"shard {p} in the gather workspace"
    if family in ("gemm_rs", "reduce_scatter"):
        return f"landing slot {p}"
    if family == "ag_group_gemm":
        return f"sorted slab of rank {p} in the gather workspace"
    if family == "all_to_all":
        return f"slab of rank {p // MAX_SPANS}"
    if family == "all_to_all_chunked":
        return f"chunk {p % MAX_SPANS} of rank {p // MAX_SPANS}'s slab"
    if family == "moe_rs":
        return f"partial of rank {p} in landing slot {p}"
    if family == "ag_group_gemm_chunked":
        return f"chunk {p % MAX_SPANS} of rank {p // MAX_SPANS}'s sorted slab"
    if family == "moe_rs_chunked":
        return f"chunk {p % MAX_SPANS} of rank {p // MAX_SPANS}'s partial"
    return f"site {site}"
