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
- ``moe_rs``: site ``n + p`` is the reduce's wait for the partial of rank
  ``p`` in landing slot ``p`` (kind ``signal_wait_until``);
- ``reduce_scatter`` (and its entry barrier, sites ``p < n``): site ``n +
  d`` is the reduce's wait for the chunk in landing slot ``d``, sent by
  rank ``me - d - 1`` (kind ``signal_wait_until``);
- the ring kernels ``ag_gemm_ring``, ``gemm_rs_ring``,
  ``reduce_scatter_ring``, ``all_gather_ring_1d`` and
  ``all_gather_ring_bidir`` (``csrc/ring.cu``): site ``p < n`` is the wait
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
  whole-slab kernel; kind ``signal_wait_until``).
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
            "all_to_all": 13, "all_to_all_chunked": 14}
RING_FAMILIES = ("ag_gemm_ring", "gemm_rs_ring", "reduce_scatter_ring", "all_gather_ring_1d",
                 "all_gather_ring_bidir")
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
    return f"site {site}"
