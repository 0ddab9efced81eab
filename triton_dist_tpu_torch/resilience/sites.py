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
  rank ``me - d - 1`` (kind ``signal_wait_until``).
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
            "moe_rs": 6, "reduce_scatter": 7}
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
    if family == "all_gather":
        return f"shard of rank {p}"
    if family == "ag_gemm":
        return f"shard {p} in the gather workspace"
    if family in ("gemm_rs", "reduce_scatter"):
        return f"landing slot {p}"
    if family == "ag_group_gemm":
        return f"sorted slab of rank {p} in the gather workspace"
    if family == "moe_rs":
        return f"partial of rank {p} in landing slot {p}"
    return f"site {site}"
