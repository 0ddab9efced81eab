"""Diagnostic-record layout of the bounded waits (≙
``triton_dist_tpu/resilience/records.py``).

Every rank of a runtime owns one ``int32[DIAG_LEN]`` buffer on its card.
A device-side wait that expires writes one record into it (first record
wins; ``csrc/shmem.cuh``); the runtime reads the buffer after the rank's
streams sync and raises :class:`DistTimeoutError` with the decoded record.
"""

from __future__ import annotations

from triton_dist_tpu_torch.resilience import sites as _sites

DIAG_LEN = 8

# slot indices (csrc/shmem.cuh F_*)
F_STATUS = 0      # STATUS_OK / STATUS_TIMEOUT
F_FAMILY = 1      # kernel family code (sites.FAMILIES)
F_PE = 2          # the rank whose wait expired
F_SITE = 3        # the wait site inside the kernel (sites.py numbering)
F_KIND = 4        # KIND_* of the wait
F_EXPECTED = 5    # the flag value (epoch) the wait needed
F_OBSERVED = 6    # the flag value last read before giving up
F_BUDGET = 7      # the timeout that expired, in microseconds

STATUS_OK = 0
STATUS_TIMEOUT = 1


def decode_record(row, world: int) -> dict:
    """One int32[DIAG_LEN] row as a readable dict."""
    row = [int(v) for v in row]
    family = _sites.family_name(row[F_FAMILY])
    return {
        "status": "ok" if row[F_STATUS] == STATUS_OK else "timeout",
        "family": family,
        "pe": row[F_PE],
        "site": row[F_SITE],
        "waits_for": _sites.site_name(family, row[F_SITE], world),
        "kind": _sites.kind_name(row[F_KIND]),
        "expected": row[F_EXPECTED],
        "observed": row[F_OBSERVED],
        "budget_us": row[F_BUDGET],
    }


class DistTimeoutError(RuntimeError):
    """A bounded device-side wait expired: ``records`` holds one decoded
    record per rank that tripped — family, rank, wait site and kind, the
    flag value expected and the one observed, and the timeout. A record
    the runtime decoded also names the global ``rank`` and the ``group``
    (its axes) the kernel ran over: ``pe`` and the site's ranks are group
    ranks."""

    def __init__(self, records: list[dict], world_size: int):
        self.records = records
        self.world_size = world_size
        detail = "; ".join(
            f"rank {r['pe']}: {r['family']} {r['kind']} site {r['site']} "
            f"({r['waits_for']}) expected {r['expected']} observed "
            f"{r['observed']} after {r['budget_us']} us"
            + (f" [global rank {r['rank']}, group {r['group']}]" if "group" in r else "")
            for r in records
        )
        super().__init__(
            f"distributed wait timed out on {len(records)} of {world_size} "
            f"rank(s): {detail}. A peer never arrived, or arrived far too "
            f"late; this rank's outputs are not valid."
        )
