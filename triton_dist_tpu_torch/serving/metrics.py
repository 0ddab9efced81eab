"""Streaming serving metrics: log-binned histograms, SLO attainment, and a
``snapshot()`` surface (a copy of ``triton_dist_tpu/serving/metrics.py``;
the port imports nothing of the JAX package, so it keeps its own).

Design constraints:

- **Streaming and mergeable** — latency samples land in fixed log-spaced
  bins (no sample buffer to grow with traffic); two histograms with the
  same geometry merge by adding counts.
- **Deterministic** — nothing here reads a wall clock. Every timestamp
  comes from the caller (the engine's injectable clock), so two serving
  runs with the same traffic seed and a ``FakeClock`` produce *identical*
  snapshots — and identical to the JAX package's engine on the same
  serve.

Percentiles are read from the bins: ``percentile(p)`` returns the upper
edge of the first bin whose cumulative count reaches ``p`` — a
deterministic, resolution-bounded estimate (bins_per_decade=8 bounds the
relative error at ~33%, plenty for p50/p95/p99 trend lines).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


class StreamingHistogram:
    """Fixed log-spaced bins over ``[lo, hi)`` with underflow/overflow.

    ``record`` is O(1) (a log10 and an index), ``merge`` requires identical
    geometry, and ``percentile``/``snapshot`` are pure functions of the
    counts — no stored samples, no wall clock.
    """

    __slots__ = ("lo", "hi", "bins_per_decade", "n_bins", "counts",
                 "total", "sum", "max")

    def __init__(self, lo: float = 1e-2, hi: float = 1e7,
                 bins_per_decade: int = 8):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if bins_per_decade < 1:
            raise ValueError("bins_per_decade must be >= 1")
        self.lo, self.hi = float(lo), float(hi)
        self.bins_per_decade = int(bins_per_decade)
        self.n_bins = int(
            math.ceil(round(math.log10(self.hi / self.lo), 9)
                      * self.bins_per_decade)
        )
        # [underflow] + n_bins + [overflow]
        self.counts = [0] * (self.n_bins + 2)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    def _edge(self, i: int) -> float:
        """Upper edge of bin ``i`` (0-based over the log bins)."""
        return self.lo * 10.0 ** ((i + 1) / self.bins_per_decade)

    def record(self, value: float, n: int = 1) -> None:
        v = float(value)
        if v <= self.lo:
            idx = 0
        elif v >= self.hi:
            idx = self.n_bins + 1
        else:
            idx = 1 + int(math.log10(v / self.lo) * self.bins_per_decade)
            idx = min(max(idx, 1), self.n_bins)
        self.counts[idx] += n
        self.total += n
        self.sum += v * n
        if v > self.max:
            self.max = v

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` into self (same geometry required)."""
        if (self.lo, self.hi, self.bins_per_decade) != (
            other.lo, other.hi, other.bins_per_decade
        ):
            raise ValueError(
                f"histogram geometry mismatch: "
                f"({self.lo}, {self.hi}, {self.bins_per_decade}) vs "
                f"({other.lo}, {other.hi}, {other.bins_per_decade})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> float:
        """Upper edge of the bin where the cumulative count reaches ``p``
        (0 < p <= 1). 0.0 on an empty histogram."""
        if not 0.0 < p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {p}")
        if self.total == 0:
            return 0.0
        need = math.ceil(p * self.total)
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= need:
                if i == 0:
                    return self.lo
                if i == self.n_bins + 1:
                    return self.hi
                return self._edge(i - 1)
        return self.hi  # unreachable

    def fraction_le(self, bound: float) -> float:
        """Fraction of samples whose BIN lies entirely at or below
        ``bound`` — the histogram-resolution SLO attainment estimate.
        1.0 on an empty histogram (no sample violated anything)."""
        if self.total == 0:
            return 1.0
        acc = self.counts[0] if bound >= self.lo else 0
        for i in range(self.n_bins):
            if self._edge(i) <= bound:
                acc += self.counts[i + 1]
        if bound >= self.hi:
            acc += self.counts[self.n_bins + 1]
        return acc / self.total

    def snapshot(self) -> dict:
        mean = self.sum / self.total if self.total else 0.0
        return {
            "count": self.total,
            "mean": round(mean, 6),
            "max": round(self.max, 6),
            "p50": round(self.percentile(0.50), 6),
            "p95": round(self.percentile(0.95), 6),
            "p99": round(self.percentile(0.99), 6),
        }


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Latency targets a finished request is scored against (ms). ``None``
    disables a dimension; a request attains the SLO iff every set
    dimension is met."""

    ttft_ms: float | None = None
    e2e_ms: float | None = None
    tpot_ms: float | None = None  # mean per-output-token latency

    def as_dict(self) -> dict:
        return {
            k: v for k, v in dataclasses.asdict(self).items() if v is not None
        }


class ServingMetrics:
    """The serving engine's metric registry: latency histograms (TTFT,
    per-output-token, e2e), load gauges (queue depth, slot occupancy),
    request/token counters, and SLO attainment — one ``snapshot()``.

    All times arrive in milliseconds from the engine's injectable clock;
    this module never reads time itself (see module docstring).

    ``classes`` opts into the per-priority-class surface the
    overload controller needs: per-class TTFT histograms plus per-class
    counters (``count_class``), and **goodput** accounting — tokens from
    requests that attained every set SLO dimension AND met their deadline
    count toward ``tokens_goodput``; everything else is throughput the
    SLO can't use. With ``classes=None`` (the default) the snapshot is
    the pre-overload one plus the always-present goodput total."""

    def __init__(self, slo: SLOTargets | None = None,
                 classes: tuple | None = None):
        self.slo = slo
        self.classes = tuple(classes) if classes is not None else None
        self.ttft_ms = StreamingHistogram()
        self.resumed_ttft_ms = StreamingHistogram()
        self.tpot_ms = StreamingHistogram()
        self.e2e_ms = StreamingHistogram()
        # queue depth / occupancy are small integers: lo=1 puts 0 in the
        # underflow bin (reported as <=1) and keeps single-digit depths
        # resolvable
        self.queue_depth = StreamingHistogram(lo=1.0, hi=1e6)
        self.slot_occupancy = StreamingHistogram(lo=1e-2, hi=10.0)
        self.counters: dict[str, int] = {}
        self.tokens_generated = 0
        # goodput = SLO-attaining throughput (deadline included): the
        # metric an overload A/B judges
        self.tokens_goodput = 0
        self._slo_ok = 0
        self._slo_ok_by: dict[str, int] = {"ttft_ms": 0, "e2e_ms": 0,
                                           "tpot_ms": 0}
        self._slo_total = 0
        self._class_ttft: dict[str, StreamingHistogram] = {
            c: StreamingHistogram() for c in (self.classes or ())
        }
        self._class_counters: dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def count_class(self, name: str, priority: str | None, n: int = 1) -> None:
        """Per-class counter (a no-op unless class tracking is on)."""
        if self.classes is None or priority is None:
            return
        key = f"{name}_{priority}"
        self._class_counters[key] = self._class_counters.get(key, 0) + n

    # -- engine observation hooks ---------------------------------------

    def observe_step(self, *, queue_depth: int, occupied: int,
                     slots: int) -> None:
        self.count("steps")
        self.queue_depth.record(float(queue_depth))
        self.slot_occupancy.record(occupied / max(1, slots))

    def observe_first_token(self, ttft_ms: float, *, resumed: bool = False,
                            priority: str | None = None) -> None:
        (self.resumed_ttft_ms if resumed else self.ttft_ms).record(ttft_ms)
        if not resumed and self.classes is not None and priority is not None:
            hist = self._class_ttft.get(priority)
            if hist is not None:
                hist.record(ttft_ms)

    def observe_finished(self, *, ttft_ms: float, e2e_ms: float,
                         tpot_ms: float | None, n_tokens: int,
                         priority: str | None = None,
                         deadline_ok: bool | None = None) -> bool:
        """Score one finished request. Returns whether its tokens counted
        toward goodput (every set SLO dimension attained AND the deadline
        — when one was carried — met)."""
        self.count("finished")
        self.count_class("finished", priority)
        self.tokens_generated += int(n_tokens)
        self.e2e_ms.record(e2e_ms)
        if tpot_ms is not None:
            self.tpot_ms.record(tpot_ms)
        attained = None
        if self.slo is not None:
            self._slo_total += 1
            got = {"ttft_ms": ttft_ms, "e2e_ms": e2e_ms, "tpot_ms": tpot_ms}
            ok = True
            for dim, target in self.slo.as_dict().items():
                dim_ok = got[dim] is not None and got[dim] <= target
                if dim_ok:
                    self._slo_ok_by[dim] += 1
                ok = ok and dim_ok
            if ok:
                self._slo_ok += 1
            attained = ok
        goodput_ok = attained is not False and deadline_ok is not False
        if goodput_ok:
            self.tokens_goodput += int(n_tokens)
        return goodput_ok

    # -- readout --------------------------------------------------------

    def slo_attainment(self) -> dict | None:
        if self.slo is None:
            return None
        total = max(1, self._slo_total)
        out: dict[str, Any] = {
            "targets": self.slo.as_dict(),
            "scored": self._slo_total,
            "attained": round(self._slo_ok / total, 6),
        }
        for dim in self.slo.as_dict():
            out[f"attained_{dim}"] = round(self._slo_ok_by[dim] / total, 6)
        return out

    def snapshot(self) -> dict:
        """One JSON-able view (the health.snapshot() analogue). The engine
        layers its world/clock facts on top (``ServingEngine.snapshot``)."""
        snap = {
            "requests": dict(sorted(self.counters.items())),
            "tokens": {
                "generated": self.tokens_generated,
                "goodput": self.tokens_goodput,
            },
            "latency_ms": {
                "ttft": self.ttft_ms.snapshot(),
                "resumed_ttft": self.resumed_ttft_ms.snapshot(),
                "tpot": self.tpot_ms.snapshot(),
                "e2e": self.e2e_ms.snapshot(),
            },
            "load": {
                "queue_depth": self.queue_depth.snapshot(),
                "slot_occupancy": self.slot_occupancy.snapshot(),
            },
            "slo": self.slo_attainment(),
        }
        if self.classes is not None:
            snap["by_class"] = {
                "counters": dict(sorted(self._class_counters.items())),
                "ttft_ms": {
                    c: h.snapshot()
                    for c, h in sorted(self._class_ttft.items())
                },
            }
        return snap
