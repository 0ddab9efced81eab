"""The injectable clock (≙ the clock half of ``triton_dist_tpu/resilience/
retry.py``; the retry policy itself arrives with the resilience tier).

The serving engine reads its default clock from here, so wrapping a serve
in ``clock_scope(FakeClock())`` makes every lifecycle timestamp and latency
percentile deterministic: nothing sleeps, time advances only by what the
engine charges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any


class SystemClock:
    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


@dataclasses.dataclass
class FakeClock:
    """Deterministic test clock: ``sleep`` advances ``now`` and records the
    requested durations in ``sleeps``."""

    now: float = 0.0
    sleeps: list = dataclasses.field(default_factory=list)

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds
        self.sleeps.append(seconds)


_clock: Any = SystemClock()


def set_clock(clock: Any) -> Any:
    """Swap the module clock (None restores the system clock). Returns the
    previous clock so callers can restore it."""
    global _clock
    prev = _clock
    _clock = clock if clock is not None else SystemClock()
    return prev


def get_clock() -> Any:
    return _clock


@contextlib.contextmanager
def clock_scope(clock: Any):
    """Install ``clock`` for the scope, restore the previous one on exit."""
    prev = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(prev)
