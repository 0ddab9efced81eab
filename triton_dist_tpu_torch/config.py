"""Device resolution for the port's entry points, and the bounded-wait
timeout of its distributed kernels.

The JAX package's ``config.py`` holds interpret-mode and watchdog knobs;
CUDA has no interpret mode, so what is left is where an entry point runs
(on the card unless the caller explicitly asks for the CPU), how long a
device-side wait spins before it gives up with a record (≙
``config.timeout_iters``, counted here in seconds of ``%globaltimer``, not
poll iterations), and the race-shaking delay of the communicating kernels
(≙ ``config.debug_comm_delay``).
"""

from __future__ import annotations

import contextlib
import os

import torch

# How long one device-side wait (flag, barrier round) may spin before it
# writes a timeout record and returns. Generous: the ranks' host threads
# share one interpreter lock, so a peer may be many launches behind.
# TDT_TORCH_WAIT_TIMEOUT_S overrides it at import.
wait_timeout_s: float = float(os.environ.get("TDT_TORCH_WAIT_TIMEOUT_S", "60"))

# Race shaking (≙ the JAX package's ``debug_comm_delay``): > 0 makes every
# communicating kernel (csrc/dist.cu K5-K7 and K12, csrc/ring.cu K15-K23)
# spin a per-rank delay of base * (1 + (rank * 7919 + salt * 104729) mod 8)
# dependent integer steps at its top (shmem.cuh ``comm_jitter``), so the
# ranks issue their stores and waits at visibly different times. It moves
# timing only, never a result. Debug and stress only; TDT_COMM_DELAY sets it
# at import.
debug_comm_delay: int = int(os.environ.get("TDT_COMM_DELAY", "0"))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for (by
    default or by name) and there is none — the port never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "triton_dist_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return dev


def wait_timeout_ns() -> int:
    return int(wait_timeout_s * 1e9)


@contextlib.contextmanager
def wait_timeout(seconds: float):
    """Run a block with another device-wait timeout (tests of a stuck
    wait use a short one)."""
    global wait_timeout_s
    old, wait_timeout_s = wait_timeout_s, float(seconds)
    try:
        yield
    finally:
        wait_timeout_s = old


@contextlib.contextmanager
def comm_delay(base: int):
    """Run a block with another race-shaking delay (the jitter passes of
    the card tests and ``chip_smoke.py``)."""
    global debug_comm_delay
    old, debug_comm_delay = debug_comm_delay, int(base)
    try:
        yield
    finally:
        debug_comm_delay = old
