"""Device resolution for the port's entry points.

The JAX package's ``config.py`` holds interpret-mode and watchdog knobs;
CUDA has no interpret mode, so the only decision left is where an entry
point runs: on the card unless the caller explicitly asks for the CPU.
"""

from __future__ import annotations

import torch


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
