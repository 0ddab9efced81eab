"""Host-side symmetric memory (≙ ``triton_dist_tpu/shmem/host.py``).

A symmetric buffer is one allocation of the same size per rank plus, on
each rank's device, an ``int64[world]`` table of the ranks' base
addresses: the peer-pointer table the kernels of ``csrc/dist.cu`` index to
reach a peer's buffer. With every rank on one card the addresses are plain
device pointers; across cards they are UVA pointers into the peer's memory
(peer access is enabled by the runtime). The runtime
(:meth:`~triton_dist_tpu_torch.parallel.mesh.DistContext.symmetric`) owns
the buffers and grows them collectively.
"""

from __future__ import annotations

import contextlib

import torch


class SymmetricTensor:
    """`nbytes` zeroed bytes on every rank's device, and each device's
    peer table (``table[r]`` lives on rank ``r``'s device)."""

    def __init__(self, devices, nbytes: int):
        self.nbytes = int(nbytes)
        self.buffers = []
        for d in devices:
            # the device's default stream owns the allocation: the buffer
            # outlives every rank stream's use of it
            with (torch.cuda.stream(torch.cuda.default_stream(d)) if d.type == "cuda"
                  else contextlib.nullcontext()):
                self.buffers.append(torch.zeros(max(self.nbytes, 16), dtype=torch.uint8, device=d))
        self.ptrs = [b.data_ptr() for b in self.buffers]
        self.table = [torch.tensor(self.ptrs, dtype=torch.int64, device=d) for d in devices]
        if devices[0].type == "cuda":
            for d in {d for d in devices}:
                torch.cuda.synchronize(d)

    def view(self, rank: int, shape, dtype: torch.dtype, offset: int = 0) -> torch.Tensor:
        """Rank `rank`'s buffer as a contiguous `shape` tensor of `dtype`
        starting `offset` bytes in."""
        n = 1
        for s in shape:
            n *= int(s)
        size = n * torch.empty((), dtype=dtype).element_size()
        if offset + size > self.nbytes:
            raise ValueError(f"symmetric view of {size} bytes at {offset} exceeds {self.nbytes}")
        return self.buffers[rank][offset:offset + size].view(dtype).view(tuple(shape))

    def peer_addr(self, rank: int, offset: int = 0) -> int:
        return self.ptrs[rank] + offset


def create_symmetric_tensor(ctx, shape, dtype: torch.dtype = torch.float32, name=None):
    """A symmetric tensor of `shape` per rank (≙ ``create_symmetric_tensor``,
    ``:32``): returns the runtime's buffer `name` (grown to fit) — call
    inside ``ctx.run`` on every rank; ``.view(rank, shape, dtype)`` is a
    rank's tensor."""
    n = 1
    for s in shape:
        n *= int(s)
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    return ctx.symmetric(name or f"symmetric{tuple(shape)}{dtype}", nbytes)
