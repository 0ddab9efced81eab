"""K2/K3 · GQA flash decode over a contiguous or paged KV cache (≙
``triton_dist_tpu/ops/flash_decode.py``).

Layouts are the JAX package's: q ``[b, hq, d]`` (one decode token per
sequence), contiguous k/v ``[b, h_kv, s, d]`` or page pools ``[n_pages,
h_kv, page, d]`` with ``block_table [b, max_pages]`` int32, valid prefix
``kv_lens [b]`` int32. Results are ``out f32 [b, hq, d]`` and, with
``return_lse``, ``lse f32 [b, hq]``.

:func:`flash_decode` and :func:`paged_flash_decode` launch
``csrc/flash_decode.cu`` (split-KV, see its source note) for tensors on
the card and run their plain twins :func:`_xla_decode` and
:func:`_xla_paged_decode` for tensors on the CPU. The SP entries
(``*_distributed``) are world-1: the all-gather combine of the JAX
package returns the local result at world 1 (``flash_decode.py:1903``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.utils import cdiv

NEG_INF = float("-inf")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64       # positions per online-softmax step (csrc TILE)
_MAX_G = 16      # query heads per kv head (csrc MAX_G)
_MAX_D = 256     # padded head dim (csrc: two columns per thread of 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PROTOTYPES = {
    "tdt_flash_decode": [_P] * 8 + [_I] * 9 + [_F, _F, _P],
    "tdt_paged_flash_decode": [_P] * 9 + [_I] * 10 + [_F, _F, _P],
}


@dataclasses.dataclass(frozen=True)
class FlashDecodeConfig:
    """Decode knobs, kept for signature parity with the JAX package.

    ``block_s`` and ``fuse_heads`` choose the TPU kernel's chunking and
    grid (per-head or with the kv-head loop inside the body); the CUDA
    kernel reads each K/V row once for all heads of its group on a
    split-KV grid of its own, so it accepts both and needs neither.
    ``soft_cap`` (> 0) squashes the scaled scores through ``soft_cap *
    tanh(s / soft_cap)`` before the length mask, on every path."""

    block_s: int = 2048
    fuse_heads: bool = False
    soft_cap: float = 0.0


def _kernel_head_dim(d: int) -> int:
    """The head dim the kernels run at: ``d`` rounded up to a power of two
    (the TPU kernels zero-pad q/k/v to it; the CUDA kernel zero-pads its
    shared-memory rows to it and masks the true ``d``). ``scale`` always
    uses the true head dim."""
    if d < 1:
        raise ValueError(f"head dim must be >= 1, got {d}")
    p = 1
    while p < d:
        p <<= 1
    return p


def _xla_decode(q, k, v, kv_lens, *, return_lse, soft_cap=0.0):
    """Plain version of the decode (the JAX package's XLA-native twin of its
    Pallas kernel): masked softmax attention with f32 scores and
    probabilities, any head dim."""
    _xla_decode.calls += 1
    b, hq, d = q.shape
    _, h_kv, s_len, _ = k.shape
    g = hq // h_kv
    q4 = q.reshape(b, h_kv, g, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", q4, k.float()) / math.sqrt(d)
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    span = torch.arange(s_len, device=q.device)
    valid = span[None, None, None, :] < kv_lens.long()[:, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=-1e30)  # kv_len == 0 rows: avoid inf - inf
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    out = (out / torch.clamp(l, min=1e-30)).reshape(b, hq, d)
    out = torch.where(l.reshape(b, hq, 1) > 0, out, 0.0)
    if not return_lse:
        return out
    lse = (m_safe + torch.log(torch.clamp(l, min=1e-30))).reshape(b, hq)
    lse = torch.where(l.reshape(b, hq) > 0, lse, NEG_INF)
    return out, lse


_xla_decode.calls = 0


def _paged_to_contiguous(pages, block_table):
    """``[n_pages, h_kv, page, d]`` + ``[b, max_pages]`` →
    ``[b, h_kv, max_pages * page, d]`` by gathering each sequence's pages."""
    b, max_pages = block_table.shape
    x = pages[block_table.long()]  # [b, max_pages, h_kv, page, d]
    _, _, h_kv, page, d = x.shape
    return x.transpose(1, 2).reshape(b, h_kv, max_pages * page, d)


def _xla_paged_decode(q, k_pages, v_pages, kv_lens, block_table, *,
                      return_lse=False, soft_cap=0.0):
    """Plain version of the paged decode: gather the pages back into a
    contiguous cache, then :func:`_xla_decode`."""
    return _xla_decode(
        q, _paged_to_contiguous(k_pages, block_table),
        _paged_to_contiguous(v_pages, block_table),
        kv_lens, return_lse=return_lse, soft_cap=soft_cap,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_plan(device: torch.device, blocks: int, s_len: int) -> tuple[int, int]:
    """(splits, chunk): KV spans per (sequence, kv head) so the grid holds
    about four blocks per SM, each span a whole number of softmax tiles."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    splits = max(1, min(cdiv(4 * sms, blocks), cdiv(s_len, _TILE)))
    chunk = cdiv(cdiv(s_len, splits), _TILE) * _TILE
    return cdiv(s_len, chunk), chunk


def _check_operands(q, k, v, kv_lens, block_table=None):
    tensors = [q, k, v, kv_lens] + ([] if block_table is None else [block_table])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash decode operands must share one CUDA device")
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"flash decode takes a bf16 or f32 cache, got {k.dtype}/{v.dtype}")
    if kv_lens.dtype != torch.int32 or (
        block_table is not None and block_table.dtype != torch.int32
    ):
        raise TypeError("kv_lens and block_table are int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash decode takes contiguous operands")
    b, hq, d = q.shape
    h_kv = k.shape[1]
    if hq % h_kv or hq // h_kv > _MAX_G or _kernel_head_dim(d) > _MAX_D:
        raise ValueError(
            f"flash decode kernel takes hq/h_kv <= {_MAX_G} whole groups and "
            f"head dim <= {_MAX_D}; got hq={hq}, h_kv={h_kv}, d={d}"
        )


def _launch_decode(q, k, v, kv_lens, block_table, soft_cap):
    """Launch the split-KV kernel and its merge; returns (out, lse)."""
    b, hq, d = q.shape
    h_kv = k.shape[1]
    q = q.to(k.dtype).contiguous()  # the kernel reads q in the cache dtype
    _check_operands(q, k, v, kv_lens, block_table)
    if block_table is None:
        s_len = k.shape[2]
    else:
        page, max_pages = k.shape[2], block_table.shape[1]
        s_len = page * max_pages
    splits, chunk = _split_plan(q.device, b * h_kv, s_len)
    f32 = dict(dtype=torch.float32, device=q.device)
    out_part = torch.empty((splits, b, hq, d), **f32)
    lse_part = torch.empty((splits, b, hq), **f32)
    out = torch.empty((b, hq, d), **f32)
    lse = torch.empty((b, hq), **f32)
    # shared-memory rows: the padded head dim, at least one 16-byte chunk
    dp = max(_kernel_head_dim(d), 16 // k.element_size())
    common = (
        out_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[k.dtype], b, hq, h_kv, d, dp,
    )
    tail = (splits, chunk, 1.0 / math.sqrt(d), float(soft_cap), _build.stream_of(q))
    lib = _build.library("flash_decode", _PROTOTYPES)
    if block_table is None:
        rc = lib.tdt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
            *common, s_len, *tail,
        )
        _build.check(lib, rc, "flash_decode")
    else:
        rc = lib.tdt_paged_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
            block_table.data_ptr(), *common, page, max_pages, *tail,
        )
        _build.check(lib, rc, "paged_flash_decode")
    return out, lse


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    config: FlashDecodeConfig | None = None,
    return_lse: bool = False,
):
    """Single-device GQA batch decode over a contiguous cache (K2).
    q ``[b, hq, d]``; k, v ``[b, h_kv, s, d]``; kv_lens ``[b]`` int32.
    Returns f32 ``out [b, hq, d]`` (and ``lse [b, hq]`` if `return_lse`)."""
    soft_cap = (config or FlashDecodeConfig()).soft_cap
    if q.device.type == "cpu":
        return _xla_decode(q, k, v, kv_lens, return_lse=return_lse, soft_cap=soft_cap)
    out, lse = _launch_decode(q, k, v, kv_lens, None, soft_cap)
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0


def paged_flash_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    block_table: torch.Tensor,
    *,
    fuse_heads: bool | None = None,
    pages_per_step: int | None = None,
    soft_cap: float = 0.0,
    return_lse: bool = False,
):
    """Single-device GQA batch decode over a paged cache (K3): k_pages,
    v_pages ``[n_pages, h_kv, page, d]``; block_table ``[b, max_pages]``
    int32 physical page ids (entries past the valid length may be any
    in-range value — the kernel reads only pages below ``ceil(kv_len /
    page)``). ``fuse_heads`` and ``pages_per_step`` pick the TPU kernel's
    grid and per-step span; the CUDA kernel accepts and needs neither."""
    del fuse_heads, pages_per_step
    if q.device.type == "cpu":
        return _xla_paged_decode(
            q, k_pages, v_pages, kv_lens, block_table,
            return_lse=return_lse, soft_cap=soft_cap,
        )
    out, lse = _launch_decode(q, k_pages, v_pages, kv_lens, block_table, soft_cap)
    paged_flash_decode.launches += 1
    return (out, lse) if return_lse else out


paged_flash_decode.launches = 0


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Numerically stable merge of partial attention results — the algebra
    the kernel's second pass applies to its KV spans, and the SP merge of
    per-rank partials. outs ``[n, b, hq, d]``, lses ``[n, b, hq]`` →
    ``[b, hq, d]``; partials with ``lse = -inf`` weigh 0."""
    m = lses.amax(dim=0)
    w = torch.where(
        torch.isfinite(lses), torch.exp(lses - torch.clamp(m, min=-1e30)), 0.0
    )
    denom = torch.clamp(w.sum(dim=0), min=1e-30)
    return torch.einsum("nbh,nbhd->bhd", w, outs) / denom[..., None]


def _world_one(world: int) -> None:
    if world != 1:
        raise NotImplementedError(
            "sequence-parallel decode at world > 1 needs the (out, lse) "
            "all-gather (ROADMAP A3); this port runs world 1 only"
        )


def flash_decode_distributed(
    q, k_shard, v_shard, kv_lens_shard, *,
    config: FlashDecodeConfig | None = None, world: int = 1,
):
    """SP decode over a sequence-sharded contiguous cache. At world 1 the
    shard is the whole cache and the merge is the identity."""
    _world_one(world)
    return flash_decode(q, k_shard, v_shard, kv_lens_shard, config=config)


def paged_flash_decode_distributed(
    q, k_pages, v_pages, kv_lens_shard, block_table, *,
    fuse_heads: bool | None = None, pages_per_step: int | None = None,
    soft_cap: float = 0.0, world: int = 1,
):
    """SP decode over a paged, sequence-sharded cache (world 1)."""
    _world_one(world)
    return paged_flash_decode(
        q, k_pages, v_pages, kv_lens_shard, block_table,
        fuse_heads=fuse_heads, pages_per_step=pages_per_step,
        soft_cap=soft_cap,
    )
