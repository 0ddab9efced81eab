"""K35 · ring attention, the sequence-parallel attention of long-context
training (≙ ``triton_dist_tpu/ops/ring_attention.py``: ``ring_attention``
at ``:245``, its Pallas site ``:289`` with the body ``_ring_attention_kernel``
at ``:145``; the host entry ``ring_attention_op`` at ``:329``).

Each rank holds ``[b, h, s_loc, d]`` rows of q, k and v. q stays put; the
(k, v) chunks travel right around the ring: at step ``s`` rank ``me`` holds
the chunk of rank ``(me - s) mod n``, forwards it, and attends its own q
against it, carrying the online softmax ``(m, l, acc)`` in f32 across the
steps. The causal mask compares global positions, so the layout decides
which rows a rank owns: ``"contig"`` rank r the rows ``[r s_loc, (r+1)
s_loc)``, ``"zigzag"`` the stripes r and 2n-1-r of ``s_loc / 2`` rows each
(the causal-load-balanced layout; permute the global sequence with
:func:`zigzag_permutation` first).

:func:`ring_attention` launches ``csrc/ring_attention.cu`` for tensors on
the card and runs its plain twin :func:`_ring_attention_plain` (the
ring-order blockwise online softmax, one chunk a step, after a host
gather of every rank's (k, v)) for tensors on the CPU. On the card
:func:`_ring_attention_engine` picks the kernel: bf16 with a head dim
TMA can load runs the warp-specialised ``wgmma`` + TMA engine
(``tdt_ring_attention_sm90``), other bf16 the mma.sync one, f32 the FMA
one. There is no fallback: a kernel that does not build or launch raises.
The TPU tile sizes of :class:`RingAttentionConfig` have no counterpart on
the card (the kernels fix their own tiles) and are carried for the
mapping.

On the card at world > 1 the wrapper follows the ring kernels' world-4
rules (``ops/common.py`` ``ring_launch``): every allocation first, then
the ranks meet on the host, then only the launch, then they meet again.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.common import (
    _WAIT,
    max_consumer_blocks,
    ring_launch,
    stream_ptr,
)
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE
from triton_dist_tpu_torch.utils import (
    axis_index,
    axis_size,
    count_call,
    count_launch,
    sm_count,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "tdt_ring_attention": [_P] * 10 + [_I] * 6 + [ctypes.c_float] + [_I, _I] + [_P] * 5
    + [_I] * 3 + _WAIT,
    "tdt_ring_attention_sm90": [_P] * 10 + [_I] * 5 + [ctypes.c_float] + [_I, _I] + [_P] * 5
    + [_I] * 3 + _WAIT,
}
LAYOUTS = ("contig", "zigzag")
# the head dims the card takes: bf16 on the tensor cores, f32 on the FMA tile
MAX_HEAD_DIM = {torch.bfloat16: 128, torch.float32: 256}
ENGINES = ("wgmma", "mma", "fma")


@dataclasses.dataclass(frozen=True)
class RingAttentionConfig:
    """The JAX package's config (``:41``), field for field: the TPU's q and
    kv tile rows, carried for the mapping only."""

    block_q: int = 512
    block_kv: int = 512


def zigzag_permutation(n: int, s_tot: int):
    """Row permutation taking the natural sequence order to the zigzag
    sharding order (≙ ``zigzag_permutation``, ``:211``): after ``x[perm]``
    contiguous shard r of n holds stripes r and 2n-1-r, each ``s_tot / 2n``
    rows. Returns ``(perm, inverse)`` int32 numpy arrays."""
    if s_tot % (2 * n) != 0:
        raise ValueError(f"zigzag needs s_tot divisible by 2*n: {s_tot} % {2 * n} != 0")
    s_half = s_tot // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * s_half, (r + 1) * s_half))
        order.extend(range((2 * n - 1 - r) * s_half, (2 * n - r) * s_half))
    perm = np.asarray(order, np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv


def zigzag_positions(me: int, n: int, s_loc: int, device=None) -> torch.Tensor:
    """Global positions of rank `me`'s local rows under the zigzag layout
    (≙ ``zigzag_positions``, ``:233``), int32 ``[s_loc]``."""
    s_half = s_loc // 2
    r = torch.arange(s_loc, dtype=torch.int32, device=device)
    return torch.where(r < s_half, me * s_half + r, (2 * n - 1 - me) * s_half + (r - s_half))


def positions(me: int, n: int, s_loc: int, layout: str, device=None) -> torch.Tensor:
    """Global positions of rank `me`'s local rows under `layout`, int32."""
    if layout == "zigzag":
        return zigzag_positions(me, n, s_loc, device)
    return me * s_loc + torch.arange(s_loc, dtype=torch.int32, device=device)


def check_layout(layout: str, s_loc: int) -> None:
    """The layout errors of the reference (``:279-282``)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag" and s_loc % 2 != 0:
        raise ValueError(f"zigzag needs an even s_loc, got {s_loc}")


def _ring_attention_plain(q3, k3, v3, ctx, causal: bool, layout: str):
    """Plain version of K35: every rank's (k, v) gathered on the host, then
    the chunks in the ring's order ``(me - s) mod n``, one online-softmax
    step a chunk in f32, as the TPU kernel steps (its q pre-scaled, a fully
    masked row's shift pinned finite). Returns ``(out in q's dtype, m, l)``,
    ``m`` and ``l`` f32 ``[bh, s_loc]``."""
    count_call(_ring_attention_plain)
    n, me = axis_size(ctx), axis_index(ctx)
    bh, s_loc, d = q3.shape
    kv = torch.stack([k3, v3])
    kv_all = kv[None] if n == 1 else ctx.all_gather(kv[None].contiguous(), 0)
    qs = q3.float() * (1.0 / math.sqrt(d))
    rows = positions(me, n, s_loc, layout, q3.device).long()
    m = torch.full((bh, s_loc), float("-inf"), device=q3.device)
    l = torch.zeros((bh, s_loc), device=q3.device)
    acc = torch.zeros((bh, s_loc, d), device=q3.device)
    for s in range(n):
        c = (me - s) % n
        k_c, v_c = kv_all[c, 0].float(), kv_all[c, 1].float()
        sc = qs @ k_c.transpose(1, 2)                       # [bh, s_loc, s_loc]
        if causal:
            cols = positions(c, n, s_loc, layout, q3.device).long()
            sc = sc.masked_fill(~(cols[None, :] <= rows[:, None])[None], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        finite = torch.isfinite(m_new)
        shift = torch.where(finite, m_new, 0.0)
        alpha = torch.exp(m - shift)
        p = torch.exp(sc - shift[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ v_c
        m = torch.where(finite, m_new, m)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q3.dtype)
    return out, m, l


_ring_attention_plain.calls = 0


def _ring_attention_engine(dtype: torch.dtype, d: int, aligned: bool,
                           forced: str | None = None) -> str:
    """Which kernel runs K35 on the card: ``"wgmma"`` (the warp-specialised
    ``wgmma`` + TMA engine, ``ring_attention_sm90_kernel``) for bf16 with d
    a multiple of 8 and at most 128 and 16-byte aligned q, k, v (and landing
    buffers); ``"mma"`` (the mma.sync engine) for every other bf16 operand;
    ``"fma"`` for f32. `forced` (one of :data:`ENGINES`) overrides the
    choice and raises where that engine cannot take the operands."""
    if dtype == torch.float32:
        engine = "fma"
    else:
        ok = (dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_HEAD_DIM[torch.bfloat16]
              and aligned)
        engine = "wgmma" if ok else "mma"
    if forced is None or forced == engine:
        return engine
    if forced != "mma" or engine != "wgmma":
        raise ValueError(f"ring_attention: no {forced} engine for {dtype}, d {d} "
                         f"(aligned={aligned})")
    return forced


def lse_of(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The per-row log-sum-exp the backward takes (``:321-324``)."""
    return m + torch.log(torch.clamp(l, min=1e-30))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ctx=None,
    causal: bool = True,
    config: RingAttentionConfig | None = None,
    layout: str = "contig",
    return_lse: bool = False,
    _engine: str | None = None,
):
    """Sequence-parallel attention over this rank's shard (call inside
    ``ctx.run``; ``ctx=None`` is world 1). q, k, v ``[b, h, s_loc, d]``
    (MHA: repeat GQA's kv heads first), bf16 or f32 → ``[b, h, s_loc, d]``
    in q's dtype, and with `return_lse` the per-row log-sum-exp ``[b, h,
    s_loc]`` f32 that the backward consumes. The golden is full (causal)
    attention over the gathered sequence.

    On the card every launch counts on ``launches``, the ``wgmma`` engine's
    also on ``wgmma_launches``. ``_engine`` (one of :data:`ENGINES`) forces
    a kernel (the chip script's A/B; never the main path); a forced engine
    that cannot take the operands raises."""
    del config
    b, h, s_loc, d = q.shape
    check_layout(layout, s_loc)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be one shape")
    q3, k3, v3 = (x.reshape(b * h, s_loc, d) for x in (q, k, v))
    if q.device.type == "cpu":
        out, m, l = _ring_attention_plain(q3, k3, v3, ctx, causal, layout)
        lse = lse_of(m, l)
    else:
        out, lse = _ring_attention_cuda(q3, k3, v3, ctx, causal, layout, _engine)
    out = out.reshape(b, h, s_loc, d)
    return (out, lse.reshape(b, h, s_loc)) if return_lse else out


ring_attention.launches = 0
ring_attention.wgmma_launches = 0  # K35 on the wgmma + TMA engine


def _ring_attention_cuda(q3, k3, v3, ctx, causal, layout, forced=None):
    """K35 on this rank's stream: at world 1 one launch, no flags; at world
    > 1 every allocation (the landing buffer, the state, the flags), the
    ranks meet, the launch, the ranks meet again."""
    dtype = q3.dtype
    if dtype not in MAX_HEAD_DIM or k3.dtype != dtype or v3.dtype != dtype:
        raise TypeError(f"ring_attention takes bf16 or f32 q, k, v of one type on the card, "
                        f"not {q3.dtype}, {k3.dtype}, {v3.dtype}")
    bh, s_loc, d = q3.shape
    if d > MAX_HEAD_DIM[dtype]:
        raise ValueError(f"ring_attention: head_dim {d} > {MAX_HEAD_DIM[dtype]} for {dtype} "
                         f"on the card")
    if any(x.device != q3.device for x in (k3, v3)):
        raise ValueError("ring_attention: q, k, v must be on one device")
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    n, me = axis_size(ctx), axis_index(ctx)
    lib = _build.library("ring_attention", _PROTOTYPES)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, s_loc), dtype=torch.float32, device=q3.device)
    land = None
    if n > 1:
        chunk = bh * s_loc * d * q3.element_size()
        land = ctx.symmetric("ring_attention.land", (n - 1) * 2 * chunk)
    ptrs = [x.data_ptr() for x in (q3, k3, v3)]
    if land is not None:
        ptrs += [land.peer_addr(me), land.peer_addr((me + 1) % n)]
    engine = _ring_attention_engine(dtype, d, all(p % 16 == 0 for p in ptrs), forced)
    geo = (bh, s_loc, d, DTYPE_CODE[dtype], int(causal), int(layout == "zigzag"),
           1.0 / math.sqrt(d))

    def launch_kernel(state, land_ptrs, flags, epoch, blocks, jitter, wait, stream):
        if engine == "wgmma":
            rc = lib.tdt_ring_attention_sm90(
                q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *state, *land_ptrs, *geo[:3], *geo[4:], n, me, *flags, epoch, blocks, jitter,
                *wait, stream)
            _build.check(lib, rc, "ring_attention (wgmma)")
            count_launch(ring_attention, "wgmma_launches")
        else:
            rc = lib.tdt_ring_attention(
                q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *state, *land_ptrs, *geo, n, me, *flags, epoch, blocks, jitter, *wait, stream)
            _build.check(lib, rc, "ring_attention")
        count_launch(ring_attention)

    if n == 1:
        # the wgmma engine's grid is persistent (one block an SM); the others
        # launch one block a tile at world 1
        launch_kernel((None, None, None), (None, None), (None,) * 5, 0,
                      sm_count(q3.get_device()), 0, (None, 0, 0), _build.stream_of(q3))
        return out, lse
    m_st = torch.empty((bh, s_loc), dtype=torch.float32, device=q3.device)
    l_st = torch.empty_like(m_st)
    acc_st = torch.empty((bh, s_loc, d), dtype=torch.float32, device=q3.device)
    ring = ring_launch(ctx, "ring_attention", ((0, 1),))
    launch = ring.launch
    ctx.rendezvous()  # every rank's buffers and flags exist before any kernel stores
    launch_kernel((m_st.data_ptr(), l_st.data_ptr(), acc_st.data_ptr()),
                  (land.peer_addr(me), land.peer_addr(ring.right)), ring.flags, launch.epoch,
                  max_consumer_blocks(ctx), launch.jitter, launch.wait,
                  stream_ptr(torch.cuda.current_stream()))
    ctx.rendezvous()  # every rank's kernel is issued before any rank goes on
    return out, lse


def ring_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    ctx=None,
    causal: bool = True,
    config: RingAttentionConfig | None = None,
    layout: str = "contig",
) -> torch.Tensor:
    """Host-level entry (≙ ``ring_attention_op``, ``:329``): q, k, v ``[b,
    h, S, d]`` over the whole sequence (pre-permuted with
    :func:`zigzag_permutation` under ``layout="zigzag"``); rank r takes rows
    ``[r S/n, (r+1) S/n)`` (on its device), and the ranks' outputs come
    back concatenated along the sequence on q's device."""
    n = axis_size(ctx)
    if q.shape[2] % n:
        raise ValueError(f"ring_attention_op: S={q.shape[2]} over {n} ranks")
    if n == 1:
        return ring_attention(q, k, v, causal=causal, config=config, layout=layout)
    s_loc = q.shape[2] // n

    def body():
        r, dev = ctx.rank, ctx.rank_device
        part = [x[:, :, r * s_loc:(r + 1) * s_loc].to(dev) for x in (q, k, v)]
        return ring_attention(*part, ctx=ctx, causal=causal, config=config, layout=layout)

    return torch.cat([o.to(q.device) for o in ctx.run(body)], 2)
