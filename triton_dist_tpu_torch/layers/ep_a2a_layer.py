"""The expert-parallel dispatch and combine (≙ ``triton_dist_tpu/layers/
ep_a2a_layer.py``: ``EPAll2AllLayer`` at ``:116``, ``DispatchInfo`` at
``:104``, the wire quantizer ``:41-100`` and ``_align_received`` at
``:580``).

Expert placement: each rank holds ``n_experts / world`` whole experts;
expert ``e`` lives on rank ``e // epr`` as local expert ``e % epr``. Every
(token, k) assignment travels to its expert's rank over the padded-slab
all-to-all (``ops/all_to_all.py``, K27/K28 on the card) with its local
expert id on the payload; the combine is the same exchange in reverse,
then the top-k weighted sum back into token order. The routing bookkeeping
(sort by destination, slab slots, the un-permutation) is plain PyTorch, as
the JAX package leaves it to XLA, with no host sync: a dropped assignment
(slab overflow) lands in a scratch row instead of being masked out.

``quant="int8"`` / ``"fp8"`` sends the dispatch slab in one byte a value
with per-row absmax scales bitcast onto the payload: serving only, since
the rounding has no gradient; the combine stays in the token dtype.

``HierEPAll2AllLayer`` (the two-phase dispatch over an (outer, inner)
mesh) needs the 2-D rank runtime of ROADMAP A5 and refuses.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.all_to_all import A2AConfig, fast_all_to_all
from triton_dist_tpu_torch.ops.grads import fast_all_to_all_grad
from triton_dist_tpu_torch.ops.group_gemm import FP8_DTYPE
from triton_dist_tpu_torch.ops.moe_utils import MoEAlignment, moe_align_block_size
from triton_dist_tpu_torch.utils import axis_size

# the one-byte dispatch wire formats: (dtype, the absmax's image)
_QUANT_FORMATS = {"int8": (torch.int8, 127.0), "fp8": (FP8_DTYPE, 448.0)}


def _check_quant(quant) -> None:
    if quant is not None and quant not in _QUANT_FORMATS:
        raise ValueError(f"quant must be one of {sorted(_QUANT_FORMATS)} or None, got {quant!r}")


def _quantize_rows(send: torch.Tensor, quant: str):
    """Per-row absmax quantization of a send slab ``[n, max_m, h]`` →
    ``(slab_q, scale [n, max_m] f32)`` (≙ ``_quantize_rows``, bit for bit
    as the JAX dispatch computes it under ``jit``, where XLA turns the
    division by the constant ``qmax`` into a product with its f32
    reciprocal; the row-scale division stays a true division). Both
    operands are tensors, so the card rounds as the CPU does (PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal).
    All-zero (padding) rows get the scale 1e-8 and quantize to exact
    zeros."""
    qdt, qmax = _QUANT_FORMATS[quant]
    xf = send.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax * amax.new_full((), 1.0 / qmax), min=1e-8)
    q = xf / scale[..., None]
    if quant == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdt), scale


def _dequantize_rows(recv_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of :func:`_quantize_rows`."""
    return (recv_q.float() * scale[..., None]).to(dtype)


def _pack_slabs(dest: torch.Tensor, n_dest: int, max_m: int):
    """Sort-and-slot slab packing (≙ ``_pack_slabs``): stable-sort the
    assignments by destination, each one's position in its destination's
    slab, the counts clamped to the slab. Returns ``(order, slot, offsets,
    clamped, overflow)``: ``slot`` the flat slab row of each sorted
    assignment (``n_dest * max_m`` for one that does not fit), ``offsets``
    the unclamped group starts in the sorted order (what the combine
    indexes), ``clamped`` what ships."""
    t = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)
    dest_sorted = dest[order]
    counts = torch.zeros(n_dest + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, dest, torch.ones_like(dest))[:n_dest]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t, device=dev) - offsets[dest_sorted.clamp(0, n_dest - 1)]
    fits = (pos < max_m) & (dest_sorted < n_dest)
    slot = torch.where(fits, dest_sorted * max_m + pos, n_dest * max_m)
    clamped = torch.clamp(counts, max=max_m)
    return order, slot, offsets, clamped.to(torch.int32), (counts - clamped).sum()


def _scatter_slots(values: torch.Tensor, slot: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``values`` at their slab rows of a ``[rows, ...]`` buffer filled with
    `fill`; values whose slot is `rows` (dropped) land in a scratch row."""
    out = torch.full((rows + 1, *values.shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    out[slot] = values
    return out[:rows]


@dataclasses.dataclass(frozen=True)
class DispatchInfo:
    """What the combine needs to route results back (≙ ``DispatchInfo``)."""

    order: torch.Tensor         # [m_loc * topk] assignment ids sorted by destination
    send_splits: torch.Tensor   # [n] rows sent to each rank
    send_offsets: torch.Tensor  # [n] each destination's start in `order`
    recv_splits: torch.Tensor   # [n] rows received from each rank
    recv_expert: torch.Tensor   # [n, max_m] local expert of each received row
    overflow: torch.Tensor      # [] assignments dropped to slab overflow


@dataclasses.dataclass
class EPAll2AllLayer:
    """Dispatch tokens to their experts' ranks and combine the results back
    (≙ ``EPAll2AllLayer``; call inside ``ctx.run``). ``max_m`` is the
    per-(source, destination) slab capacity: assignments past it are
    dropped and counted in ``DispatchInfo.overflow``. ``quant`` the
    one-byte wire (serving only); ``a2a_config`` the transport schedule
    (``chunks_per_shard > 1``: K28)."""

    n_experts: int
    topk: int
    max_m: int
    ctx: object = None
    quant: str | None = None
    a2a_config: A2AConfig | None = None

    def _epr(self) -> int:
        n = axis_size(self.ctx)
        if self.n_experts % n != 0 or self.n_experts < n:
            raise ValueError(f"n_experts={self.n_experts} must be a positive multiple of the "
                             f"world {n}")
        return self.n_experts // n

    def dispatch(self, tokens: torch.Tensor, topk_ids: torch.Tensor):
        """Send each (token, k) assignment to the rank owning its expert.
        tokens ``[m_loc, hidden]``, topk_ids ``[m_loc, topk]`` global expert
        ids → ``(recv [n, max_m, hidden], info)``: slab ``j`` holds rank
        ``j``'s assignments for this rank (``info.recv_splits[j]`` valid),
        the local expert of each row in ``info.recv_expert``."""
        epr = self._epr()
        _check_quant(self.quant)
        n = axis_size(self.ctx)
        hidden = tokens.shape[1]
        flat_ids = topk_ids.reshape(-1).long()
        order, slot, offsets, clamped, overflow = _pack_slabs(flat_ids // epr, n, self.max_m)
        rows = n * self.max_m
        send = _scatter_slots(tokens[order // self.topk], slot, rows, 0).view(
            n, self.max_m, hidden)
        send_exp = _scatter_slots((flat_ids[order] % epr).to(torch.int32), slot, rows, -1).view(
            n, self.max_m)
        if self.quant is not None:
            # the one-byte slab; its f32 row scales ride the payload as bits
            send_q, scale = _quantize_rows(send, self.quant)
            meta = torch.cat([send_exp, scale.view(torch.int32)], dim=1)
            recv_q, recv_splits, meta_r = fast_all_to_all(
                send_q, clamped, meta=meta, ctx=self.ctx, config=self.a2a_config)
            recv_exp = meta_r[:, :self.max_m]
            r_scale = meta_r[:, self.max_m:].contiguous().view(torch.float32)
            recv = _dequantize_rows(recv_q, r_scale, tokens.dtype)
        else:
            recv, recv_splits, recv_exp = fast_all_to_all_grad(
                send, clamped, send_exp, ctx=self.ctx, config=self.a2a_config)
        info = DispatchInfo(order=order, send_splits=clamped, send_offsets=offsets,
                            recv_splits=recv_splits, recv_expert=recv_exp, overflow=overflow)
        return recv, info

    def receiver_alignment(self, info: DispatchInfo, block_m: int, *,
                           ragged: bool = False) -> MoEAlignment:
        """Block-align the received rows by local expert for the grouped
        GEMMs; padding rows go to a virtual trailing expert whose blocks
        compute on the clamped last expert, and the combine drops them.
        ``ragged`` adds the ``valid_rows`` map, with the virtual expert's
        blocks dead (0 live rows), so the ragged GEMMs skip them."""
        return _align_received(info.recv_expert, info.recv_splits, self.max_m, self._epr(),
                               block_m, ragged=ragged)

    def combine(self, y: torch.Tensor, info: DispatchInfo, topk_weights: torch.Tensor,
                m_loc: int) -> torch.Tensor:
        """Return the expert outputs ``y [n, max_m, h]`` (the received slab
        layout) to their source ranks and sum each token's top-k in f32:
        → ``[m_loc, h]`` f32."""
        n = axis_size(self.ctx)
        back, _, _ = fast_all_to_all_grad(y, info.recv_splits, ctx=self.ctx,
                                          config=self.a2a_config)
        h = y.shape[-1]
        idx = torch.arange(n * self.max_m, device=y.device)
        slab, pos = idx // self.max_m, idx % self.max_m
        valid = pos < info.send_splits[slab]
        # slab p row i is sorted assignment offsets[p] + i
        sorted_pos = torch.clamp(info.send_offsets[slab] + pos, 0, info.order.shape[0] - 1)
        assignment = info.order[sorted_pos]
        w = torch.where(valid, topk_weights.reshape(-1)[assignment].float(), 0.0)
        contrib = torch.where(valid[:, None], back.reshape(-1, h).float() * w[:, None], 0.0)
        out = torch.zeros((m_loc, h), dtype=torch.float32, device=y.device)
        return out.index_add_(0, assignment // self.topk, contrib)


class HierEPAll2AllLayer:
    """The two-phase dispatch over an (outer, inner) mesh (≙
    ``HierEPAll2AllLayer``, ``:306``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HierEPAll2AllLayer: hierarchical EP needs the 2-D DistContext (an outer and an "
            "inner axis) that the data-parallel axis brings (ROADMAP A5)")


def _align_received(recv_expert, recv_splits, max_m: int, epr: int, block_m: int,
                    ragged: bool = False) -> MoEAlignment:
    """Receiver-side block alignment (≙ ``_align_received``): the rows past
    a slab's count go to the virtual expert ``epr``, whose blocks keep the
    clamped id ``epr - 1``; with `ragged` their live rows are 0
    (``:597-600``)."""
    flat = recv_expert.reshape(-1)
    idx = torch.arange(flat.shape[0], device=flat.device)
    valid = idx % max_m < recv_splits.long()[idx // max_m]
    al = moe_align_block_size(torch.where(valid, flat, epr), epr + 1, block_m, ragged=ragged)
    valid_rows = None
    if ragged:
        valid_rows = torch.where(al.expert_ids >= epr, 0, al.valid_rows).to(torch.int32)
    return MoEAlignment(sorted_token_ids=al.sorted_token_ids,
                        expert_ids=torch.clamp(al.expert_ids, max=epr - 1),
                        num_tokens_post_pad=al.num_tokens_post_pad, valid_rows=valid_rows)
