"""K2/K3 · GQA flash decode and K13/K14 · multi-position verify over a
contiguous or paged KV cache (≙ ``triton_dist_tpu/ops/flash_decode.py``).

Layouts are the JAX package's: q ``[b, hq, d]`` (one decode token per
sequence), contiguous k/v ``[b, h_kv, s, d]`` or page pools ``[n_pages,
h_kv, page, d]`` with ``block_table [b, max_pages]`` int32, valid prefix
``kv_lens [b]`` int32. Results are ``out f32 [b, hq, d]`` and, with
``return_lse``, ``lse f32 [b, hq]``.

:func:`flash_decode` and :func:`paged_flash_decode` launch
``csrc/flash_decode.cu`` (a bf16 cache in one launch, other caches
split-KV, see its source note) for tensors on the card and run their plain
twins :func:`_xla_decode` and :func:`_xla_paged_decode` for tensors on the
CPU. The SP entries
(``*_distributed``) run the local partial decode on a rank's sequence
shard, then gather every rank's ``(out, lse)`` payload with the full-mesh
push allgather (K5, ``ops/allgather.py``) and merge them
(:func:`combine_partials`), as ``_sp_allgather_combine`` (``:1895``) does.

The verify family scores S query positions of each sequence in one pass
over the cache: q ``[b, S, hq, d]``, per-row prefix lengths ``kv_lens [b,
S]``, results ``out f32 [b, S, hq, d]`` and ``lse f32 [b, S, hq]``.
:func:`flash_verify` and :func:`paged_flash_verify` launch
``csrc/flash_verify.cu`` (K13, over a bf16 cache on a wgmma + TMA kernel;
K14) on the card and run
:func:`_xla_verify` / :func:`_xla_paged_verify` on the CPU. The ranged
prefill entries derive each row's prefix in the rank's shard from the
range's first position (:func:`_ranged_local_lens`), so composing
consecutive ranges gives every row the same mask as one whole-range pass.

Quantized caches (≙ ``:1211-1411``, ``:1766-1821``): :func:`quantize_kv`
and :func:`quantize_kv_fp8` (and their page-pool twins) store each cache
row as one byte a value (int8, or fp8 e4m3) with an f32 absmax scale a
(sequence or page, kv head, position), scales ``[b, h_kv, 1, s]`` or
``[n_pages, h_kv, 1, page]``. :func:`flash_decode_quant` (K38),
``paged_flash_decode(k_scales=, v_scales=)`` (K39) and
``flash_verify(scales=)`` (K40) read them: q rides bf16, the payload
rises to bf16 exactly, each score column is multiplied by ``k_scale[pos]
* scale`` and each probability by ``v_scale[pos]`` (rounded to bf16) before
P.V. Their plain versions (:func:`_plain_decode_quant`,
:func:`_plain_verify_quant`) do the same in one pass and run on the CPU;
there is no other fallback, as the reference has no golden slow path for
a quantized cache.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.utils import (
    axis_index, axis_size, cdiv, count_call, count_launch, sm_count,
)

NEG_INF = float("-inf")

# fp8 KV cache: the e4m3 variant with a finite max of 448, where the absmax
# maps (≙ ``FP8_KV_DTYPE``/``_FP8_KV_MAX``, ``:61-62``)
FP8_KV_DTYPE = torch.float8_e4m3fn
_FP8_KV_MAX = 448.0

# cache dtype codes of csrc/flash_decode.cu and csrc/flash_verify.cu (DType)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, FP8_KV_DTYPE: 3}
_QUANT_DTYPES = (torch.int8, FP8_KV_DTYPE)
_TILE = 64       # positions per online-softmax step (csrc TILE)
_MAX_G = 16      # query heads per kv head (csrc MAX_G)
_MAX_D = 256     # padded head dim (csrc: two columns per thread of 128)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PROTOTYPES = {
    "tdt_flash_decode": [_P] * 10 + [_I] * 9 + [_F, _F, _P],
    "tdt_paged_flash_decode": [_P] * 11 + [_I] * 10 + [_F, _F, _P],
    "tdt_paged_flash_decode_onepass": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
    "tdt_flash_decode_onepass": [_P] * 9 + [_I] * 7 + [_F, _F, _P],
}
_VERIFY_PROTOTYPES = {
    "tdt_flash_verify": [_P] * 8 + [_I] * 7 + [_F, _F, _P],
    "tdt_flash_verify_sm90": [_P] * 6 + [_I] * 6 + [_F, _F, _P],
    "tdt_paged_flash_verify": [_P] * 9 + [_I] * 8 + [_F, _F, _P],
}


@dataclasses.dataclass(frozen=True)
class FlashDecodeConfig:
    """Decode knobs, kept for signature parity with the JAX package.

    ``block_s`` and ``fuse_heads`` choose the TPU kernel's chunking and
    grid (per-head or with the kv-head loop inside the body); the CUDA
    kernel reads each K/V row once for all heads of its group on a
    split-KV grid of its own, so it accepts both and needs neither.
    ``soft_cap`` (> 0) squashes the scaled scores through ``soft_cap *
    tanh(s / soft_cap)`` before the length mask, on every path.

    The caches the kernels take: bf16 or f32 (q is cast to the cache's
    dtype), or one byte a value — int8 or fp8 e4m3 with f32 row scales —
    where q is cast to bf16 (the reference's contract: a quantized cache
    upcasts to bf16 in the kernel, so f32 queries lose precision there).
    ``block_s=0`` (the reference's XLA-native path) has no quantized form
    and is refused for a one-byte cache, as there."""

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
    count_call(_xla_decode)
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


def _quantize_rows(x: torch.Tensor, q_max: float):
    """Absmax rows over the head dim: ``(x / s[..., None], s)`` in f32, with
    ``s = max(absmax / q_max, 1e-8)`` over the leading dims. Both divisions
    are by tensors: PyTorch's CUDA division by a Python scalar multiplies by
    its rounded reciprocal, which would leave the card's scales an ulp off
    the CPU's (and the reference's, which divides exactly)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.clamp(amax / amax.new_full((), q_max), min=1e-8)
    return xf / s[..., None], s


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-(sequence, kv head, position) absmax int8 quantization of a KV
    cache ``[b, h_kv, s, d]`` (≙ ``quantize_kv``, ``:1211``): ``(k_q, v_q,
    k_scale, v_scale)``, int8 payloads and f32 scales ``[b, h_kv, 1, s]``;
    round half to even, clipped to ±127."""

    def q1(x):
        xs, s = _quantize_rows(x, 127.0)
        return torch.clamp(torch.round(xs), -127, 127).to(torch.int8), s[..., None, :]

    (k_q, k_s), (v_q, v_s) = q1(k), q1(v)
    return k_q, v_q, k_s, v_s


def quantize_kv_fp8(k: torch.Tensor, v: torch.Tensor):
    """fp8 e4m3 twin of :func:`quantize_kv` (≙ ``quantize_kv_fp8``,
    ``:1281``): 448 in 127's seat, clipped, the rounding left to the cast
    (nearest even)."""

    def q1(x):
        xs, s = _quantize_rows(x, _FP8_KV_MAX)
        return torch.clamp(xs, -_FP8_KV_MAX, _FP8_KV_MAX).to(FP8_KV_DTYPE), s[..., None, :]

    (k_q, k_s), (v_q, v_s) = q1(k), q1(v)
    return k_q, v_q, k_s, v_s


def quantize_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor):
    """:func:`quantize_kv` over a page pool ``[n_pages, h_kv, page, d]``
    (≙ ``:1766``): scales ``[n_pages, h_kv, 1, page]``."""
    return quantize_kv(k_pages, v_pages)


def quantize_kv_pages_fp8(k_pages: torch.Tensor, v_pages: torch.Tensor):
    """:func:`quantize_kv_fp8` over a page pool (≙ ``:1799``)."""
    return quantize_kv_fp8(k_pages, v_pages)


def _quant_softmax(s, v, vs, valid, soft_cap, spec):
    """The quantized contract of ``_online_softmax_step`` (``:195-239``) in
    one pass over scores ``s`` (already ``dot(q, k) * (k_scale * scale)``):
    soft cap, length mask, ``l`` over the unrounded probabilities, P.V on
    ``(p * v_scale)`` rounded to bf16 against the bf16 payload, f32 sums;
    then ``_finalize_softmax`` (``:242``). `spec` is the P.V einsum."""
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=-1e30)  # kv_len == 0 rows: avoid inf - inf
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(spec, (p * vs).to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    out = torch.where(l > 0, acc / torch.clamp(l, min=1e-30), 0.0)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def _plain_decode_quant(q, k, v, k_scale, v_scale, kv_lens, *, return_lse, soft_cap=0.0):
    """Plain version of K38 (the reference's quantized decode body over one
    chunk spanning the cache): q rounded to bf16, the one-byte payload
    raised to bf16, the row scales folded as :func:`_quant_softmax`."""
    count_call(_plain_decode_quant)
    b, hq, d = q.shape
    _, h_kv, s_len, _ = k.shape
    g = hq // h_kv
    q4 = q.to(torch.bfloat16).float().reshape(b, h_kv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", q4, k.to(torch.bfloat16).float())
    s = s * (k_scale * (1.0 / math.sqrt(d)))         # [b, h_kv, 1, s] over g
    span = torch.arange(s_len, device=q.device)
    valid = span[None, None, None, :] < kv_lens.long()[:, None, None, None]
    out, lse = _quant_softmax(s, v, v_scale, valid, soft_cap, "bhgs,bhsd->bhgd")
    out = out.reshape(b, hq, d)
    return (out, lse.reshape(b, hq)) if return_lse else out


_plain_decode_quant.calls = 0


def _paged_scales_to_contiguous(scales, block_table):
    """``[n_pages, h_kv, 1, page]`` + ``[b, max_pages]`` →
    ``[b, h_kv, 1, max_pages * page]``."""
    b, max_pages = block_table.shape
    x = scales[block_table.long()]  # [b, max_pages, h_kv, 1, page]
    _, _, h_kv, _, page = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h_kv, 1, max_pages * page)


def _plain_paged_decode_quant(q, k_pages, v_pages, k_scales, v_scales, kv_lens,
                              block_table, *, return_lse=False, soft_cap=0.0):
    """Plain version of K39: payload and scale pages gathered back into a
    contiguous cache, then :func:`_plain_decode_quant`."""
    return _plain_decode_quant(
        q, _paged_to_contiguous(k_pages, block_table),
        _paged_to_contiguous(v_pages, block_table),
        _paged_scales_to_contiguous(k_scales, block_table),
        _paged_scales_to_contiguous(v_scales, block_table),
        kv_lens, return_lse=return_lse, soft_cap=soft_cap,
    )


def _split_plan(device: torch.device, blocks: int, s_len: int) -> tuple[int, int]:
    """(splits, chunk): KV spans per (sequence, kv head) so the grid holds
    about four blocks per SM, each span a whole number of softmax tiles."""
    sms = sm_count(device.index if device.index is not None else torch.cuda.current_device())
    splits = max(1, min(cdiv(4 * sms, blocks), cdiv(s_len, _TILE)))
    chunk = cdiv(cdiv(s_len, splits), _TILE) * _TILE
    return cdiv(s_len, chunk), chunk


def _decode_engine(dtype: torch.dtype, d: int, page: int | None, g: int,
                   aligned: bool) -> str:
    """Which kernel runs K2 (``page=None``: a contiguous cache) or K3 (a
    page pool of `page` positions a page) over a float cache:
    ``"onepass"`` (the one-launch kernel, ``onepass_kernel``) for a bf16
    cache with d a multiple of 8 and at most 256, g <= 16, 16-byte aligned
    q, k and v, and (paged) a page that divides the 64-position tile;
    ``"split"`` (the split kernel and its merge) otherwise."""
    ok = (dtype == torch.bfloat16 and d % 8 == 0 and d <= _MAX_D and g <= _MAX_G and aligned
          and (page is None or (page >= 1 and _TILE % page == 0)))
    return "onepass" if ok else "split"


def _verify_engine(dtype: torch.dtype, d: int, paged: bool, aligned: bool) -> str:
    """Which kernel runs the multi-position verify: ``"wgmma"`` (K13's
    wgmma + TMA kernel, ``verify_sm90_kernel``) for a bf16 contiguous cache
    with d a multiple of 8 and at most 256 and 16-byte aligned q, k and v;
    ``"mma"`` (``verify_mma_kernel``) for every other bf16 cache, a page
    pool (K14) and a one-byte cache (K40); ``"fma"`` for f32."""
    if dtype == torch.float32:
        return "fma"
    ok = (dtype == torch.bfloat16 and not paged and d % 8 == 0 and d <= _MAX_D and aligned)
    return "wgmma" if ok else "mma"


def _onepass_plan(b: int, h_kv: int, page: int, max_pages: int, sms: int) -> tuple[int, int]:
    """(span_pages, splits) of the one-launch decode (a contiguous cache
    is `max_pages` = ceil(s / 64) "pages" of one 64-position tile): spans of
    `span_pages` pages (a multiple of the tile's 64 / page) so that full-
    length sequences give about eight blocks per SM (a block's chain of
    latencies is short: lengths, page ids, copies, one or two tiles, the
    merge); the grid's span count ``splits = ceil(max_pages / span_pages)``
    needs only the table's width, never the lengths."""
    ppt = _TILE // page
    want = max(1, cdiv(8 * sms, b * h_kv))
    span_pages = cdiv(cdiv(max_pages, want), ppt) * ppt
    return span_pages, cdiv(max_pages, span_pages)


def _onepass_rows(kv_lens, page: int, max_pages: int, span_pages: int,
                  s_len: int | None = None) -> list:
    """The ``(sequence, span, first position, end position)`` rows the
    one-launch kernel computes for these lengths (one block each a kv
    head), in the kernel's own arithmetic: each sequence's valid pages cut
    into spans of `span_pages`; a sequence with no cache has none. A
    contiguous cache of `s_len` positions is ``page = 64`` and
    ``max_pages = ceil(s_len / 64)``, its lengths clamped to `s_len`."""
    rows = []
    for bi, n in enumerate(kv_lens):
        n = max(0, min(int(n), page * max_pages if s_len is None else s_len))
        n_pages = cdiv(n, page)
        for span in range(cdiv(n_pages, span_pages)):
            pg0 = span * span_pages
            pg1 = min(pg0 + span_pages, n_pages)
            rows.append((bi, span, pg0 * page, min(pg1 * page, n)))
    return rows


def _check_operands(q, k, v, kv_lens, block_table=None, max_g=_MAX_G, scales=None):
    tensors = [q, k, v, kv_lens] + ([] if block_table is None else [block_table])
    tensors += [] if scales is None else list(scales)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash decode operands must share one CUDA device")
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(
            "flash decode takes a bf16 or f32 cache, or an int8 or fp8 (e4m3fn) "
            f"cache with f32 row scales (q then rides bf16); got {k.dtype}/{v.dtype}"
        )
    quant = k.dtype in _QUANT_DTYPES
    if quant != (scales is not None):
        raise TypeError("an int8 or fp8 cache needs its k and v row scales, a float one none")
    if kv_lens.dtype != torch.int32 or (
        block_table is not None and block_table.dtype != torch.int32
    ):
        raise TypeError("kv_lens and block_table are int32")
    if quant:
        want = (*k.shape[:2], 1, k.shape[2])
        if any(x.dtype != torch.float32 or tuple(x.shape) != want for x in scales):
            raise ValueError(f"row scales are f32 {list(want)}, got "
                             f"{[(x.dtype, tuple(x.shape)) for x in scales]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash decode takes contiguous operands")
    hq, d = q.shape[-2:]
    h_kv = k.shape[1]
    if hq % h_kv or hq // h_kv > max_g or _kernel_head_dim(d) > _MAX_D:
        raise ValueError(
            f"flash decode kernel takes hq/h_kv <= {max_g} whole groups and "
            f"head dim <= {_MAX_D}; got hq={hq}, h_kv={h_kv}, d={d}"
        )


def _compute_dtype(k):
    """The dtype the kernels read q in: bf16 for a one-byte cache (it rises
    to bf16 in the kernel), else the cache's own."""
    return torch.bfloat16 if k.dtype in _QUANT_DTYPES else k.dtype


def _scale_ptrs(scales):
    return (None, None) if scales is None else (scales[0].data_ptr(), scales[1].data_ptr())


def _launch_onepass(q, k, v, kv_lens, block_table, soft_cap):
    """K2's (`block_table` None) or K3's one-launch kernel (see
    :func:`_decode_engine`); returns (out, lse)."""
    b, hq, d = q.shape
    h_kv = k.shape[1]
    if block_table is None:  # 64-position tiles as the "pages"
        s_len = k.shape[2]
        page, max_pages = _TILE, cdiv(s_len, _TILE)
    else:
        page, max_pages = k.shape[2], block_table.shape[1]
    span_pages, splits = _onepass_plan(b, h_kv, page, max_pages, sm_count(q.get_device()))
    f32 = dict(dtype=torch.float32, device=q.device)
    out_part = torch.empty((b * splits * hq, d), **f32)   # [b * h_kv, splits, g] rows
    lse_part = torch.empty((b * splits * hq,), **f32)
    out = torch.empty((b, hq, d), **f32)
    lse = torch.empty((b, hq), **f32)
    # the arrival counters, zeroed in the call's stream (safe under capture:
    # a graph replays the memset with the launch)
    arrivals = torch.zeros((b * h_kv,), dtype=torch.int32, device=q.device)
    lib = _build.library("flash_decode", _PROTOTYPES)
    ptrs = (out_part.data_ptr(), lse_part.data_ptr(), arrivals.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    tail = (1.0 / math.sqrt(d), float(soft_cap), _build.stream_of(q))
    if block_table is None:
        rc = lib.tdt_flash_decode_onepass(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), *ptrs,
            b, hq, h_kv, d, s_len, span_pages, splits, *tail,
        )
        _build.check(lib, rc, "flash_decode (one launch)")
    else:
        rc = lib.tdt_paged_flash_decode_onepass(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), block_table.data_ptr(),
            *ptrs, b, hq, h_kv, d, page, max_pages, span_pages, splits, *tail,
        )
        _build.check(lib, rc, "paged_flash_decode (one launch)")
    return out, lse


def _launch_decode(q, k, v, kv_lens, block_table, soft_cap, scales=None, engine=None):
    """Launch the decode (K2/K3, or K38/K39 with `scales`); returns (out,
    lse, engine). A float cache runs the engine :func:`_decode_engine`
    picks by dtype, shape and alignment (`engine` forces ``"split"``, the
    chip script's A/B): ``"onepass"``, one launch; ``"split"``, the
    split-KV kernel and its merge, as every one-byte cache does."""
    b, hq, d = q.shape
    h_kv = k.shape[1]
    q = q.to(_compute_dtype(k)).contiguous()
    _check_operands(q, k, v, kv_lens, block_table, scales=scales)
    if scales is None and engine is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        page = None if block_table is None else k.shape[2]
        engine = _decode_engine(k.dtype, d, page, hq // h_kv, aligned)
        if engine == "onepass":
            return (*_launch_onepass(q, k, v, kv_lens, block_table, soft_cap), engine)
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
        *_scale_ptrs(scales), out_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODE[k.dtype], b, hq, h_kv, d, dp,
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
    return out, lse, "split"


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    config: FlashDecodeConfig | None = None,
    return_lse: bool = False,
    _engine: str | None = None,
):
    """Single-device GQA batch decode over a contiguous cache (K2).
    q ``[b, hq, d]``; k, v ``[b, h_kv, s, d]``; kv_lens ``[b]`` int32.
    Returns f32 ``out [b, hq, d]`` (and ``lse [b, hq]`` if `return_lse`).

    The engine :func:`_decode_engine` picks by dtype, shape and alignment
    runs it: a bf16 cache the one-launch kernel (counted on
    ``onepass_launches`` as well as ``launches``), an f32 one the split-KV
    kernel and its merge. ``_engine="split"`` forces the split kernel (the
    chip script's A/B; never the main path)."""
    if _engine not in (None, "split"):
        raise ValueError(f"flash_decode: _engine is None or 'split', not {_engine!r}")
    soft_cap = (config or FlashDecodeConfig()).soft_cap
    if q.device.type == "cpu":
        return _xla_decode(q, k, v, kv_lens, return_lse=return_lse, soft_cap=soft_cap)
    out, lse, engine = _launch_decode(q, k, v, kv_lens, None, soft_cap, engine=_engine)
    count_launch(flash_decode)
    if engine == "onepass":
        count_launch(flash_decode, "onepass_launches")
    return (out, lse) if return_lse else out


flash_decode.launches = 0
flash_decode.onepass_launches = 0  # K2 on the one-launch kernel


def _refuse_xla_native(cfg: FlashDecodeConfig, what: str) -> None:
    if cfg.block_s == 0:
        raise ValueError(
            "block_s=0 (XLA-native) supports only the contiguous bf16 "
            f"cache; {what} caches need the kernel"
        )


def flash_decode_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    v_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    config: FlashDecodeConfig | None = None,
    return_lse: bool = False,
):
    """GQA batch decode over a one-byte cache (K38, ≙ ``flash_decode_quant``,
    ``:1235``, and ``flash_decode_fp8``, ``:1303``: the same kernel, the
    payload dtype decides): k_q, v_q ``[b, h_kv, s, d]`` int8 or fp8 e4m3
    from :func:`quantize_kv` / :func:`quantize_kv_fp8`, scales f32 ``[b,
    h_kv, 1, s]``. q rides bf16. Returns like :func:`flash_decode`."""
    cfg = config or FlashDecodeConfig()
    _refuse_xla_native(cfg, "int8/fp8")
    if q.device.type == "cpu":
        return _plain_decode_quant(q, k_q, v_q, k_scale, v_scale, kv_lens,
                                   return_lse=return_lse, soft_cap=cfg.soft_cap)
    out, lse, _ = _launch_decode(q, k_q, v_q, kv_lens, None, cfg.soft_cap,
                                 scales=(k_scale, v_scale))
    count_launch(flash_decode_quant)
    return (out, lse) if return_lse else out


flash_decode_quant.launches = 0


def flash_decode_fp8(q, k_q, v_q, k_scale, v_scale, kv_lens, *, config=None,
                     return_lse=False):
    """fp8 twin of :func:`flash_decode_quant` (≙ ``:1303``): the same K38
    launch over an fp8 e4m3 cache from :func:`quantize_kv_fp8`."""
    return flash_decode_quant(q, k_q, v_q, k_scale, v_scale, kv_lens, config=config,
                              return_lse=return_lse)


def paged_flash_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    block_table: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    fuse_heads: bool | None = None,
    pages_per_step: int | None = None,
    soft_cap: float = 0.0,
    return_lse: bool = False,
    _engine: str | None = None,
):
    """Single-device GQA batch decode over a paged cache (K3): k_pages,
    v_pages ``[n_pages, h_kv, page, d]``; block_table ``[b, max_pages]``
    int32 physical page ids (entries past the valid length may be any
    in-range value — the kernel reads only pages below ``ceil(kv_len /
    page)``). ``fuse_heads`` and ``pages_per_step`` pick the TPU kernel's
    grid and per-step span; the CUDA kernel accepts and needs neither.

    ``k_scales``/``v_scales`` (f32 ``[n_pages, h_kv, 1, page]``, from
    :func:`quantize_kv_pages` / :func:`quantize_kv_pages_fp8`): one-byte
    pools, read by K39 — each scale row found through the block table like
    its payload row. Its launches count on ``quant_launches``.

    A float pool runs the engine :func:`_decode_engine` picks by dtype,
    shape and alignment: a bf16 pool the one-launch kernel (counted on
    ``onepass_launches`` as well as ``launches``), anything else the
    split-KV kernel and its merge. ``_engine="split"`` forces the split
    kernel (the chip script's A/B; never the main path)."""
    del fuse_heads, pages_per_step
    if _engine not in (None, "split"):
        raise ValueError(f"paged_flash_decode: _engine is None or 'split', not {_engine!r}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_flash_decode: pass both k_scales and v_scales, or neither")
    scales = None if k_scales is None else (k_scales, v_scales)
    if q.device.type == "cpu":
        if scales is not None:
            return _plain_paged_decode_quant(q, k_pages, v_pages, *scales, kv_lens,
                                             block_table, return_lse=return_lse,
                                             soft_cap=soft_cap)
        return _xla_paged_decode(
            q, k_pages, v_pages, kv_lens, block_table,
            return_lse=return_lse, soft_cap=soft_cap,
        )
    out, lse, engine = _launch_decode(q, k_pages, v_pages, kv_lens, block_table, soft_cap,
                                      scales=scales, engine=_engine)
    count_launch(paged_flash_decode, "launches" if scales is None else "quant_launches")
    if engine == "onepass":
        count_launch(paged_flash_decode, "onepass_launches")
    return (out, lse) if return_lse else out


paged_flash_decode.launches = 0
paged_flash_decode.quant_launches = 0
paged_flash_decode.onepass_launches = 0  # K3 on the one-launch kernel


def paged_flash_decode_quant(q, k_pages_q, v_pages_q, k_scales, v_scales, kv_lens,
                             block_table, **kw):
    """int8-pool paged decode (≙ ``:1779``): :func:`paged_flash_decode`
    with the scale pools attached, arguments in the contiguous entry's
    order."""
    return paged_flash_decode(q, k_pages_q, v_pages_q, kv_lens, block_table,
                              k_scales=k_scales, v_scales=v_scales, **kw)


def paged_flash_decode_fp8(q, k_pages_q, v_pages_q, k_scales, v_scales, kv_lens,
                           block_table, **kw):
    """fp8-pool paged decode (≙ ``:1805``): the same alias over fp8 pools."""
    return paged_flash_decode(q, k_pages_q, v_pages_q, kv_lens, block_table,
                              k_scales=k_scales, v_scales=v_scales, **kw)


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


def _sp_allgather_combine(out, lse, ctx, ag_method: str = "full_mesh_push"):
    """The SP tail (≙ ``_sp_allgather_combine``): gather each rank's
    ``(out, lse)`` payload and merge. One flat f32 payload per rank:
    ``[b*hq, d]`` out rows, then the ``b*hq`` lse values packed densely into
    ``ceil(b*hq / d)`` more rows."""
    n = axis_size(ctx)
    if n == 1:
        return out
    b, hq, d = out.shape
    rows = b * hq
    lse_rows = cdiv(rows, d)
    lse_packed = torch.nn.functional.pad(lse.reshape(-1), (0, lse_rows * d - rows))
    payload = torch.cat([out.reshape(rows, d), lse_packed.reshape(lse_rows, d)])
    gathered = all_gather(payload, ctx=ctx, method=ag_method)
    gathered = gathered.reshape(n, rows + lse_rows, d)
    outs = gathered[:, :rows, :].reshape(n, b, hq, d)
    lses = gathered[:, rows:, :].reshape(n, lse_rows * d)[:, :rows].reshape(n, b, hq)
    return combine_partials(outs, lses)


def flash_decode_distributed(
    q, k_shard, v_shard, kv_lens_shard, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP decode over a sequence-sharded contiguous cache (call inside
    ``ctx.run``): every rank holds the full q and its shard of the cache
    (``kv_lens_shard`` = valid positions in the LOCAL shard). At world 1
    the shard is the whole cache and the merge is the identity."""
    if axis_size(ctx) == 1:
        return flash_decode(q, k_shard, v_shard, kv_lens_shard, config=config)
    out, lse = flash_decode(q, k_shard, v_shard, kv_lens_shard, config=config,
                            return_lse=True)
    return _sp_allgather_combine(out, lse, ctx, ag_method)


def paged_flash_decode_distributed(
    q, k_pages, v_pages, kv_lens_shard, block_table, *,
    fuse_heads: bool | None = None, pages_per_step: int | None = None,
    soft_cap: float = 0.0, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP decode over a paged, sequence-sharded cache: each rank's page
    pool and block table cover its sequence shard."""
    if axis_size(ctx) == 1:
        return paged_flash_decode(
            q, k_pages, v_pages, kv_lens_shard, block_table,
            fuse_heads=fuse_heads, pages_per_step=pages_per_step,
            soft_cap=soft_cap,
        )
    out, lse = paged_flash_decode(
        q, k_pages, v_pages, kv_lens_shard, block_table,
        fuse_heads=fuse_heads, pages_per_step=pages_per_step,
        soft_cap=soft_cap, return_lse=True,
    )
    return _sp_allgather_combine(out, lse, ctx, ag_method)


def flash_decode_quant_distributed(
    q, k_q, v_q, k_scale, v_scale, kv_lens_shard, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP decode over a sequence-sharded int8 cache (call inside ``ctx.run``;
    ≙ ``:1259``): each rank's quantized partial (K38), then the (out, lse)
    allgather merge."""
    out, lse = flash_decode_quant(q, k_q, v_q, k_scale, v_scale, kv_lens_shard,
                                  config=config, return_lse=True)
    return _sp_allgather_combine(out, lse, ctx, ag_method)


def flash_decode_fp8_distributed(
    q, k_q, v_q, k_scale, v_scale, kv_lens_shard, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP decode over a sequence-sharded fp8 cache (≙ ``:1326``)."""
    out, lse = flash_decode_fp8(q, k_q, v_q, k_scale, v_scale, kv_lens_shard,
                                config=config, return_lse=True)
    return _sp_allgather_combine(out, lse, ctx, ag_method)


def flash_decode_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    ctx=None,
    config: FlashDecodeConfig | None = None,
) -> torch.Tensor:
    """Host-level SP entry (≙ ``flash_decode_op``, ``:1917``): k, v ``[b,
    h_kv, S, d]`` over the whole sequence, q and the global ``kv_lens``
    replicated. Rank r takes positions ``[r S/n, (r+1) S/n)`` (on its
    device), its local lengths ``clip(kv_lens - r S/n, 0, S/n)``, and every
    rank returns the merged output; rank 0's comes back on q's device. The
    reference's autotuner and golden fallback around it are not ported:
    the kernel runs or raises."""
    n = axis_size(ctx)
    if k.shape[2] % n:
        raise ValueError(f"flash_decode_op: S={k.shape[2]} over {n} ranks")
    if n == 1:
        return flash_decode(q, k, v, kv_lens, config=config)
    s_shard = k.shape[2] // n

    def body():
        r, dev = ctx.rank, ctx.rank_device
        part = [x[:, :, r * s_shard:(r + 1) * s_shard].contiguous().to(dev) for x in (k, v)]
        local = torch.clamp(kv_lens.to(dev).long() - r * s_shard, 0, s_shard).to(torch.int32)
        return flash_decode_distributed(q.to(dev), *part, local, config=config, ctx=ctx)

    return ctx.run(body)[0].to(q.device)


# ------------------------------------------------ multi-position verify ----


def _xla_verify(q, k, v, kv_lens, *, return_lse, soft_cap=0.0):
    """Plain version of the multi-position verify (≙ ``_xla_verify``,
    ``:632``): per-(sequence, position) prefix masks over one einsum, f32
    scores and probabilities, any head dim."""
    count_call(_xla_verify)
    b, S, hq, d = q.shape
    _, h_kv, s_len, _ = k.shape
    g = hq // h_kv
    q5 = q.reshape(b, S, h_kv, g, d).float()
    s = torch.einsum("bshgd,bhtd->bshgt", q5, k.float()) / math.sqrt(d)
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    span = torch.arange(s_len, device=q.device)
    mask = span[None, None, :] < kv_lens.long()[:, :, None]      # [b, S, t]
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=-1e30)  # kv_len == 0 rows: avoid inf - inf
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bshgt,bhtd->bshgd", p, v.float())
    out = (out / torch.clamp(l, min=1e-30)).reshape(b, S, hq, d)
    out = torch.where(l.reshape(b, S, hq, 1) > 0, out, 0.0)
    if not return_lse:
        return out
    lse = (m_safe + torch.log(torch.clamp(l, min=1e-30))).reshape(b, S, hq)
    lse = torch.where(l.reshape(b, S, hq) > 0, lse, NEG_INF)
    return out, lse


_xla_verify.calls = 0


def _xla_paged_verify(q, k_pages, v_pages, kv_lens, block_table, *,
                      return_lse=False, soft_cap=0.0):
    """Plain version of the paged verify (≙ ``_xla_paged_verify``,
    ``:836``): gather the pages back into a contiguous cache, then
    :func:`_xla_verify`."""
    return _xla_verify(
        q, _paged_to_contiguous(k_pages, block_table),
        _paged_to_contiguous(v_pages, block_table),
        kv_lens, return_lse=return_lse, soft_cap=soft_cap,
    )


def _plain_verify_quant(q, k, v, k_scale, v_scale, kv_lens, *, return_lse, soft_cap=0.0):
    """Plain version of K40 (the reference's quantized verify body,
    ``_flash_verify_body`` with scales, over one chunk spanning the cache):
    per-(sequence, position) prefix masks, q rounded to bf16, the row scales
    folded as :func:`_quant_softmax`."""
    count_call(_plain_verify_quant)
    b, S, hq, d = q.shape
    _, h_kv, s_len, _ = k.shape
    g = hq // h_kv
    q5 = q.to(torch.bfloat16).float().reshape(b, S, h_kv, g, d)
    s = torch.einsum("bshgd,bhtd->bshgt", q5, k.to(torch.bfloat16).float())
    s = s * (k_scale * (1.0 / math.sqrt(d)))[:, None]   # [b, 1, h_kv, 1, t]
    span = torch.arange(s_len, device=q.device)
    valid = (span[None, None, :] < kv_lens.long()[:, :, None])[:, :, None, None, :]
    out, lse = _quant_softmax(s, v, v_scale[:, None], valid, soft_cap,
                              "bshgt,bhtd->bshgd")
    out = out.reshape(b, S, hq, d)
    return (out, lse.reshape(b, S, hq)) if return_lse else out


_plain_verify_quant.calls = 0


def _launch_verify(q, k, v, kv_lens, block_table, soft_cap, scales=None, engine=None):
    """Launch K13 (contiguous), K14 (paged) or, with `scales`, K40; returns
    (out, lse, engine): the engine :func:`_verify_engine` picks, or
    ``engine="mma"`` (the chip script's A/B) for the mma.sync kernel."""
    b, S, hq, d = q.shape
    h_kv = k.shape[1]
    q = q.to(_compute_dtype(k)).contiguous()
    _check_operands(q, k, v, kv_lens, block_table, max_g=hq, scales=scales)
    if kv_lens.shape != (b, S):
        raise ValueError(f"kv_lens must be [b, S] = {(b, S)}, got {tuple(kv_lens.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, S, hq, d), **f32)
    lse = torch.empty((b, S, hq), **f32)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr())
    common = (*_scale_ptrs(scales), out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[k.dtype],
              b, S, hq, h_kv, d)
    tail = (1.0 / math.sqrt(d), float(soft_cap), _build.stream_of(q))
    lib = _build.library("flash_verify", _VERIFY_PROTOTYPES)
    if engine is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        engine = _verify_engine(k.dtype, d, block_table is not None, aligned)
    if engine == "wgmma":
        rc = lib.tdt_flash_verify_sm90(*head, out.data_ptr(), lse.data_ptr(), b, S, hq, h_kv, d,
                                       k.shape[2], *tail)
        _build.check(lib, rc, "flash_verify (wgmma)")
    elif block_table is None:
        rc = lib.tdt_flash_verify(*head, *common, k.shape[2], *tail)
        _build.check(lib, rc, "flash_verify")
    else:
        rc = lib.tdt_paged_flash_verify(
            *head, block_table.data_ptr(), *common, k.shape[2], block_table.shape[1],
            *tail,
        )
        _build.check(lib, rc, "paged_flash_verify")
    return out, lse, engine


def flash_verify(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    config: FlashDecodeConfig | None = None,
    return_lse: bool = False,
    scales=None,
    _engine: str | None = None,
):
    """Multi-position GQA decode over a contiguous cache (K13, ≙
    ``flash_verify``, ``:662``): q ``[b, S, hq, d]`` (the S positions' own
    k/v already written), k, v ``[b, h_kv, s, d]``, kv_lens ``[b, S]``
    int32 — row (b, i) attends cache positions ``< kv_lens[b, i]``.
    Returns f32 ``out [b, S, hq, d]`` (and ``lse [b, S, hq]``).

    ``scales=(k_scale, v_scale)`` (f32 ``[b, h_kv, 1, s]``) reads an int8 or
    fp8 cache through K40, as the reference's ``_flash_verify_fused(scales=)``
    (``:703``) does; q rides bf16. Those launches count on
    ``quant_launches``.

    The engine :func:`_verify_engine` picks by dtype, shape and alignment
    runs it: a bf16 cache the wgmma + TMA kernel (counted on
    ``wgmma_launches`` as well as ``launches``), else the mma.sync or f32
    kernel. ``_engine="mma"`` forces the mma.sync kernel (the chip script's
    A/B; never the main path)."""
    if _engine not in (None, "mma"):
        raise ValueError(f"flash_verify: _engine is None or 'mma', not {_engine!r}")
    cfg = config or FlashDecodeConfig()
    if scales is not None:
        _refuse_xla_native(cfg, "int8/fp8")
        scales = tuple(scales)
    if q.device.type == "cpu":
        if scales is not None:
            return _plain_verify_quant(q, k, v, *scales, kv_lens, return_lse=return_lse,
                                       soft_cap=cfg.soft_cap)
        return _xla_verify(q, k, v, kv_lens, return_lse=return_lse, soft_cap=cfg.soft_cap)
    out, lse, engine = _launch_verify(q, k, v, kv_lens, None, cfg.soft_cap, scales=scales,
                                      engine=_engine)
    count_launch(flash_verify, "launches" if scales is None else "quant_launches")
    if engine == "wgmma":
        count_launch(flash_verify, "wgmma_launches")
    return (out, lse) if return_lse else out


flash_verify.launches = 0
flash_verify.quant_launches = 0
flash_verify.wgmma_launches = 0  # K13 on the wgmma + TMA kernel


def flash_verify_fp8(q, k_q, v_q, k_scale, v_scale, kv_lens, *, config=None,
                     return_lse=False):
    """Multi-position verify over an fp8 cache (≙ ``flash_verify_fp8``,
    ``:1349``): :func:`flash_verify` with the cache's row scales (K40)."""
    return flash_verify(q, k_q, v_q, kv_lens, config=config, return_lse=return_lse,
                        scales=(k_scale, v_scale))


def paged_flash_verify(
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
    """Multi-position decode over a paged cache (K14, ≙
    ``paged_flash_verify``, ``:893``): :func:`flash_verify` through the
    block table of :func:`paged_flash_decode`. ``fuse_heads`` and
    ``pages_per_step`` pick the TPU kernel's grid and span; the CUDA kernel
    accepts and needs neither."""
    del fuse_heads, pages_per_step
    if q.device.type == "cpu":
        return _xla_paged_verify(
            q, k_pages, v_pages, kv_lens, block_table,
            return_lse=return_lse, soft_cap=soft_cap,
        )
    out, lse, _ = _launch_verify(q, k_pages, v_pages, kv_lens, block_table, soft_cap)
    count_launch(paged_flash_verify)
    return (out, lse) if return_lse else out


paged_flash_verify.launches = 0


def _sp_merge_rows(out, lse, ctx, ag_method):
    """The SP tail of the verify family: S folds into the payload's row
    dim (``:805-810``)."""
    b, S, hq, d = out.shape
    merged = _sp_allgather_combine(
        out.reshape(b * S, hq, d), lse.reshape(b * S, hq), ctx, ag_method
    )
    return merged.reshape(b, S, hq, d)


def flash_verify_distributed(
    q, k_shard, v_shard, lens_shard, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP form of :func:`flash_verify` (call inside ``ctx.run``; ≙
    ``:786``): per-shard multi-position partials, then the (out, lse)
    allgather merge of the single-token SP decode."""
    if axis_size(ctx) == 1:
        return flash_verify(q, k_shard, v_shard, lens_shard, config=config)
    out, lse = flash_verify(q, k_shard, v_shard, lens_shard, config=config,
                            return_lse=True)
    return _sp_merge_rows(out, lse, ctx, ag_method)


def paged_flash_verify_distributed(
    q, k_pages, v_pages, lens_shard, block_table, *,
    fuse_heads: bool | None = None, pages_per_step: int | None = None,
    soft_cap: float = 0.0, ctx=None, ag_method: str = "full_mesh_push",
):
    """SP form of :func:`paged_flash_verify` (≙ ``:1111``): per-shard
    partials over each rank's page pool, merged by the same tail."""
    kw = dict(fuse_heads=fuse_heads, pages_per_step=pages_per_step, soft_cap=soft_cap)
    if axis_size(ctx) == 1:
        return paged_flash_verify(q, k_pages, v_pages, lens_shard, block_table, **kw)
    out, lse = paged_flash_verify(q, k_pages, v_pages, lens_shard, block_table,
                                  return_lse=True, **kw)
    return _sp_merge_rows(out, lse, ctx, ag_method)


def _ranged_local_lens(pos0, S: int, me: int, s_shard: int) -> torch.Tensor:
    """Per-(sequence, range-row) valid prefix in rank `me`'s sequence shard
    for a suffix-only ranged prefill (≙ ``:1141``): row i of the range
    attends global positions ``<= pos0 + i``, and the rank covers ``[me *
    s_shard, (me+1) * s_shard)``. `pos0` is ``[b]`` (a tensor or host
    array); the result is int32 ``[b, S]`` on `pos0`'s device."""
    pos0 = torch.as_tensor(pos0).to(torch.int64)
    pos_mat = pos0.reshape(-1, 1) + torch.arange(S, device=pos0.device)[None, :]
    return torch.clamp(pos_mat + 1 - me * s_shard, 0, s_shard).to(torch.int32)


def flash_ranged_prefill_distributed(
    q, k_shard, v_shard, pos0, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """Suffix-only ranged prefill over a contiguous SP cache (≙ ``:1154``):
    q ``[b, S, hq, d]`` holds a prompt range's rows at global positions
    ``pos0 .. pos0+S-1`` whose own k/v are already written; row i attends
    every landed position ``<= pos0 + i``. Composing consecutive ranges
    gives each row the same mask as one whole-range pass."""
    lens = _ranged_local_lens(pos0, q.shape[1], axis_index(ctx), k_shard.shape[2])
    return flash_verify_distributed(q, k_shard, v_shard, lens.to(q.device),
                                    config=config, ctx=ctx, ag_method=ag_method)


def paged_flash_ranged_prefill_distributed(
    q, k_pages, v_pages, pos0, block_table, *,
    fuse_heads: bool | None = None, pages_per_step: int | None = None,
    soft_cap: float = 0.0, ctx=None, ag_method: str = "full_mesh_push",
):
    """Paged twin of :func:`flash_ranged_prefill_distributed` (≙
    ``:1182``): the range's prior pages named by `block_table`."""
    s_shard = block_table.shape[1] * k_pages.shape[2]
    lens = _ranged_local_lens(pos0, q.shape[1], axis_index(ctx), s_shard)
    return paged_flash_verify_distributed(
        q, k_pages, v_pages, lens.to(q.device), block_table,
        fuse_heads=fuse_heads, pages_per_step=pages_per_step, soft_cap=soft_cap,
        ctx=ctx, ag_method=ag_method,
    )


def flash_ranged_prefill_fp8_distributed(
    q, k_q_shard, v_q_shard, k_scale, v_scale, pos0, *,
    config: FlashDecodeConfig | None = None, ctx=None, ag_method: str = "full_mesh_push",
):
    """fp8 twin of :func:`flash_ranged_prefill_distributed` (≙ ``:1383``):
    per-row prefix lengths from ``pos0`` in this rank's shard, the fp8
    multi-position verify (K40), then the (out, lse) merge."""
    lens = _ranged_local_lens(pos0, q.shape[1], axis_index(ctx), k_q_shard.shape[2])
    out, lse = flash_verify_fp8(q, k_q_shard, v_q_shard, k_scale, v_scale,
                                lens.to(q.device), config=config, return_lse=True)
    return _sp_merge_rows(out, lse, ctx, ag_method)
