"""The KV handoff stream of disaggregated prefill / decode (≙
``triton_dist_tpu/ops/kv_stream.py``): ``WIRES``, ``QUANT_WIRES``,
``FP8_WIRE_DTYPE`` and ``KVStreamConfig`` (``:73-112``),
``KV_STREAM_TUNE_SPACE`` (``:115``), the wire quantizers (``:122-162``),
``mirror_peer`` (``:165``), the plain version ``_kv_stream_xla``
(``:243``), ``kv_stream`` (``:256``/``:345``) and the host-level
``kv_stream_op`` (``:383``); the Pallas kernels ``_kv_stream_kernel``
(``:172``) → K41 and ``_kv_stream_w8_kernel`` (``:204``) → K42, both in
``csrc/kv_stream.cu``.

One rank axis spans both pools, prefill ranks first: every rank exchanges
its ``[m, w]`` page slab with its mirror ``(me + n/2) mod n`` in the other
pool, chunk by chunk over the spans of ``chunk_schedule(m,
chunks_per_shard)``, and the mirror's slab lands at the same offsets. On
the one-byte wires (``"int8"``, ``"fp8"``) the payload is pre-quantized
per row (:func:`quantize_kv_wire`, :func:`quantize_kv_wire_fp8`) and its
``[m, 1]`` f32 scales ride a second chunked put over the same spans, each
chunk with its own flag; one kernel serves both wires, as the protocol
never reads the payload (fp8 moves as bytes), with the launch families
kept apart (``kv_stream_w8``, ``kv_stream_fp8``).

On the card a call is the push (the put into the mirror's symmetric
workspace, a flag a chunk), the ranks meet on the host, then the collect:
bounded per-chunk waits in chunk order and the copy of the landed chunks
into the private out (``csrc/kv_stream.cu``). On the CPU the plain version exchanges the slabs over the
runtime's host ``ppermute`` (the twin of XLA's); the tests hold the
kernels to it bit for bit (a copy).

Not ported: the reference's ``resilience.guarded_call`` / ``guard_op``
fallback to the golden (``:355``, ``:382``) — the kernel runs or raises —
and the payload canary on ``recv_view=`` (the integrity layer, armed only
under ``config.integrity.canary``), which belongs to the host resilience
tiers still to port (ROADMAP A9).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import _build, config as tdt_config
from triton_dist_tpu_torch.ops.common import (
    chunk_schedule,
    max_consumer_blocks,
    span_array,
    stream_ptr,
)
from triton_dist_tpu_torch.resilience import watchdog
from triton_dist_tpu_torch.resilience.sites import MAX_SPANS
from triton_dist_tpu_torch.utils import axis_size, count_call, count_launch

WIRES = ("native", "int8", "fp8")
# the quantized wires share one protocol (payload put + scale put); they
# differ only in payload dtype and quantizer ceiling
QUANT_WIRES = ("int8", "fp8")
FP8_WIRE_DTYPE = torch.float8_e4m3fn
_FP8_WIRE_MAX = 448.0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PROTOTYPES = {
    "tdt_kv_stream_push": [_P, _P, _LL, _I, _P, _LL, _LL, ctypes.POINTER(_I)] + [_I] * 4
    + [_P, _P] + [_I] * 5 + [_P],
    "tdt_kv_stream_collect": [_P, _P, _LL, _I, _P, _LL, _LL, ctypes.POINTER(_I)] + [_I] * 4
    + [_P] + [_I] * 4 + [_P, _LL, _I, _P],
}
PIECE_BYTES = 256 * 1024  # the most a block moves of one chunk
MAX_PIECES = 1024         # csrc/kv_stream.cu MAX_PIECES
# the race-shaking salts of the JAX kernels (:181, :215)
_SALT = {"native": 9, "int8": 10, "fp8": 10}
_FAMILY = {"native": "kv_stream", "int8": "kv_stream_w8", "fp8": "kv_stream_fp8"}


@dataclasses.dataclass(frozen=True)
class KVStreamConfig:
    """One tune-space tuple of the KV handoff stream (≙ ``KVStreamConfig``,
    field for field): ``chunks_per_shard`` the chunks a slab moves in (each
    its own bounded wait), ``wire`` ``"native"`` (the payload as it is),
    ``"int8"`` or ``"fp8"`` (a pre-quantized one-byte payload plus per-row
    f32 scales on their own chunked put)."""

    chunks_per_shard: int = 1
    wire: str = "native"

    def validate(self) -> "KVStreamConfig":
        if self.chunks_per_shard < 1:
            raise ValueError(
                f"chunks_per_shard must be >= 1, got {self.chunks_per_shard}"
            )
        if self.wire not in WIRES:
            raise ValueError(
                f"wire must be one of {WIRES}, got {self.wire!r}"
            )
        return self


# every wire x chunking combination (≙ ``:115``)
KV_STREAM_TUNE_SPACE = tuple(
    KVStreamConfig(chunks_per_shard=c, wire=w)
    for w in WIRES
    for c in (1, 2, 4)
)


def _absmax_scale(pages: torch.Tensor, q_max: float):
    """``(x f32, scale [m, 1])``, ``scale = absmax / q_max`` per row (1
    for an all-zero row). The division is by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its rounded reciprocal, which
    would leave the card's scales an ulp off the CPU's and the
    reference's."""
    x = pages.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / absmax.new_full((), q_max), 1.0)
    return x, scale


def quantize_kv_wire(pages: torch.Tensor):
    """Per-row symmetric int8 quantization of a ``[m, w]`` page slab for the
    int8 wire (≙ ``quantize_kv_wire``): ``(payload int8 [m, w], scales f32
    [m, 1])``, round half to even, clipped to ±127."""
    x, scale = _absmax_scale(pages, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv_wire_fp8(pages: torch.Tensor):
    """fp8 e4m3 twin of :func:`quantize_kv_wire` (≙
    ``quantize_kv_wire_fp8``): 448 in 127's seat, clipped, the rounding
    left to the cast (nearest even)."""
    x, scale = _absmax_scale(pages, _FP8_WIRE_MAX)
    q = torch.clamp(x / scale, -_FP8_WIRE_MAX, _FP8_WIRE_MAX).to(FP8_WIRE_DTYPE)
    return q, scale


def quantize_kv_wire_for(wire: str, pages: torch.Tensor):
    """The quantizer of a ``QUANT_WIRES`` member (dispatch by wire name)."""
    if wire == "int8":
        return quantize_kv_wire(pages)
    if wire == "fp8":
        return quantize_kv_wire_fp8(pages)
    raise ValueError(f"not a quantized wire: {wire!r}")


def dequantize_kv_wire(payload: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_wire` (the consumer side of the wire)."""
    return (payload.float() * scales.float()).to(dtype)


def mirror_peer(me: int, n: int) -> int:
    """The mirror rank in the other pool, ``(me + n/2) mod n``: an
    involution for every even ``n``."""
    return (me + n // 2) % n


def _kv_stream_xla(payload, scales=None, *, ctx=None, **_):
    """Plain version (≙ ``_kv_stream_xla``): the same mirror exchange over
    the runtime's host ``ppermute`` (one operand or both)."""
    count_call(_kv_stream_xla)
    n = axis_size(ctx)
    if n == 1:
        return payload if scales is None else (payload, scales)
    perm = [(i, mirror_peer(i, n)) for i in range(n)]
    out = ctx.ppermute(payload, perm)
    if scales is None:
        return out
    return out, ctx.ppermute(scales, perm)


_kv_stream_xla.calls = 0


def kv_stream(payload: torch.Tensor, scales: torch.Tensor | None = None, *, ctx=None,
              config: KVStreamConfig | None = None):
    """The mirror page-slab exchange of one rank (call inside ``ctx.run``;
    ≙ ``kv_stream`` / ``_kv_stream_fused``). ``payload`` this rank's ``[m,
    w]`` slab (the wire's one-byte dtype on a quantized wire, any dtype on
    the native one); ``scales`` its ``[m, 1]`` f32 row scales, required iff
    the wire is quantized. Returns the mirror's landed slab (and scales on
    the quantized wires). The world must be even; world 1 is the identity.
    On the card K41 (native) or K42 (int8, fp8); on the CPU the plain
    version."""
    cfg = (config or KVStreamConfig()).validate()
    n = axis_size(ctx)
    if (cfg.wire in QUANT_WIRES) != (scales is not None):
        raise ValueError(
            f"KVStreamConfig.wire={cfg.wire!r}: quantized wires "
            f"{QUANT_WIRES} require per-row scales (from "
            f"quantize_kv_wire / quantize_kv_wire_fp8); the native wire "
            f"takes none"
        )
    if n == 1:
        return payload if scales is None else (payload, scales)
    if n % 2:
        raise ValueError(
            f"kv_stream needs an even world (mirror pool pairing); got "
            f"axis {ctx.label!r} size {n}"
        )
    m = payload.shape[0]
    spans = chunk_schedule(m, cfg.chunks_per_shard)
    if cfg.wire in QUANT_WIRES and scales.shape[0] != m:
        raise ValueError(
            f"scales rows {scales.shape[0]} != payload rows {m}"
        )
    if ctx.cuda != payload.is_cuda:
        raise ValueError(f"kv_stream: the payload lies on {payload.device} and the rank "
                         f"runtime on {ctx.device}; a runtime on the card takes card tensors")
    if not payload.is_cuda:
        return _kv_stream_xla(payload, scales, ctx=ctx)
    if len(spans) > MAX_SPANS:
        raise ValueError(f"chunks_per_shard={cfg.chunks_per_shard}: the KV stream takes at most "
                         f"{MAX_SPANS} chunks a slab")
    if scales is None:
        return _kv_stream(payload, ctx, spans)
    return _kv_stream_w8(payload, scales, ctx, spans, cfg.wire)


def _pieces(rows: int, row_bytes: int) -> int:
    return min(MAX_PIECES, max(1, -(-rows * row_bytes // PIECE_BYTES)))


def _kv_stream_launch(payload, scales, ctx, spans, wire):
    """K41/K42: every allocation first, the push into the mirror's
    workspace, the ranks meet (every push is issued before any collect
    waits), the collect. The three wires share one epoch counter, one flag
    set and one workspace, whose region alternates with the epoch's parity
    (``csrc/kv_stream.cu``); the timeout records name the wire's family."""
    n, me = ctx.world, ctx.rank
    payload = payload.contiguous()
    m = payload.shape[0]
    row_bytes = payload[0].numel() * payload.element_size()
    n_puts = 1 if scales is None else 2
    s_off = -(-m * row_bytes // 256) * 256
    region = s_off + (0 if scales is None else -(-4 * m // 256) * 256)
    ws = ctx.symmetric("kv_stream.ws", 2 * region)
    flags = ctx.symmetric("kv_stream.flags", 4 * 2 * MAX_SPANS)
    count = ctx.symmetric("kv_stream.count", 4 * 2 * MAX_SPANS)
    out = torch.empty_like(payload)
    s_src = s_out = None
    s_pieces = 0
    if scales is not None:
        scales = scales.to(torch.float32).contiguous()
        s_out = torch.empty_like(scales)
        s_src = scales.data_ptr()
        s_pieces = max(_pieces(rows, 4) for _, rows in spans)
    pieces = max(_pieces(rows, row_bytes) for _, rows in spans)
    epoch = ctx.next_epoch("kv_stream")
    at = (epoch % 2) * (ws.nbytes // 2 // 256 * 256)
    lib = _build.library("kv_stream", _PROTOTYPES)
    stream = stream_ptr(torch.cuda.current_stream())
    c_spans = span_array(spans)
    table, flag_table = ws.table[me].data_ptr(), flags.table[me].data_ptr()
    rc = lib.tdt_kv_stream_push(
        payload.data_ptr(), s_src, row_bytes, m, table, at, s_off, c_spans, len(spans), pieces,
        s_pieces, n_puts, flag_table, count.peer_addr(me), n, me, epoch, _SALT[wire],
        int(tdt_config.debug_comm_delay), stream)
    _build.check(lib, rc, "kv_stream push")
    ctx.rendezvous()
    rc = lib.tdt_kv_stream_collect(
        out.data_ptr(), None if s_out is None else s_out.data_ptr(), row_bytes, m, table, at,
        s_off, c_spans, len(spans), pieces, s_pieces, n_puts, flag_table, n, me, epoch,
        max_consumer_blocks(ctx), *watchdog.wait_args(ctx.diag[me], _FAMILY[wire]), stream)
    _build.check(lib, rc, "kv_stream collect")
    return out if scales is None else (out, s_out)


def _kv_stream(payload, ctx, spans):
    """K41: the native wire, one chunked put."""
    out = _kv_stream_launch(payload, None, ctx, spans, "native")
    count_launch(_kv_stream)
    return out


def _kv_stream_w8(payload, scales, ctx, spans, wire):
    """K42: the one-byte wires, the payload and scale puts over the same
    spans; ``fp8_launches`` counts the fp8 wire's share of ``launches``."""
    out = _kv_stream_launch(payload, scales, ctx, spans, wire)
    count_launch(_kv_stream_w8)
    if wire == "fp8":
        count_launch(_kv_stream_w8, "fp8_launches")
    return out


_kv_stream.launches = 0
_kv_stream_w8.launches = 0
_kv_stream_w8.fp8_launches = 0


def kv_stream_op(payload: torch.Tensor, *, ctx=None,
                 config: KVStreamConfig | None = None) -> torch.Tensor:
    """Host-level entry (≙ ``kv_stream_op``, ``:383``): ``payload`` a global
    ``[n * m, w]`` tensor whose rows ``[r m, (r+1) m)`` are rank ``r``'s
    slab (moved to its device); returns the mirror-exchanged global tensor
    on `payload`'s device. On the quantized wires each slab is quantized
    per row before the exchange and dequantized after landing, to
    `payload`'s dtype. At world 1 the identity (after the wire's round
    trip)."""
    cfg = (config or KVStreamConfig()).validate()
    n = axis_size(ctx)
    if payload.shape[0] % n:
        raise ValueError(f"kv_stream_op: {payload.shape[0]} rows over {n} ranks")
    m = payload.shape[0] // n

    def fn(x):
        if cfg.wire in QUANT_WIRES:
            q, s = quantize_kv_wire_for(cfg.wire, x)
            q, s = kv_stream(q, s, ctx=ctx, config=cfg)
            return dequantize_kv_wire(q, s, x.dtype)
        return kv_stream(x, ctx=ctx, config=cfg)

    if n == 1:
        return fn(payload)

    def body():
        r = ctx.rank
        return fn(payload[r * m:(r + 1) * m].contiguous().to(ctx.rank_device))

    return torch.cat([o.to(payload.device) for o in ctx.run(body)])
