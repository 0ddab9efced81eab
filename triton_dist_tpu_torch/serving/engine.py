"""The serving engine (≙ ``triton_dist_tpu/serving/engine.py``): an
SLO-metered, traffic-driven loop over
:class:`~triton_dist_tpu_torch.models.decode.ContinuousBatcher`.

Request lifecycle, every timestamp taken at the host scheduling boundary
on the INJECTABLE clock (``resilience/retry.py``'s module clock by
default, so a ``FakeClock`` makes whole serve runs, latency percentiles
included, deterministic — and identical to the JAX package's engine on
the same serve)::

    submit ──► [bounded queue] ──► admitted ──► first token ──► finished
       │            │ backpressure
       └ Rejected ◄─┘ (reject-on-full | block)

Chunked prefill (``prefill_chunk_tokens``) and the radix prefix cache
(``prefix_cache``) are the batcher's ranged-prefill modes. An MoE config
whose ``gg_config`` asks for ``w8`` or ``fp8`` serves float expert banks
quantized once, here, into int8 or fp8 pools with their scales
(:meth:`ServingEngine._serving_params`); pre-quantized banks pass through.
An expert-parallel config (``preset("mixtral-8x7b:ep")``) serves the same
way, its banks (and scales) split on the expert dim by the batcher.
The hierarchical deployment (``preset("mixtral-8x7b:ep-hier")``) serves
on a 2-D runtime (``initialize_distributed(mesh_shape={"dcn": 2, "tp":
2})``): the engine's world is every rank, and it serves un-shrunk, as the
reference's does (``:434-440``; elastic shrink is ROADMAP A9).
The overload controller, speculative decoding and the elastic rebuild
arrive in later slices with the observability, health and elastic tiers;
asking for them raises.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Any

from triton_dist_tpu_torch.models.decode import ContinuousBatcher, Request
from triton_dist_tpu_torch.models.prefix_cache import PX_COUNTERS, PX_GAUGES
from triton_dist_tpu_torch.models.tp_transformer import quantize_moe_serving_params
from triton_dist_tpu_torch.resilience import retry as _retry
from triton_dist_tpu_torch.serving.metrics import ServingMetrics, SLOTargets

BACKPRESSURE = ("reject", "block")
ADMISSION = ("fcfs", "spf")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Host-side serving policy.

    max_queue:        bound on the arrival queue (backpressure trips past it).
    backpressure:     "reject" returns a typed :class:`Rejected`;
                      "block" serves (steps the engine) until space frees.
    admission:        "fcfs" or "spf" (shortest-prompt-first).
    virtual_step_s:   charge each decode step this much time on the engine
                      clock (pair with a ``FakeClock``); None = real time.
    probe_interval_steps: steps between the elastic tier's probation probes
                      (≙ ``:151``); carried and validated, inert until that
                      tier is ported (the reference reads it only with
                      ``config.elastic`` armed).
    max_step_failures, world_ok: the step-failure rebuild and its
                      degraded-world predicate (≙ ``:152``, ``:154``), not
                      ported (ROADMAP A9): a step that fails raises, and
                      anything but the defaults raises.
    slo:              latency targets scored per finished request.
    virtual_prefill_work_s: charge each unit of prefill work — a swept
                      query x key token pair: bucket x bucket per bulk
                      admission, chunk bucket x hi per ranged pass — this
                      much time on the engine clock.
    prefix_cache:     a :class:`~triton_dist_tpu_torch.models.prefix_cache.
                      PrefixCacheConfig` arms the radix prefix cache: an
                      admission skips the feed of every fully shared page
                      (copy-on-write past it, refcounted release). Needs
                      the paged batcher (``page_size=``).
    prefill_chunk_tokens: prompts longer than this admit through bounded
                      ranged chunks between decode steps. Needs
                      ``prefill=True``.
    overload, speculative: later slices (ROADMAP A9, A10); anything but
                      None raises.
    """

    max_queue: int = 256
    backpressure: str = "reject"
    admission: str = "fcfs"
    virtual_step_s: float | None = None
    probe_interval_steps: int = 32
    max_step_failures: int = 8
    slo: SLOTargets | None = None
    world_ok: Any = None
    overload: Any = None
    prefix_cache: Any = None
    prefill_chunk_tokens: int | None = None
    virtual_prefill_work_s: float | None = None
    speculative: Any = None

    def validate(self) -> "ServingConfig":
        for name, item in (("overload", "A9"), ("speculative", "A10")):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"ServingConfig.{name} is not ported yet (ROADMAP {item})"
                )
        if self.probe_interval_steps < 1:
            raise ValueError("probe_interval_steps must be >= 1")
        if self.max_step_failures < 1:
            raise ValueError("max_step_failures must be >= 1")
        for name in ("max_step_failures", "world_ok"):
            if getattr(self, name) != getattr(ServingConfig, name):
                raise NotImplementedError(
                    f"ServingConfig.{name}: the step-failure rebuild is not ported yet "
                    f"(ROADMAP A9)"
                )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.prefill_chunk_tokens is not None and self.prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1 (or None)")
        if self.prefix_cache is not None:
            self.prefix_cache.validate()
        if self.backpressure not in BACKPRESSURE:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE}, "
                f"got {self.backpressure!r}"
            )
        if self.admission not in ADMISSION:
            raise ValueError(
                f"admission must be one of {ADMISSION}, got {self.admission!r}"
            )
        if self.virtual_step_s is not None and self.virtual_step_s < 0:
            raise ValueError("virtual_step_s must be >= 0")
        if (self.virtual_prefill_work_s is not None
                and self.virtual_prefill_work_s < 0):
            raise ValueError("virtual_prefill_work_s must be >= 0")
        return self


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Typed backpressure result: the queue was full under the "reject"
    policy and the request was NOT enqueued."""

    uid: Any
    reason: str
    queue_depth: int
    priority: str | None = None


@dataclasses.dataclass(frozen=True)
class Finished:
    """One completed request with its lifecycle timestamps (engine-clock
    seconds) and its generated tokens."""

    uid: Any
    tokens: list
    t_enqueue: float
    t_admitted: float | None
    t_first_token: float | None
    t_finished: float
    resumed: int

    @property
    def ttft_ms(self) -> float:
        return (self.t_first_token - self.t_enqueue) * 1e3

    @property
    def e2e_ms(self) -> float:
        return (self.t_finished - self.t_enqueue) * 1e3


@dataclasses.dataclass
class _ReqState:
    req: Request
    t_enqueue: float
    t_admitted: float | None = None
    t_first: float | None = None
    awaiting_first: bool = True
    deadline: float | None = None    # absolute engine-clock deadline


class ServingEngine:
    """See module docstring. Construction mirrors ``ContinuousBatcher``
    (cfg/params/s_max plus its keyword surface: ``page_size``,
    ``fd_config``, ``prefill``, ``device``, and ``ctx``, the rank runtime
    that serves at world > 1)::

        eng = ServingEngine(cfg, params, s_max=256,
                            serving=ServingConfig(max_queue=64))
        eng.submit(Request([1, 2, 3], max_new_tokens=8))
        eng.run_until_idle()
        eng.results["r0"].tokens, eng.snapshot()

    or traffic-driven: ``eng.serve(generate_trace(spec))``.
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        s_max: int,
        serving: ServingConfig | None = None,
        metrics: ServingMetrics | None = None,
        clock: Any = None,
        **batcher_kw: Any,
    ):
        self.cfg = cfg
        self.params = params
        self._w8_params = None   # the once-quantized serving banks
        self._fp8_params = None  # ... and the fp8 ones
        self.s_max = int(s_max)
        self.serving = (serving or ServingConfig()).validate()
        self.clock = clock if clock is not None else _retry.get_clock()
        self.metrics = metrics or ServingMetrics(slo=self.serving.slo)
        self._pending: deque[_ReqState] = deque()
        self._states: dict[Any, _ReqState] = {}
        self.results: dict[Any, Finished] = {}
        self._uid_counter = 0
        self._stopping = False
        for name in ("prefix_cache", "prefill_chunk_tokens"):
            if getattr(self.serving, name) is not None:
                batcher_kw[name] = getattr(self.serving, name)
        self._batcher = ContinuousBatcher(cfg, self._serving_params(), s_max=self.s_max,
                                          **batcher_kw)
        self._prefill_work_seen = 0
        self._t0 = self.clock.monotonic()

    def _serving_params(self):
        """The parameter tree the batcher serves (≙ ``_serving_params``,
        ``:445-491``): under an MoE config with ``gg_config.w8`` or ``.fp8``
        and float expert banks, the banks quantized once
        (``quantize_moe_serving_params``), cached per format, so no call
        quantizes on the fly; bit-identical to the on-the-fly path, which
        uses the same quantizer. Non-MoE trees, pre-quantized banks (a
        ``w_up_scale``) and non-float banks pass through unchanged (the last
        stay loud downstream)."""
        gg = getattr(self.cfg, "gg_config", None)
        if gg is None or not (gg.w8 or gg.fp8):
            return self.params
        layer = self.params["layers"][0] if self.params["layers"] else {}
        if ("w_up" not in layer or "w_up_scale" in layer
                or not layer["w_up"].is_floating_point()):
            return self.params
        if gg.fp8:
            if self._fp8_params is None:
                self._fp8_params = quantize_moe_serving_params(self.params, fmt="fp8")
            return self._fp8_params
        if self._w8_params is None:
            self._w8_params = quantize_moe_serving_params(self.params)
        return self._w8_params

    # -- submission / admission ----------------------------------------

    def submit(
        self,
        req: Request,
        *,
        arrival_t: float | None = None,
        priority: str = "interactive",
        deadline_ms: float | None = None,
    ):
        """Enqueue one request. Returns its uid, or a typed :class:`Rejected`
        when the bounded queue is full under the "reject" policy ("block"
        steps the engine until space frees). ``arrival_t`` backdates the
        enqueue timestamp to the offered arrival time; a ``deadline_ms``
        budget, measured from it, scores the request SLO-missed when it
        finishes late. ``priority`` is the overload controller's class
        (≙ ``:529``): it is accepted and inert here, since overload is not
        ported, and a rejection carries None in its place, as the
        reference's does without overload armed."""
        now = self.clock.monotonic() if arrival_t is None else float(arrival_t)
        if req.uid is None:
            req = dataclasses.replace(req, uid=f"r{self._uid_counter}")
            self._uid_counter += 1
        if req.uid in self._states or req.uid in self.results:
            raise ValueError(f"duplicate request uid {req.uid!r}")
        self._batcher.validate_request(req)
        self.metrics.count("submitted")
        if len(self._pending) >= self.serving.max_queue:
            if self.serving.backpressure == "reject":
                self.metrics.count("rejected")
                return Rejected(
                    req.uid, f"arrival queue full ({self.serving.max_queue})",
                    len(self._pending),
                )
            while len(self._pending) >= self.serving.max_queue:
                if not self._step_once():
                    raise RuntimeError(
                        "blocking submit cannot make progress: the arrival "
                        "queue is full but the engine is idle"
                    )
        st = _ReqState(
            req=req, t_enqueue=now,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
        )
        self._states[req.uid] = st
        self._pending.append(st)
        self._admit(self.clock.monotonic())
        return req.uid

    def _pop_admission(self) -> _ReqState:
        if self.serving.admission == "fcfs":
            return self._pending.popleft()
        best = min(
            range(len(self._pending)),
            key=lambda i: (len(self._pending[i].req.prompt), i),
        )
        st = self._pending[best]
        del self._pending[best]
        return st

    def _admit(self, now: float) -> None:
        while self._batcher.n_free_slots > 0 and self._pending:
            st = self._pop_admission()
            st.t_admitted = now
            self.metrics.count("admitted")
            self._batcher.submit(st.req)

    # -- the step loop --------------------------------------------------

    def _step_once(self) -> bool:
        """Admit + one batcher step. False when there is nothing to do."""
        self._admit(self.clock.monotonic())
        if self._batcher.idle:
            return False
        self._batcher.step()
        if self.serving.virtual_step_s:
            self.clock.sleep(self.serving.virtual_step_s)
        if self.serving.virtual_prefill_work_s:
            total = self._batcher.prefill_work_total
            delta = total - self._prefill_work_seen
            self._prefill_work_seen = total
            if delta > 0:
                self.clock.sleep(delta * self.serving.virtual_prefill_work_s)
        self._observe(self.clock.monotonic())
        return True

    def _observe(self, now: float) -> None:
        b = self._batcher
        self.metrics.observe_step(
            queue_depth=len(self._pending) + len(b.queue),
            occupied=b.n_active, slots=self.cfg.batch,
        )
        for i, r in enumerate(b.slot_req):
            if r is None:
                continue
            st = self._states[r.uid]
            if st.awaiting_first and b.slot_out[i]:
                self._record_first(st, now)
        for uid, toks in b.drain_finished():
            self._finalize(uid, toks, now)

    def _record_first(self, st: _ReqState, now: float) -> None:
        st.awaiting_first = False
        st.t_first = now
        self.metrics.observe_first_token((now - st.t_enqueue) * 1e3)

    def _finalize(self, uid: Any, toks: list, now: float) -> None:
        st = self._states.pop(uid)
        if st.awaiting_first and toks:
            # finished within its admission step (prefill one-shot or
            # instant EOS): the first token was never observed mid-slot
            self._record_first(st, now)
        tokens = list(toks)
        tpot_ms = (
            (now - st.t_first) / (len(toks) - 1) * 1e3 if len(toks) > 1 else None
        )
        deadline_ok = None
        if st.deadline is not None:
            deadline_ok = now <= st.deadline
            if not deadline_ok:
                self.metrics.count("deadline_missed")
        self.metrics.observe_finished(
            ttft_ms=(st.t_first - st.t_enqueue) * 1e3,
            e2e_ms=(now - st.t_enqueue) * 1e3, tpot_ms=tpot_ms,
            n_tokens=len(tokens), deadline_ok=deadline_ok,
        )
        if uid in self.results:
            raise RuntimeError(f"request {uid!r} finished twice")
        self.results[uid] = Finished(
            uid=uid, tokens=tokens, t_enqueue=st.t_enqueue,
            t_admitted=st.t_admitted, t_first_token=st.t_first,
            t_finished=now, resumed=0,
        )

    # -- driving --------------------------------------------------------

    def serve(self, traffic=(), *, max_steps: int = 1_000_000) -> dict:
        """Drive an iterable of :class:`~triton_dist_tpu_torch.serving.
        traffic.Arrival` through the engine until all offered traffic is
        ingested and — unless :meth:`stop` said otherwise — every request
        finished. Between work, the loop sleeps the (injectable) clock to
        the next arrival. Returns ``dict(self.results)``."""
        heap = [
            (a.t_s, seq, a) for seq, a in enumerate(sorted(traffic, key=lambda a: a.t_s))
        ]
        heapq.heapify(heap)
        steps = 0
        while True:
            now = self.clock.monotonic()
            if self._stopping and heap:
                for _ in heap:
                    self.metrics.count("cancelled")
                heap.clear()
            while heap and heap[0][0] <= now:
                _, _, a = heapq.heappop(heap)
                # arrival_t is the offered time: queueing delay accrued while
                # the host was mid-step still counts toward TTFT
                self.submit(
                    a.request, arrival_t=a.t_s,
                    deadline_ms=getattr(a, "deadline_ms", None),
                )
            if self._step_once():
                steps += 1
                if steps >= max_steps:
                    raise RuntimeError(
                        f"serve(max_steps={max_steps}) exhausted with work "
                        f"still in flight; finished results are intact in "
                        f"self.results"
                    )
                continue
            if heap:
                dt = heap[0][0] - self.clock.monotonic()
                if dt > 0:
                    self.clock.sleep(dt)
                continue
            return dict(self.results)

    def run_until_idle(self, max_steps: int = 1_000_000) -> dict:
        """Serve what is already queued or in flight (no new traffic)."""
        return self.serve((), max_steps=max_steps)

    def stop(self, drain: bool = True) -> None:
        """Stop ingesting new traffic. ``drain=True``: every enqueued request
        still runs to completion. ``drain=False``: the arrival queue is
        cancelled (counted); in-flight slots still finish."""
        self._stopping = True
        if not drain:
            while self._pending:
                st = self._pending.popleft()
                del self._states[st.req.uid]
                self.metrics.count("cancelled")

    # -- readout --------------------------------------------------------

    def snapshot(self) -> dict:
        """Serving metrics plus world/queue/clock facts; deterministic under
        a ``FakeClock``."""
        now = self.clock.monotonic()
        snap = self.metrics.snapshot()
        elapsed = max(now - self._t0, 1e-9)
        snap["tokens"]["per_s"] = round(self.metrics.tokens_generated / elapsed, 6)
        snap["tokens"]["goodput_per_s"] = round(
            self.metrics.tokens_goodput / elapsed, 6
        )
        snap["engine"] = {
            "world_size": self._batcher.world,
            "full_world_size": self._batcher.world,
            "rebuilds": 0,
            "queue_depth": len(self._pending),
            "in_flight": len(self._states) - len(self._pending),
            "prefill_bucket_programs": self._batcher.prefill_bucket_count,
            "clock_s": round(now - self._t0, 9),
        }
        px = self._batcher.prefix_cache_stats()
        if px is not None:
            # counters and gauges of the live batcher's cache (the engine
            # never rebuilds its batcher, so there is nothing to fold in)
            snap["prefix_cache"] = {k: px[k] for k in PX_COUNTERS + PX_GAUGES}
            snap["prefix_cache"]["hit_rate"] = round(px["hits"] / max(1, px["lookups"]), 6)
        return snap
