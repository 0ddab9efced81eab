"""Serving-side decode for the dense transformer (≙ ``triton_dist_tpu/
models/decode.py``) at world 1: the KV cache strategies, one decode step,
the bulk prefill, greedy ``generate`` and the ``ContinuousBatcher``.

Decode projections are plain ``h @ W`` (the JAX package leaves them to
XLA); attention goes through the K2 (contiguous cache) or K3 (paged cache)
flash-decode kernels via the spec's ``update_and_attend``. Prefill runs
the full forward (K1 GEMMs) and writes every prompt position's K/V in one
pass. The cache is updated IN PLACE (the JAX package donates the old cache
buffer instead; in place saves the same copy), and each function still
returns it so call sites read like the reference.

At world 1 one rank owns every position below ``s_max``; a position at or
past ``s_max`` is owned by no rank, so its write is dropped — the JAX
package's ownership rule, kept so parked rows behave alike.

Later slices: prefix caching, chunked and ranged prefill, hierarchical
EP serving (these raise ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from triton_dist_tpu_torch.config import resolve_device
from triton_dist_tpu_torch.models.tp_transformer import (
    TPTransformer,
    TransformerConfig,
    apply_rope,
    rmsnorm,
    rope_tables,
)
from triton_dist_tpu_torch.ops.flash_decode import (
    FlashDecodeConfig,
    flash_decode_distributed,
    paged_flash_decode_distributed,
)


@dataclasses.dataclass(frozen=True)
class _StepPlan:
    """What one decode step's cache writes and attention need, computed once
    for all layers from the step's positions: the owned rows (positions
    below ``s_max``; a slice when every row owns its position), where each
    owned row's new k/v lands in one layer's cache, and the valid lengths
    after the write."""

    rows: Any
    at: tuple
    lens: torch.Tensor


def _rows_and_lens(pos_h: np.ndarray, s_max: int, device):
    own = pos_h < s_max
    rows = slice(None) if own.all() else torch.as_tensor(np.flatnonzero(own), device=device)
    lens = torch.as_tensor(np.clip(pos_h + 1, 0, s_max).astype(np.int32), device=device)
    return rows, lens


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Contiguous cache: per layer ``[b, h_kv, s_max, d]``. The spec is also
    the cache STRATEGY: ``pre_step``, ``step_plan`` and ``update_and_attend``
    are the only places decode touches the cache."""

    s_max: int

    def init(self, cfg: TransformerConfig, device) -> dict:
        shape = (cfg.n_layers, cfg.batch, cfg.n_kv_heads, self.s_max, cfg.head_dim)
        return dict(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        )

    def pre_step(self, cfg, cache: dict, pos_b) -> dict:
        return cache

    def step_plan(self, cfg, cache, pos_h: np.ndarray, pos_b) -> _StepPlan:
        rows, lens = _rows_and_lens(pos_h, self.s_max, pos_b.device)
        bidx = torch.arange(cfg.batch, device=pos_b.device)
        return _StepPlan(rows, (bidx[rows], slice(None), pos_b[rows]), lens)

    def update_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config):
        """Append each owned sequence's k/v at ITS position (ragged), then
        flash-decode over the valid prefix. Returns ``(attn [b, hq, d] f32,
        cache)``."""
        kc, vc = cache["k"][li], cache["v"][li]
        kc[plan.at] = k_new[plan.rows].to(kc.dtype)
        vc[plan.at] = v_new[plan.rows].to(vc.dtype)
        attn = flash_decode_distributed(q.to(kc.dtype), kc, vc, plan.lens, config=fd_config)
        return attn, cache


@dataclasses.dataclass(frozen=True)
class PagedKVCacheSpec:
    """Paged cache: a page POOL ``[L, n_pages, h_kv, page, d]`` plus a
    per-sequence block table ``[1, b, pages_per_seq]``. ``static_table``
    pre-assigns each slot its own page range (what continuous batching and
    the bulk prefill need); otherwise a bump allocator hands out a page the
    first time a position opens one."""

    s_max: int
    page_size: int
    static_table: bool = False

    def _geometry(self, cfg) -> tuple[int, int]:
        if self.s_max % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide s_max={self.s_max}"
            )
        pages_per_seq = self.s_max // self.page_size
        return pages_per_seq, cfg.batch * pages_per_seq

    def init(self, cfg: TransformerConfig, device) -> dict:
        pps, n_pages = self._geometry(cfg)
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, self.page_size, cfg.head_dim)
        if self.static_table:
            bt = (
                torch.arange(cfg.batch, dtype=torch.int32, device=device)[:, None] * pps
                + torch.arange(pps, dtype=torch.int32, device=device)[None, :]
            )[None]
        else:
            bt = torch.zeros((1, cfg.batch, pps), dtype=torch.int32, device=device)
        return dict(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            block_table=bt.contiguous(),
            n_alloc=torch.zeros((1,), dtype=torch.int32, device=device),
        )

    def pre_step(self, cfg, cache: dict, pos_b) -> dict:
        """Bump-allocate a physical page for each sequence whose position
        opens a new logical page (ragged: the needing sequences claim
        consecutive ids, in slot order)."""
        if self.static_table:
            return cache
        need = (pos_b < self.s_max) & (pos_b % self.page_size == 0)
        need_i = need.to(torch.int32)
        order = torch.cumsum(need_i, 0, dtype=torch.int32) - need_i
        bidx = torch.arange(cfg.batch, device=pos_b.device)
        page_idx = (pos_b % self.s_max) // self.page_size
        bt = cache["block_table"]
        cur = bt[0, bidx, page_idx]
        bt[0, bidx, page_idx] = torch.where(need, cache["n_alloc"][0] + order, cur)
        cache["n_alloc"] += need.sum().to(torch.int32)
        return cache

    def step_plan(self, cfg, cache, pos_h: np.ndarray, pos_b) -> _StepPlan:
        """Reads the block table after ``pre_step`` allocated this step's
        pages."""
        rows, lens = _rows_and_lens(pos_h, self.s_max, pos_b.device)
        pos = pos_b[rows]
        bidx = torch.arange(cfg.batch, device=pos_b.device)[rows]
        pages = cache["block_table"][0][bidx, pos // self.page_size].long()
        return _StepPlan(rows, (pages, slice(None), pos % self.page_size), lens)

    def update_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config):
        kc, vc = cache["k"][li], cache["v"][li]
        kc[plan.at] = k_new[plan.rows].to(kc.dtype)
        vc[plan.at] = v_new[plan.rows].to(vc.dtype)
        attn = paged_flash_decode_distributed(
            q.to(kc.dtype), kc, vc, plan.lens, cache["block_table"][0],
        )
        return attn, cache


def decode_step(
    cfg: TransformerConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,   # [b] int — this step's input token per sequence
    pos,                    # int or [b] int on the host — position per sequence
    *,
    spec: KVCacheSpec | PagedKVCacheSpec,
    fd_config: FlashDecodeConfig | None = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step: returns ``(logits [b, vocab], cache)``. Positions are
    host data, so which rows own their position (``< s_max``) is decided on
    the host and the step never waits on the card; what depends only on the
    positions (RoPE tables, cache-write indices, valid lengths) is computed
    once for all layers."""
    c = cfg
    g = c.n_q_heads // c.n_kv_heads
    d = c.head_dim
    dev = tokens.device
    pos_h = np.array(np.broadcast_to(np.asarray(pos, dtype=np.int64), (c.batch,)))
    pos_b = torch.as_tensor(pos_h, device=dev)
    tokens = tokens.long()
    x = params["embed"][tokens]                          # [b, H]
    cache = spec.pre_step(c, cache, pos_b)
    plan = spec.step_plan(c, cache, pos_h, pos_b)
    cos, sin = rope_tables(pos_b[:, None], d, c.rope_theta)
    for li, p in enumerate(params["layers"]):
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        qkv = (h @ p["wqkv"].reshape(c.hidden, -1)).reshape(c.batch, c.n_kv_heads, g + 2, d)
        q = qkv[:, :, :g, :].reshape(c.batch, 1, c.n_q_heads, d)
        k_new = qkv[:, :, g, :].reshape(c.batch, 1, c.n_kv_heads, d)
        v_new = qkv[:, :, g + 1, :]                      # [b, h_kv, d]
        q = apply_rope(q, cos, sin)[:, 0]                # [b, hq, d]
        k_new = apply_rope(k_new, cos, sin)[:, 0]        # [b, h_kv, d]
        attn, cache = spec.update_and_attend(
            c, cache, li, k_new, v_new, q, plan, fd_config
        )
        attn = attn.reshape(c.batch, -1).to(x.dtype)
        x = x + attn @ p["wo"]
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        gu = (h @ p["w_gate_up"].reshape(c.hidden, -1)).reshape(c.batch, -1, 2)
        act = torch.nn.functional.silu(gu[..., 0].float()).to(x.dtype) * gu[..., 1]
        x = x + act @ p["w_down"]
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    return x @ params["lm_head"], cache


def prefill_cache(
    cfg, params, cache, prompt_flat, spec, s_max, slot_mask=None, pick=None
):
    """Bulk prefill: the full forward over the flattened prompt (``cfg.batch
    * cfg.seq`` tokens, batch-major) writes every position's post-RoPE k/v
    into the cache in one pass, positions ``[L, s_max)`` zeroed. A paged
    cache needs the static table: each slot's page range is written whole.
    ``slot_mask [b] bool`` (host) restricts the write to chosen sequences;
    ``pick [b]`` chooses each sequence's logit row (default ``L-1``). Returns
    ``(cache, last_logits [b, vocab])``."""
    paged = isinstance(spec, PagedKVCacheSpec)
    if paged and not spec.static_table:
        raise ValueError(
            "paged prefill needs static_table=True (pre-assigned page "
            "ranges): the bump allocator cannot batch-claim a prompt"
        )
    c = cfg
    b, L = c.batch, c.seq
    dev = prompt_flat.device
    model = TPTransformer(c, kv_sink=[])
    logits = model(prompt_flat.long(), params)          # [b*L, V]
    sel = torch.as_tensor(
        np.arange(b) if slot_mask is None else np.flatnonzero(np.asarray(slot_mask)),
        device=dev,
    )
    for li, (k_l, v_l) in enumerate(model.kv_sink):
        kd = cache["k"].dtype
        # [b, L, h_kv, d] → this slot's window [0, s_max), zero past L
        k_new = torch.zeros((b, c.n_kv_heads, s_max, c.head_dim), dtype=kd, device=dev)
        v_new = torch.zeros_like(k_new)
        k_new[:, :, :L] = k_l.transpose(1, 2)
        v_new[:, :, :L] = v_l.transpose(1, 2)
        if paged:
            ps = spec.page_size
            pps = s_max // ps
            kp = k_new.reshape(b, c.n_kv_heads, pps, ps, c.head_dim).transpose(1, 2)
            vp = v_new.reshape(b, c.n_kv_heads, pps, ps, c.head_dim).transpose(1, 2)
            ids = cache["block_table"][0][sel].long().reshape(-1)
            cache["k"][li, ids] = kp[sel].reshape(-1, *kp.shape[2:])
            cache["v"][li, ids] = vp[sel].reshape(-1, *vp.shape[2:])
        else:
            cache["k"][li, sel] = k_new[sel]
            cache["v"][li, sel] = v_new[sel]
    if pick is None:
        pick = torch.full((b,), L - 1, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev) * L + torch.clamp(pick.to(dev).long(), 0, L - 1)
    return cache, logits[rows]


def _make_spec(s_max, page_size, fd_config, static_table):
    if page_size and fd_config is not None:
        raise ValueError(
            "fd_config tiles the contiguous kernel; with page_size the page "
            "is the block — pass one or the other"
        )
    if page_size:
        return PagedKVCacheSpec(s_max, page_size, static_table=static_table)
    return KVCacheSpec(s_max)


def generate(
    cfg: TransformerConfig,
    params: dict,
    prompt,              # [b, prompt_len] int
    n_steps: int,
    *,
    s_max: int,
    page_size: int | None = None,
    fd_config: FlashDecodeConfig | None = None,
    prefill: bool = False,
    device=None,
) -> torch.Tensor:
    """Greedy generation: process the prompt (token by token, or in one
    bulk forward with ``prefill=True``), then decode ``n_steps`` new
    tokens. Returns ``[b, n_steps]`` int32 on `device`."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=dev)
    b, prompt_len = prompt.shape
    if b != cfg.batch:
        raise ValueError(f"prompt batch {b} != cfg.batch {cfg.batch}")
    if prompt_len + n_steps > s_max:
        raise ValueError(
            f"prompt_len={prompt_len} + n_steps={n_steps} exceeds the KV "
            f"cache capacity s_max={s_max}"
        )
    spec = _make_spec(s_max, page_size, fd_config, static_table=prefill)
    params = _to_device(params, dev)
    cache = spec.init(cfg, dev)
    with torch.inference_mode():
        if prefill:
            pcfg = dataclasses.replace(cfg, seq=prompt_len)
            cache, last = prefill_cache(pcfg, params, cache, prompt.reshape(-1), spec, s_max)
            tok = last.argmax(dim=-1)
            outs = [tok]
            for i in range(n_steps - 1):
                logits, cache = decode_step(
                    cfg, params, cache, tok, prompt_len + i, spec=spec, fd_config=fd_config
                )
                tok = logits.argmax(dim=-1)
                outs.append(tok)
            return torch.stack(outs, dim=1)[:, :n_steps].to(torch.int32)
        tok = prompt[:, 0]
        outs = []
        for i in range(prompt_len + n_steps - 1):
            logits, cache = decode_step(
                cfg, params, cache, tok, i, spec=spec, fd_config=fd_config
            )
            nxt = logits.argmax(dim=-1)
            outs.append(nxt)
            tok = prompt[:, i + 1] if i + 1 < prompt_len else nxt
        return torch.stack(outs[prompt_len - 1:], dim=1).to(torch.int32)


def _to_device(params: dict, dev: torch.device) -> dict:
    return dict(
        embed=params["embed"].to(dev),
        layers=[{k: v.to(dev) for k, v in p.items()} for p in params["layers"]],
        final_norm=params["final_norm"].to(dev),
        lm_head=params["lm_head"].to(dev),
    )


@dataclasses.dataclass
class Request:
    """One generation request for :class:`ContinuousBatcher`.

    Sampling: greedy by default; ``temperature > 0`` samples from the
    softmax (optionally truncated to the ``top_k`` most likely tokens),
    reproducibly per request via ``seed`` — each slot owns an independent
    numpy RNG, so a request's tokens do not depend on what shares the batch
    with it. ``rng`` overrides the seed-derived RNG with a live
    ``np.random.Generator``."""

    prompt: list            # token ids, len >= 1
    max_new_tokens: int
    eos_id: int | None = None
    temperature: float = 0.0
    top_k: int | None = None
    seed: int | None = None
    uid: Any = None
    rng: Any = None

    def dist(self, logits) -> np.ndarray:
        """The sampling distribution (float64 probs) for a [vocab] f32 logit
        row. Requires ``temperature > 0``."""
        z = logits.astype(np.float64) / self.temperature
        if self.top_k is not None:
            k = min(self.top_k, len(z))
            keep = np.argpartition(z, -k)[-k:]   # exactly k indices: ties
            mask = np.full_like(z, -np.inf)      # beyond k drop, so top_k=1
            mask[keep] = z[keep]                 # stays greedy
            z = mask
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        return probs

    def sample(self, logits, rng) -> int:
        """Pick the next token from a [vocab] f32 logit row."""
        if self.temperature <= 0.0:
            return int(logits.argmax())
        probs = self.dist(logits)
        return int(rng.choice(len(probs), p=probs))


class StepsExhaustedError(RuntimeError):
    """``ContinuousBatcher.run`` spent its step budget with work still in
    flight. Finished generations stay drainable via
    :meth:`ContinuousBatcher.drain_finished`."""

    def __init__(self, max_steps: int, pending_uids, finished_uids):
        self.max_steps = int(max_steps)
        self.pending_uids = tuple(pending_uids)
        self.finished_uids = tuple(finished_uids)
        super().__init__(
            f"run(max_steps={max_steps}) exhausted with requests still "
            f"in flight: {list(self.pending_uids)}; "
            f"{len(self.finished_uids)} finished generation(s) "
            f"{list(self.finished_uids)} are retained — collect them with "
            f"drain_finished()"
        )


class ContinuousBatcher:
    """Continuous batching over the ragged decode step: the device runs one
    decode step for every slot (static shapes, per-slot positions); the host
    picks each slot's next token (prompt feed, argmax or sample), admits
    queued requests into free slots, and collects finished sequences.
    ``prefill=True`` admits a prompt in one bulk forward (K1 GEMMs) instead
    of token by token; ``page_size`` selects the paged cache (K3 decode),
    otherwise the contiguous one (K2).

        batcher = ContinuousBatcher(cfg, params, s_max=256)
        batcher.submit(Request([1, 2, 3], max_new_tokens=8))
        done = batcher.run()
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        params: dict,
        *,
        s_max: int,
        page_size: int | None = None,
        fd_config: FlashDecodeConfig | None = None,
        prefill: bool = False,
        prefill_chunk_tokens: int | None = None,
        prefix_cache: Any = None,
        device=None,
    ):
        if prefix_cache is not None:
            raise NotImplementedError("prefix caching is a later slice (ROADMAP A9)")
        if prefill_chunk_tokens is not None:
            raise NotImplementedError("chunked prefill is a later slice (ROADMAP A8)")
        self.device = resolve_device(device)
        self.cfg, self.s_max = cfg, s_max
        self.prefill = prefill
        self._fd_config = fd_config
        # static tables: slots reset mid-run, which the bump allocator
        # cannot reclaim
        self.spec = _make_spec(s_max, page_size, fd_config, static_table=True)
        self.cache = self.spec.init(cfg, self.device)
        self.params = _to_device(params, self.device)
        self._buckets: set[int] = set()
        # cumulative real prompt tokens through the bulk prefill, and the
        # prefill WORK in swept query x key token pairs (bucket x bucket per
        # admission) that the serving engine's prefill charge bills
        self.prefill_tokens_total = 0
        self.prefill_work_total = 0
        b = cfg.batch
        self.pos = np.zeros(b, np.int32)        # next write position per slot
        self.tok = np.zeros(b, np.int32)        # next input token per slot
        self.slot_req: list[Request | None] = [None] * b
        self.slot_rng: list[Any] = [None] * b
        self.slot_fed: list[int] = [0] * b      # prompt tokens already fed
        self.slot_out: list[list] = [[] for _ in range(b)]
        self.queue: list[Request] = []
        self.finished: list[tuple[Any, list]] = []

    def validate_request(self, req: Request) -> None:
        """Admissibility checks (the serving engine runs them at enqueue)."""
        if not req.prompt:
            raise ValueError("empty prompt (need at least one token)")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.top_k is not None and req.top_k < 1:
            raise ValueError("top_k must be >= 1 (or None)")
        if len(req.prompt) + req.max_new_tokens > self.s_max:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"exceeds s_max={self.s_max}"
            )

    def submit(self, req: Request) -> None:
        self.validate_request(req)
        self.queue.append(req)

    def _bucket(self, length: int) -> int:
        """Padded prompt length: the next power of two, capped at s_max."""
        bucket = 1
        while bucket < min(length, self.s_max):
            bucket *= 2
        return min(bucket, self.s_max)

    def _admit_prefill(self, i: int, req: Request) -> None:
        """One masked full-forward pass writes slot ``i``'s whole prompt KV
        and yields its first generated token."""
        L = len(req.prompt)
        bucket = self._bucket(L)
        prompt = np.zeros((self.cfg.batch, bucket), np.int64)
        prompt[i, :L] = req.prompt
        pick = np.zeros(self.cfg.batch, np.int64)
        pick[i] = L - 1
        pcfg = dataclasses.replace(self.cfg, seq=bucket)
        dev = self.device
        with torch.inference_mode():
            self.cache, last = prefill_cache(
                pcfg, self.params, self.cache,
                torch.as_tensor(prompt.reshape(-1), device=dev), self.spec,
                self.s_max, slot_mask=np.arange(self.cfg.batch) == i,
                pick=torch.as_tensor(pick, device=dev),
            )
        self._buckets.add(bucket)
        self.prefill_tokens_total += L
        self.prefill_work_total += bucket * bucket
        t0 = req.sample(last[i].float().cpu().numpy(), self.slot_rng[i])
        self.slot_fed[i] = L
        self.slot_out[i] = [t0]
        self.tok[i] = t0
        self.pos[i] = L
        if len(self.slot_out[i]) >= req.max_new_tokens or (
            req.eos_id is not None and t0 == req.eos_id
        ):
            self.finished.append((req.uid, self.slot_out[i]))
            self.slot_req[i] = None

    def _admit(self) -> None:
        # an admission can free the slot it just filled (max_new_tokens=1 or
        # instant EOS): re-pass until a full sweep admits nothing
        admitted = True
        while admitted and self.queue:
            admitted = False
            for i, r in enumerate(self.slot_req):
                if r is None and self.queue:
                    req = self.queue.pop(0)
                    admitted = True
                    self.slot_req[i] = req
                    self.slot_out[i] = []
                    self.slot_rng[i] = (
                        req.rng if req.rng is not None
                        else np.random.default_rng(req.seed)
                    )
                    if self.prefill and len(req.prompt) > 1:
                        self._admit_prefill(i, req)
                    else:
                        self.pos[i] = 0
                        self.tok[i] = req.prompt[0]
                        self.slot_fed[i] = 1

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    @property
    def n_free_slots(self) -> int:
        """Slots a new submission could claim: idle slots minus what the
        admission queue will absorb first."""
        free = sum(r is None for r in self.slot_req)
        return max(0, free - len(self.queue))

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def prefill_bucket_count(self) -> int:
        """Distinct padded prefill lengths run so far (the JAX package
        compiles one program per bucket; the gauge keeps its meaning)."""
        return len(self._buckets)

    def drain_finished(self) -> list[tuple[Any, list]]:
        """Hand over (and clear) every finished ``(uid, tokens)``."""
        out, self.finished = self.finished, []
        return out

    def step(self) -> None:
        """One ragged decode step for every slot + host scheduling."""
        self._admit()
        if self.idle:
            return
        self._decode_round()

    def _decode_round(self) -> None:
        dev = self.device
        with torch.inference_mode():
            logits, self.cache = decode_step(
                self.cfg, self.params, self.cache,
                torch.as_tensor(self.tok, device=dev), self.pos,
                spec=self.spec, fd_config=self._fd_config,
            )
            # greedy slots need only the argmax; the full logit rows cross
            # to the host only when an active request samples
            nxt = logits.argmax(dim=-1).cpu().numpy()
            sampling = any(
                r is not None and r.temperature > 0.0
                and self.slot_fed[i] >= len(r.prompt)
                for i, r in enumerate(self.slot_req)
            )
            logits_h = logits.float().cpu().numpy() if sampling else None
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue  # idle slot decoded a dummy token; ignore
            if self.slot_fed[i] < len(req.prompt):
                self.tok[i] = req.prompt[self.slot_fed[i]]
                self.slot_fed[i] += 1
            else:
                t = (
                    int(nxt[i]) if req.temperature <= 0.0
                    else req.sample(logits_h[i], self.slot_rng[i])
                )
                self.slot_out[i].append(t)
                self.tok[i] = t
                if len(self.slot_out[i]) >= req.max_new_tokens or (
                    req.eos_id is not None and t == req.eos_id
                ):
                    self.finished.append((req.uid, self.slot_out[i]))
                    self.slot_req[i] = None
                    continue
            self.pos[i] += 1

    def run(self, max_steps: int = 100000) -> list[tuple[Any, list]]:
        """Drive until every queued request finishes; returns ``[(uid,
        tokens), ...]`` in completion order, or raises
        :class:`StepsExhaustedError`."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        if not self.idle:
            pending = [r.uid for r in self.slot_req if r is not None] + [
                r.uid for r in self.queue
            ]
            raise StepsExhaustedError(
                max_steps, pending, [uid for uid, _ in self.finished]
            )
        return self.drain_finished()
