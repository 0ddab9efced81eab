"""Radix-shared paged KV prefix cache (≙ ``triton_dist_tpu/models/
prefix_cache.py``): host-side metadata over the paged pool, numpy only.

Production engines never prefill the same prefix twice: the paged cache
already makes sharing a prefix a metadata problem (two slots' block-table
rows naming the same physical pages), and this module is that metadata:

- **The trie**: one node per physical page of prompt KV, keyed by the
  page's token tuple; a root-to-node path is a token prefix (page
  granularity). Node depth ``g`` is the global logical page index, which
  pins the page to the rank owning positions ``[g*page, (g+1)*page)`` of
  the sequence-sharded pool, so every rank's table row holds exactly its
  own shard's entries.
- **Longest-prefix match at admission** (:meth:`PagePrefixCache.acquire`):
  every fully matched page is skipped by the prompt feed (the slot starts
  at ``pos = n_hit``). The match is capped at ``((len(prompt) - 1) //
  page) * page``, so at least one prompt token is always fed and the first
  generated token's KV lands in a private page.
- **Copy-on-write at the first divergent token**: the page holding it is
  claimed fresh and refilled by the ordinary feed; shared pages are never
  written.
- **Refcounts**: a reader references every node of its chain once, so
  ``parent.ref >= child.ref``. Release returns private pages to the pool
  and parks the slot's table row on the scratch page; ref-0 nodes are
  retained for future hits and evicted LRU-first only under pool pressure.
- **Publish-on-completion**: a page enters the trie only once its last
  position's KV is written; a second identical publish dedups onto the
  first's node.
- **Strike** (``release(strike=True)``): a poisoned slot's whole shared
  chain is detached and every other reader is reported. The serving side
  of the strike (the integrity tier's poisoned-slot eviction) is not
  ported yet, so the port's batcher never strikes.

Capacity: per rank the pool holds ``n_slots * pages_per_shard`` pages (+1
scratch); a slot's logical pages on one rank number at most
``pages_per_shard``, so evicting every ref-0 node always frees enough.

Beside the JAX package's module, the counters stay local: the JAX
package mirrors each into its observability metrics plane, which the port
does not have yet (a no-op there while the plane is disarmed), and the
fleet router's eviction listener stays with the fleet (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# counter keys (monotone; the serving engine folds them across batcher
# rebuilds) vs gauges (instantaneous; snapshots read the live batcher's)
PX_COUNTERS = (
    "lookups", "hits", "misses", "hit_pages", "prefill_tokens_saved",
    "cow_pages", "published_pages", "deduped_publishes", "evicted_pages",
    "struck_pages", "readers_struck",
)
PX_GAUGES = ("pages_shared", "shared_refs", "free_pages")


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Arms the radix prefix cache. ``None`` wherever this is accepted
    (``ServingConfig.prefix_cache``, ``ContinuousBatcher(prefix_cache=)``)
    means the engine without the cache, byte for byte.

    min_hit_pages: smallest fully-matched page count worth taking as a
        hit — below it the admission runs cold (no refs taken). 1 shares
        whatever it can; raise it when per-hit bookkeeping outweighs a
        one-page skip.
    """

    min_hit_pages: int = 1

    def validate(self) -> "PrefixCacheConfig":
        if self.min_hit_pages < 1:
            raise ValueError(
                f"min_hit_pages must be >= 1, got {self.min_hit_pages}"
            )
        return self


class _Node:
    """One shared physical page of prompt KV (see module docstring)."""

    __slots__ = ("tokens", "parent", "children", "phys", "depth", "ref",
                 "last_use", "detached")

    def __init__(self, tokens, parent, phys, depth):
        self.tokens = tokens          # the page's token tuple (child key)
        self.parent = parent
        self.children: dict = {}
        self.phys = int(phys)         # local page id on PE depth//pps_local
        self.depth = int(depth)       # global logical page index
        self.ref = 0                  # readers currently holding this page
        self.last_use = 0
        self.detached = False         # struck: unreachable, page freed at
                                      # last release

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"<page d{self.depth} phys{self.phys} ref{self.ref}"
                f"{' DETACHED' if self.detached else ''}>")


class PagePrefixCache:
    """Host-side radix index + page allocator over the paged pool.

    Owns the mirrored block table (``self.table``, ``[n_pes, n_slots,
    pps_local]`` int32 of PE-local physical page ids) the batcher pushes
    to the device whenever it changes. Global logical page ``g`` lives on
    PE ``g // pps_local`` at local index ``g % pps_local``; local
    physical ids ``0..n_slots*pps_local-1`` are allocatable, id
    ``n_slots*pps_local`` is the scratch page.
    """

    def __init__(self, cfg: PrefixCacheConfig, *, n_slots: int, page: int,
                 pps_local: int, n_pes: int):
        self.cfg = cfg.validate()
        self.n_slots = int(n_slots)
        self.page = int(page)
        self.pps_local = int(pps_local)
        self.pps_global = int(pps_local) * int(n_pes)
        self.n_pes = int(n_pes)
        self.n_pages = self.n_slots * self.pps_local   # allocatable, per PE
        self.scratch = self.n_pages                    # reserved id, per PE
        self.table = np.full(
            (self.n_pes, self.n_slots, self.pps_local), self.scratch,
            np.int32,
        )
        # LIFO free stacks (pop() hands out 0, 1, 2, ... deterministically)
        self._free = [
            list(range(self.n_pages - 1, -1, -1)) for _ in range(self.n_pes)
        ]
        self._root = _Node((), None, -1, -1)
        self._root.ref = 1 << 30      # the root is never evictable
        self._chain: list[list[_Node]] = [[] for _ in range(self.n_slots)]
        self._private: list[dict[int, int]] = [
            {} for _ in range(self.n_slots)
        ]
        self._next_pub = [0] * self.n_slots
        self._zombies: set = set()    # detached nodes still referenced
        self._clock = 0
        self._c = {k: 0 for k in PX_COUNTERS}

    # -- small helpers --------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        """One counter increment (local only: see the module docstring)."""
        self._c[key] += n

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _pe_of(self, g: int) -> int:
        return g // self.pps_local

    def _set(self, slot: int, g: int, phys: int) -> None:
        self.table[self._pe_of(g), slot, g % self.pps_local] = phys

    # -- allocation / eviction ------------------------------------------

    def _alloc(self, pe: int) -> int:
        if not self._free[pe]:
            self._evict_for(pe)
        return self._free[pe].pop()

    def _free_page(self, pe: int, phys: int) -> None:
        self._free[pe].append(int(phys))

    def _attached_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def _subtree_holds_pe(self, top: _Node, pe: int) -> bool:
        """Whether ``top``'s subtree owns a page on PE ``pe``. Depth grows
        monotonically down the tree, so branches past the PE's depth range
        prune."""
        hi = (pe + 1) * self.pps_local
        stack = [top]
        while stack:
            nd = stack.pop()
            if self._pe_of(nd.depth) == pe:
                return True
            if nd.depth + 1 < hi:
                stack.extend(nd.children.values())
        return False

    def _evict_for(self, pe: int) -> None:
        """Reclaim retained (ref-0) trie pages until PE ``pe`` has a free
        page: LRU-first over eviction roots (ref-0 nodes whose parent is
        still referenced) whose subtree actually OWNS a page on ``pe`` —
        starvation on one PE must not destroy retained prefixes that
        could never relieve it. Each eviction takes the whole —
        necessarily ref-0 — subtree; the module-docstring capacity
        argument guarantees a qualifying root exists (some ref-0 page
        lives on ``pe``, and its topmost ref-0 ancestor is a root whose
        subtree contains it)."""
        while not self._free[pe]:
            cand = None
            for nd in self._attached_nodes():
                if (nd.ref == 0 and nd.parent.ref > 0
                        and (cand is None
                             or (nd.last_use, nd.depth)
                             < (cand.last_use, cand.depth))
                        and self._subtree_holds_pe(nd, pe)):
                    cand = nd
            if cand is None:
                raise RuntimeError(
                    f"prefix cache: PE {pe} free pool empty with no "
                    f"evictable trie page — page accounting bug "
                    f"(free={[len(f) for f in self._free]})"
                )
            self._evict_subtree(cand)

    def _evict_subtree(self, top: _Node) -> None:
        top.parent.children.pop(top.tokens)
        stack = [top]
        while stack:
            nd = stack.pop()
            if nd.ref != 0:
                raise RuntimeError(
                    "evicting a referenced page — refcount monotonicity broken"
                )
            self._free_page(self._pe_of(nd.depth), nd.phys)
            self._bump("evicted_pages")
            stack.extend(nd.children.values())
            nd.children = {}

    # -- the admission-side API -----------------------------------------

    def acquire(self, slot: int, prompt, max_new_tokens: int) -> int:
        """Longest-prefix match + page plan for one admission. Increments
        refcounts along the matched chain, allocates private pages for
        every logical page the request can touch past it, and writes the
        slot's table row. Returns ``n_hit`` — the number of prompt tokens
        whose KV is already in shared pages (the feed starts at
        ``pos = n_hit``)."""
        if self._chain[slot] or self._private[slot]:
            raise RuntimeError(
                f"slot {slot} re-acquired without release — slot lifecycle "
                f"bug"
            )
        prompt = [int(t) for t in prompt]
        pg = self.page
        L = len(prompt)
        self._bump("lookups")
        cap_pages = (L - 1) // pg      # keep >= 1 fed token (docstring)
        node, chain = self._root, []
        while len(chain) < cap_pages:
            key = tuple(prompt[len(chain) * pg:(len(chain) + 1) * pg])
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child)
            node = child
        if len(chain) < self.cfg.min_hit_pages:
            chain = []
        for nd in chain:
            nd.ref += 1
            nd.last_use = self._tick()
        n_hit = len(chain) * pg
        if chain:
            self._bump("hits")
            self._bump("hit_pages", len(chain))
            self._bump("prefill_tokens_saved", n_hit)
        else:
            self._bump("misses")
        # every logical page the request can touch: validate_request pinned
        # L + max_new <= s_max, so needed never exceeds pps_global
        needed = min(-(-(L + max_new_tokens) // pg), self.pps_global)
        priv: dict[int, int] = {}
        for g in range(len(chain), needed):
            priv[g] = self._alloc(self._pe_of(g))
            if chain and g == len(chain):
                # the CoW page proper: the one claimed fresh at the first
                # divergent token (later privates exist for generation)
                self._bump("cow_pages")
        for g, nd in enumerate(chain):
            self._set(slot, g, nd.phys)
        for g, phys in priv.items():
            self._set(slot, g, phys)
        self._chain[slot] = chain
        self._private[slot] = priv
        self._next_pub[slot] = len(chain)
        return n_hit

    def next_publish(self, slot: int) -> int:
        return self._next_pub[slot]

    def publish(self, slot: int, g: int, tokens) -> bool:
        """Move slot ``slot``'s now-fully-written prompt page ``g`` into
        the trie (publish-on-completion). If an identical page was
        published meanwhile, dedup onto it (our copy returns to the pool,
        the table row repoints — same bits). Returns True iff the device
        table changed."""
        chain = self._chain[slot]
        if g != len(chain) or g not in self._private[slot]:
            raise RuntimeError(
                f"slot {slot} published page {g} out of order "
                f"(chain depth {len(chain)})"
            )
        key = tuple(int(t) for t in tokens)
        if len(key) != self.page:
            raise ValueError(
                f"published page must carry exactly {self.page} tokens, "
                f"got {len(key)}"
            )
        parent = chain[-1] if chain else self._root
        phys = self._private[slot].pop(g)
        node = parent.children.get(key)
        self._next_pub[slot] = g + 1
        if node is not None:
            # a concurrent identical producer won the race: drop our copy
            self._free_page(self._pe_of(g), phys)
            node.ref += 1
            node.last_use = self._tick()
            chain.append(node)
            self._set(slot, g, node.phys)
            self._bump("deduped_publishes")
            return True
        node = _Node(key, parent, phys, g)
        node.ref = 1                  # the publisher reads its own page
        node.last_use = self._tick()
        parent.children[key] = node
        chain.append(node)
        self._bump("published_pages")
        return False

    def release(self, slot: int, strike: bool = False) -> list[int]:
        """Release slot ``slot``'s pages (finish / cancel / poison):
        decrement its chain refcounts, return its private pages to the
        pool, and point its table row at scratch. ``strike=True`` (the
        slot was poisoned) additionally detaches its ENTIRE shared chain
        from the trie — no future match can serve a possibly-corrupt page
        — and returns every OTHER slot referencing a struck page, for the
        batcher to evict into a cold re-prefill."""
        readers: list[int] = []
        chain = self._chain[slot]
        if strike and chain:
            top = chain[0]
            self._detach_subtree(top)
            for j in range(self.n_slots):
                if j != slot and self._chain[j] and self._chain[j][0] is top:
                    readers.append(j)
            self._bump("readers_struck", len(readers))
        for nd in chain:
            nd.ref -= 1
            if nd.ref == 0 and nd.detached:
                self._free_page(self._pe_of(nd.depth), nd.phys)
                self._zombies.discard(nd)
        for g, phys in self._private[slot].items():
            self._free_page(self._pe_of(g), phys)
        self._chain[slot] = []
        self._private[slot] = {}
        self._next_pub[slot] = 0
        self.table[:, slot, :] = self.scratch
        return readers

    def _detach_subtree(self, top: _Node) -> None:
        top.parent.children.pop(top.tokens)
        stack = [top]
        while stack:
            nd = stack.pop()
            nd.detached = True
            self._bump("struck_pages")
            stack.extend(nd.children.values())
            nd.children = {}
            if nd.ref == 0:
                self._free_page(self._pe_of(nd.depth), nd.phys)
            else:
                self._zombies.add(nd)

    # -- readout / invariants -------------------------------------------

    def stats(self) -> dict:
        n_attached, refs = 0, 0
        for nd in self._attached_nodes():
            n_attached += 1
            refs += nd.ref
        out = dict(self._c)
        out["hit_rate"] = round(
            self._c["hits"] / max(1, self._c["lookups"]), 6
        )
        out["pages_shared"] = n_attached
        out["shared_refs"] = refs
        out["free_pages"] = sum(len(f) for f in self._free)
        return out

    def audit(self) -> None:
        """Assert the page-accounting invariant (tests): per PE, free ∪
        attached-trie ∪ zombie ∪ private pages partition the allocatable
        pool — every page owned exactly once, no leaks, no double-owns."""
        owned: list[dict[int, str]] = [dict() for _ in range(self.n_pes)]

        def own(pe, phys, what):
            assert 0 <= phys < self.n_pages, (pe, phys, what)
            assert phys not in owned[pe], (
                f"page {phys} on PE {pe} owned twice: "
                f"{owned[pe][phys]} and {what}"
            )
            owned[pe][phys] = what

        for pe in range(self.n_pes):
            for phys in self._free[pe]:
                own(pe, phys, "free")
        for nd in self._attached_nodes():
            own(self._pe_of(nd.depth), nd.phys, f"trie:{nd!r}")
        for nd in self._zombies:
            own(self._pe_of(nd.depth), nd.phys, f"zombie:{nd!r}")
        for slot in range(self.n_slots):
            for g, phys in self._private[slot].items():
                own(self._pe_of(g), phys, f"private:slot{slot}:g{g}")
        for pe in range(self.n_pes):
            assert len(owned[pe]) == self.n_pages, (
                f"PE {pe}: {self.n_pages - len(owned[pe])} page(s) leaked"
            )
        # chain refcounts: every page refcounted exactly once per reader
        want: dict[int, int] = {}
        for slot in range(self.n_slots):
            for nd in self._chain[slot]:
                want[id(nd)] = want.get(id(nd), 0) + 1
        for nd in self._attached_nodes():
            assert nd.ref == want.get(id(nd), 0), (
                f"{nd!r}: ref {nd.ref} != {want.get(id(nd), 0)} readers"
            )
        for nd in self._zombies:
            assert nd.ref == want.get(id(nd), 0) and nd.ref > 0, nd
