"""Serve-side memory policy: prefix sharing, page eviction, preemption.

The policy layer above `repro_torch.serve.cache` (a plain-Python copy of
repro.serve.memory). A `CacheStore` rations a fixed page pool
mechanically — refcounts, free list, block tables — but leaves three
decisions open that turn the pool into throughput when millions of
requests share the same system prompt (the ROADMAP's production memory
manager):

  sharing     a **prefix index** — a trie at page granularity keyed by
              page-sized token runs — maps a request's longest cached
              prefix onto existing pages. Full pages are shared in place
              (refcount bumped, zero copies); a trailing *partial* page is
              shared only when the whole prompt matched through it, and
              then by **copy-on-write**: the admitting slot gets a device
              copy it may write generated tokens into, while the indexed
              original stays immutable for the next sharer. Prefill skips
              writing matched pages (the Scheduler passes skip_pages to
              `Engine.prefill_into`) — shared prefixes cost pages once,
              not once per request.

  eviction    retired requests leave their indexed prompt pages *cold*:
              resident and matchable, refcount zero. Under pool pressure
              `make_room` releases cold pages leaf-first in LRU order of
              their `last_touch` decode-step stamp. A prompt readmitted
              after its pages were evicted simply recomputes its prefill
              (recompute-on-readmit, counted in `readmit_recomputes`) —
              eviction can cost latency, never correctness.

  preemption  when even eviction cannot make room, `victim` picks an
              in-flight request to kick: fewest generated tokens (the
              cheapest replay) under FIFO, most deadline slack under the
              "deadline" policy. The Scheduler releases its pages and
              requeues it at the front; token picks are keyed by
              (sample_seed, rid, k), so the replayed stream is
              bit-identical to the uninterrupted one.

Families without a full-attention KV pool (all-windowed, RWKV/SSD-only
state is fixed-size per slot) have nothing to share, evict or preempt
for: the manager is **inert** there — matches always miss, every counter
stays 0, and admission gating degenerates to the store's always-true
`can_alloc`.

Bit-identity invariant: a shared page holds exactly the K/V the sharer's
own prefill would have computed (same tokens, same positions, same
params), writes into shared or retained pages are forbidden (CoW first),
and replay regenerates token streams from the prompt under per-rid
sampling keys — so `share_prefix`/`evict`/`preempt` never change a single
emitted token, only the page accounting underneath.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.cache import CacheStore


class _Node:
    """One indexed page: the page holding the `ntok` prompt positions
    that extend the chain reaching it from the root. Full pages
    (ntok == page_size) chain on through `children`; partial pages are
    leaves by construction — a prefix can only continue from a page
    boundary."""

    __slots__ = ("tokens", "page", "ntok", "parent", "children", "partial",
                 "last_touch")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens        # this page's token run (len == ntok)
        self.page = page
        self.ntok = len(tokens)
        self.parent = parent
        self.children: dict = {}    # full-page runs -> _Node
        self.partial: dict = {}     # shorter trailing runs -> _Node
        self.last_touch = 0


class PrefixIndex:
    """Token trie at page granularity over a CacheStore's KV pool.

    Each node owns one physical page and the exact token run it holds;
    a path from the root spells a prompt prefix and the page chain that
    caches it. The index retains its pages in the store (cold at
    refcount zero), and eviction removes leaf nodes first so an indexed
    chain never dangles."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self.root = _Node((), -1, None)
        self.by_page: dict[int, _Node] = {}

    def __len__(self) -> int:
        return len(self.by_page)

    # ---- lookup ------------------------------------------------------
    def match(self, prompt):
        """Longest indexed prefix of `prompt`: (hit_tokens, [pages]).

        Walks full-page children while whole pages keep matching; at the
        frontier, a partial leaf extends the hit only when the *entire
        remaining prompt* equals its run — a partial page is shared by
        copy-on-write, which only pays off when the prompt ends inside
        it (otherwise prefill must rewrite the page anyway)."""
        toks = tuple(int(t) for t in prompt)
        node, hit, pages = self.root, 0, []
        while len(toks) - hit >= self.ps:
            nxt = node.children.get(toks[hit:hit + self.ps])
            if nxt is None:
                break
            node = nxt
            hit += self.ps
            pages.append(nxt.page)
        rest = toks[hit:]
        if rest:
            part = node.partial.get(rest)
            if part is not None:
                hit += part.ntok
                pages.append(part.page)
        return hit, pages

    # ---- insertion ---------------------------------------------------
    def insert(self, store: CacheStore, prompt, pages, step: int) -> None:
        """Index `prompt`'s page chain (the slot's leading pages, in
        order). Idempotent: runs already indexed keep their original
        page — a sharer's CoW copy of a partial page is never indexed
        over the original. New pages get a store retain() hold."""
        toks = tuple(int(t) for t in prompt)
        node, pos, i = self.root, 0, 0
        while pos < len(toks):
            n = min(self.ps, len(toks) - pos)
            run = toks[pos:pos + n]
            table = node.children if n == self.ps else node.partial
            nxt = table.get(run)
            if nxt is None:
                nxt = _Node(run, pages[i], node)
                table[run] = nxt
                self.by_page[pages[i]] = nxt
                store.retain(pages[i])
            nxt.last_touch = step
            store.last_touch[nxt.page] = step
            node, pos, i = nxt, pos + n, i + 1
            if n < self.ps:
                break

    # ---- eviction ----------------------------------------------------
    def evict_lru(self, store: CacheStore, need_free: int,
                  evicted_keys: Optional[set] = None,
                  protect=()) -> int:
        """Release index holds leaf-first, coldest `last_touch` first,
        until the store has `need_free` free pages (or no evictable node
        remains). Only nodes no slot maps (refcount zero) are
        candidates; a mapped page implies every ancestor is mapped by
        the same slot, so leaf-first order is also dependency order.
        `protect` pins pages the in-flight admission just matched.
        Evicted prefixes are recorded in `evicted_keys` so readmissions
        can be attributed to recompute-on-readmit."""
        protect = set(protect)
        evicted = 0
        while len(store._free) < need_free:
            best = None
            stack = [self.root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                stack.extend(n.partial.values())
                if n is self.root or n.children or n.partial:
                    continue
                if store._ref[n.page] != 0 or n.page in protect:
                    continue
                if best is None or n.last_touch < best.last_touch:
                    best = n
            if best is None:
                break
            if evicted_keys is not None:
                evicted_keys.add(self._prefix(best))
            self._remove(best)
            store.release(best.page)
            evicted += 1
        return evicted

    def _prefix(self, node: _Node) -> tuple:
        runs = []
        while node is not None and node.parent is not None:
            runs.append(node.tokens)
            node = node.parent
        return sum(reversed(runs), ())

    def _remove(self, node: _Node) -> None:
        table = node.parent.children if node.ntok == self.ps \
            else node.parent.partial
        del table[node.tokens]
        self.by_page.pop(node.page, None)


class MemoryManager:
    """Admission-time memory policy for the Scheduler: quotes page needs
    against the prefix index, evicts cold pages to make room, maps shared
    prefixes (with CoW) at admit, and nominates preemption victims.

    Knobs mirror `ServeSpec`: `share_prefix` turns the index on, `evict`
    lets `make_room` reclaim cold indexed pages, `preempt` lets `victim`
    nominate an in-flight request under pressure. All three are inert on
    pool-less stores. Counters accumulate here and are copied onto the
    `ServeReport` by the Scheduler."""

    def __init__(self, store: CacheStore, *, share_prefix: bool = False,
                 evict: bool = False, preempt: bool = False,
                 policy: str = "fifo", metrics=None):
        self.store = store
        self.share_prefix = share_prefix and store._has_pool
        self.evict = evict and store._has_pool
        self.preempt = preempt and store._has_pool
        self.policy = policy
        self.metrics = metrics
        self.index = PrefixIndex(store.layout.page_size)
        self.evicted_prefixes: set[tuple] = set()
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.pages_shared = 0
        self.evictions = 0
        self.readmit_recomputes = 0

    # ---- admission ---------------------------------------------------
    def plan_admit(self, prompt, need_tokens: int):
        """Quote an admission: (hit_tokens, matched_pages, need_fresh).

        A fully-matched trailing partial page still costs one fresh page
        (its CoW copy), so need_fresh only discounts *full* matched
        pages; a partial match short of the prompt's end is discarded —
        prefill must rewrite that page, sharing it buys nothing."""
        st = self.store
        if not st._has_pool:
            return 0, [], 0
        lo = st.layout
        need_fresh = lo.pages_for(need_tokens)
        if not self.share_prefix:
            return 0, [], need_fresh
        hit, pages = self.index.match(prompt)
        full = hit // lo.page_size
        if hit % lo.page_size and hit != len(prompt):
            hit = full * lo.page_size
            pages = pages[:full]
        return hit, pages, need_fresh - full

    def make_room(self, need_fresh: int, protect=()) -> bool:
        """True when `need_fresh` pages are (or were made) free. With
        eviction on, cold indexed pages are released LRU-first to close
        the gap — `protect` pins the pages the caller just matched;
        without eviction this is a pure free-list check."""
        st = self.store
        if not st._has_pool or len(st._free) >= need_fresh:
            return True
        if self.evict:
            n = self.index.evict_lru(st, need_fresh, self.evicted_prefixes,
                                     protect)
            if n:
                self.evictions += n
                if self.metrics is not None:
                    self.metrics.counter_inc("serve/evictions", n)
        return len(st._free) >= need_fresh

    def admit(self, slot: int, prompt, need_tokens: int, hit: int,
              pages, step: int) -> int:
        """Map the quoted admission onto `slot`: shared full pages by
        refcount, a fully-matched trailing partial page by CoW, fresh
        pages for the rest; then index this prompt's chain. Returns the
        number of leading pages prefill must skip writing (they already
        hold the prefix)."""
        st = self.store
        if not st._has_pool:
            st.alloc(slot, need_tokens)
            return 0
        lo = st.layout
        self.prompt_tokens += len(prompt)
        full = hit // lo.page_size
        st.alloc(slot, need_tokens, shared=pages[:full])
        owned = st._owned[slot]
        skip = full
        if hit % lo.page_size:
            # whole prompt matched through a partial page: the slot will
            # write generated tokens into its token range — map a copy
            st.copy_page(pages[full], owned[full])
            st.touch([pages[full]], step)
            skip = full + 1
        if hit:
            self.prefix_hit_tokens += hit
            self.pages_shared += full
        if self.share_prefix and self.evicted_prefixes:
            # prefill about to recompute pages eviction reclaimed?
            toks = tuple(int(t) for t in prompt)
            stale = {k for k in self.evicted_prefixes
                     if hit < len(k) <= len(toks) and k == toks[:len(k)]}
            if stale:
                self.readmit_recomputes += 1
                self.evicted_prefixes -= stale
        st.touch(owned, step)
        for p in owned[:full]:
            node = self.index.by_page.get(p)
            if node is not None:
                node.last_touch = step
        if self.share_prefix:
            self.index.insert(st, prompt, owned, step)
        return skip

    # ---- retirement / LRU --------------------------------------------
    def went_cold(self, pages, step: int) -> None:
        """Stamp pages that just lost their last mapping but stay
        resident under an index hold — the LRU clock eviction reads."""
        self.store.touch(pages, step)
        for p in pages:
            node = self.index.by_page.get(p)
            if node is not None:
                node.last_touch = step

    # ---- preemption --------------------------------------------------
    def victim(self, active: dict, step: int, need_fresh: int):
        """Nominate a slot to preempt, or None. FIFO kicks the request
        with the fewest generated tokens (cheapest replay); "deadline"
        kicks the most slack — deadline minus current step minus tokens
        still needed, with no-deadline requests at infinite slack. Only
        victims whose releasable pages (plus the free list, plus cold
        pages when eviction is on) actually cover the shortfall qualify
        — kicking a request that cannot unblock admission helps no
        one."""
        st = self.store
        if not self.preempt or not active:
            return None

        def releasable(s):
            n = 0
            for p in st._owned.get(s, ()):
                if st._ref[p] == 1 and (p not in st._retained
                                        or self.evict):
                    n += 1
            return n

        def cost(item):
            s, slot = item
            if self.policy == "deadline":
                d = slot.req.deadline
                slack = (d - step - (slot.limit - len(slot.stats.tokens))) \
                    if d else float("inf")
                return (-slack, len(slot.stats.tokens), slot.req.rid)
            return (len(slot.stats.tokens), slot.req.rid)

        spare = len(st._free) + (st.pages_cold if self.evict else 0)
        for s, slot in sorted(active.items(), key=cost):
            if spare + releasable(s) >= need_fresh:
                return s
        return None
