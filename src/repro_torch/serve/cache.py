"""The serve-side cache subsystem: every byte of KV decoding state.

HetPipe's premise is that per-stage memory is the scarce resource, so the
serve path treats its cache as a managed, accounted object rather than a
worst-case contiguous block. This module is the single owner of cache
layout knowledge; models.blocks, the Engine and the Scheduler go through
its API.

Two layouts, one API:

  contiguous   `[groups, batch, max_len, KV, hd]` — the reference layout
               the aligned Engine.generate() path decodes over.
               `cache_struct` / `init_cache` build it.

  paged        full-attention K/V live in a fixed pool of pages
               `[groups, num_pages + 1, page_size, KV, hd]` (the extra page
               is a write-off target for unmapped slots) indexed through a
               per-slot block table `block_tab [max_batch, pages_per_slot]`
               (-1 = unmapped). Fixed-size per-slot state keeps the
               batch-dim layout.

Unlike the JAX package, which rebuilds the cache tree functionally, every
write here is in place: `page_write_token` / `page_write_prompt` /
`upd_kv` / `upd_kv_rows` index_put_ into the tensors they are given and
return them.

`CacheStore` owns the device tree plus host-side page accounting:
`alloc(slot, tokens)` / `free(slot)` move pages between the free list and
a slot's block-table row (numpy on the host, mirrored into an int32 device
tensor), `can_alloc` is the Scheduler's admission gate, `append_rows`
absorbs a prefill step's output, and `stats()` reports page utilization
and bytes. Pages are refcounted: `alloc(slot, tokens, shared=pages)` maps
an already-resident prefix into the new slot's block table — the mechanics
under repro_torch.serve.memory's prefix sharing, with `retain`/`release`,
`copy_page` (copy-on-write) and the `last_touch` LRU stamp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

#: per-slot (batch-dim) cache keys — everything that is not the paged pool
#: or the block table. Layout: batch at dim 1 of every leaf.
SLOT_KEYS = ("kv_win", "ssm_state", "conv_tail", "shift")


# ----------------------------------------------------------------------------
# dtypes
# ----------------------------------------------------------------------------
def serve_dtypes(compute_dtype: str, cache_dtype: str = ""):
    """Resolve the string knobs of RunSpec/ServeSpec to (compute dtype,
    cache dtype): compute 'bfloat16' | 'float32'; cache '' (= compute
    dtype) or 'f8' (fp8 e4m3 KV)."""
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return cdt, {"f8": torch.float8_e4m3fn, "": cdt}.get(cache_dtype, cdt)


def _zeros(struct, device):
    """Zeros for a (shape, dtype) leaf or a tuple of them (a K/V pair)."""
    if isinstance(struct[1], torch.dtype):
        return torch.zeros(struct[0], dtype=struct[1], device=device)
    return tuple(_zeros(s, device) for s in struct)


# ----------------------------------------------------------------------------
# contiguous layout
# ----------------------------------------------------------------------------
def cache_struct(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16):
    """{name: (shape, dtype)} of the contiguous cache (K/V groups are
    pairs). Group layout (global, stage-major):
      kv_full [stages*m_full, B, S, KV, hd]
      kv_win  [stages*m_win,  B, W, KV, hd]
      ssm_state [Lp, B, H, K, P] f32; conv_tail / shift small
    """
    from repro_torch.models.lm import layer_meta
    meta = layer_meta(cfg)
    st, Lp = cfg.stages, cfg.padded_layers
    hd, KV = cfg.head_dim, cfg.num_kv_heads
    out = {}
    if meta["m_full"] > 0 and cfg.attn_type != "none":
        shp = (st * meta["m_full"], batch, max_len, KV, hd)
        out["kv_full"] = ((shp, dtype), (shp, dtype))
    if meta["m_win"] > 0:
        W = min(cfg.window_size, max_len)
        shp = (st * meta["m_win"], batch, W, KV, hd)
        out["kv_win"] = ((shp, dtype), (shp, dtype))
    if cfg.ssm_type == "ssd":
        H, N = cfg.n_ssm_heads, cfg.ssm_state
        out["ssm_state"] = ((Lp, batch, H, N, cfg.d_inner // H), torch.float32)
        out["conv_tail"] = ((Lp, batch, 3, cfg.d_inner + 2 * N), dtype)
    if cfg.ssm_type == "rwkv6":
        H = cfg.n_ssm_heads
        hds = cfg.d_model // H
        out["ssm_state"] = ((Lp, batch, H, hds, hds), torch.float32)
        out["shift"] = ((Lp, batch, 2, cfg.d_model), dtype)
    return out


def init_cache(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device="cpu"):
    return {k: _zeros(s, device) for k, s in
            cache_struct(cfg, batch, max_len, dtype=dtype).items()}


# ----------------------------------------------------------------------------
# paged layout
# ----------------------------------------------------------------------------
@dataclass(frozen=True)
class PageLayout:
    """Static geometry of a paged cache pool."""

    max_batch: int
    max_len: int                # logical positions per slot (prompt + gen)
    page_size: int              # tokens per page
    num_pages: int              # usable physical pages in the pool

    @property
    def pages_per_slot(self) -> int:
        return math.ceil(self.max_len / self.page_size)

    @property
    def trash_page(self) -> int:
        """Physical index of the write-off page (block_tab == -1 maps
        here); its contents are never read as live positions."""
        return self.num_pages

    def pages_for(self, tokens: int) -> int:
        return math.ceil(max(int(tokens), 1) / self.page_size)


def make_layout(max_batch: int, max_len: int, *, page_size: int = 0,
                max_pages: int = 0) -> PageLayout:
    """page_size 0 -> max_len (one page per slot); max_pages 0 -> the
    worst case max_batch * pages_per_slot."""
    ps = page_size or max_len
    if not 1 <= ps <= max_len:
        raise ValueError(f"page_size {ps} outside [1, max_len={max_len}]")
    pps = math.ceil(max_len / ps)
    np_total = max_pages or max_batch * pps
    if np_total < pps:
        raise ValueError(
            f"max_pages={np_total} cannot hold one worst-case request "
            f"({pps} pages of {ps} tokens for max_len={max_len}); the "
            f"Scheduler could never admit it")
    return PageLayout(max_batch, max_len, ps, np_total)


def paged_struct(cfg, layout: PageLayout, *, dtype=torch.bfloat16):
    """The contiguous struct with kv_full re-homed to the page pool, plus
    the block table."""
    from repro_torch.models.lm import layer_meta
    out = cache_struct(cfg, layout.max_batch, layout.max_len, dtype=dtype)
    if "kv_full" in out:
        shp = (cfg.stages * layer_meta(cfg)["m_full"], layout.num_pages + 1,
               layout.page_size, cfg.num_kv_heads, cfg.head_dim)
        out["kv_full"] = ((shp, dtype), (shp, dtype))
    out["block_tab"] = ((layout.max_batch, layout.pages_per_slot),
                        torch.int32)
    return out


def init_paged(cfg, layout: PageLayout, *, dtype=torch.bfloat16,
               device="cpu"):
    tree = {k: _zeros(s, device) for k, s in
            paged_struct(cfg, layout, dtype=dtype).items()}
    tree["block_tab"].fill_(-1)
    return tree


def is_paged(cache) -> bool:
    return cache is not None and "block_tab" in cache


# ----------------------------------------------------------------------------
# page ops (called from models.blocks; writes are in place)
# ----------------------------------------------------------------------------
def _phys(tab, trash):
    return torch.where(tab >= 0, tab, trash)


def page_view(pool, i, tab):
    """Gather one group's per-row contiguous view through the block table.

    pool [m, NP+1, ps, KV, hd]; tab [B, pps]. Returns (view [B, pps*ps,
    KV, hd], gpos [B, pps*ps]) where gpos is the global position of each
    gathered slot, -1 for unmapped pages."""
    B, pps = tab.shape
    ps = pool.shape[2]
    view = pool[i][_phys(tab.long(), pool.shape[1] - 1)]   # [B,pps,ps,KV,hd]
    view = view.reshape(B, pps * ps, *pool.shape[3:])
    gpos = torch.arange(pps * ps, dtype=torch.int32, device=pool.device)
    gpos = torch.where((tab >= 0).repeat_interleave(ps, dim=1), gpos[None], -1)
    return view, gpos


def page_write_token(pool, i, tab, pos, new_row, sel):
    """Decode-time single-token scatter, in place: row b's token lands in
    the page holding logical position pos[b]. pool [m, NP+1, ps, KV, hd];
    tab [B, pps]; pos, sel [B]; new_row [B, 1, KV, hd]. Rows with sel False
    or an unmapped page write to the trash page instead (never read)."""
    B, pps = tab.shape
    ps = pool.shape[2]
    trash = pool.shape[1] - 1
    pos = pos.long()
    lp = (pos // ps).clamp(0, pps - 1)
    off = pos.clamp_min(0) % ps
    phys = tab[torch.arange(B, device=tab.device), lp].long()
    phys = torch.where(sel & (phys >= 0), phys, trash)
    pool[i].index_put_((phys, off), new_row[:, 0].to(pool.dtype))
    return pool


def page_write_prompt(pool, i, tab, new_kv, sel, lens=None):
    """Prefill-time page-granular scatter of a whole prompt, in place.
    new_kv [B, S, KV, hd] (positions 0..S-1); sel [B] bool; lens [B] or
    None (positions >= lens[b] keep the page's previous contents).
    Rows with sel False or unmapped pages scatter into the trash page."""
    B, S = new_kv.shape[:2]
    ps = pool.shape[2]
    trash = pool.shape[1] - 1
    pp_in = math.ceil(S / ps)
    pad = pp_in * ps - S
    kv = new_kv
    if pad:
        kv = torch.cat([kv, kv.new_zeros((B, pad) + kv.shape[2:])], dim=1)
    kv = kv.reshape(B, pp_in, ps, *new_kv.shape[2:])
    tabp = tab[:, :pp_in].long()
    phys = torch.where(sel[:, None] & (tabp >= 0), tabp, trash)  # [B, pp_in]
    gpos = torch.arange(pp_in * ps, device=pool.device).reshape(pp_in, ps)
    if lens is None:
        live = (gpos < S)[None].expand(B, -1, -1)
    else:
        live = gpos[None] < lens.clamp(max=S)[:, None, None]    # [B,pp,ps]
    grp = pool[i]
    old = grp[phys]                                       # [B,pp_in,ps,KV,hd]
    upd = torch.where(live[..., None, None], kv.to(pool.dtype), old)
    grp.index_put_((phys,), upd)
    return pool


# ----------------------------------------------------------------------------
# contiguous single-position writes (the aligned generate() path)
# ----------------------------------------------------------------------------
def upd_kv(group, i, pos_idx, new_row, sel):
    """Single-position conditional cache write, in place: group [m, B, S,
    KV, hd], new_row [B, 1, KV, hd], pos_idx an int, sel a bool."""
    if sel:
        group[i, :, pos_idx] = new_row[:, 0].to(group.dtype)
    return group


def upd_kv_rows(group, i, pos_idx, new_row, sel):
    """Per-row conditional cache write, in place: each batch row b lands at
    its own position pos_idx[b]. group [m, B, S, KV, hd], new_row [B, 1,
    KV, hd], pos_idx/sel [B]."""
    rows = torch.arange(group.shape[1], device=group.device)
    pos_idx = pos_idx.long()
    old = group[i, rows, pos_idx]                       # [B, KV, hd]
    upd = torch.where(sel[:, None, None], new_row[:, 0].to(group.dtype), old)
    group[i].index_put_((rows, pos_idx), upd)
    return group


# ----------------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------------
class CacheStore:
    """Owns one serve cache: the device tree plus host-side page
    accounting. The Scheduler allocates pages at admission and frees them
    at retirement; the Engine's serve steps read and write the tree in
    place."""

    def __init__(self, cfg, layout: PageLayout, *, dtype=torch.bfloat16,
                 device="cpu"):
        self.cfg, self.layout, self.dtype = cfg, layout, dtype
        self.device = torch.device(device)
        self.tree = init_paged(cfg, layout, dtype=dtype, device=self.device)
        # attention-free / all-windowed families have no full-attention KV
        # group: there is no pool to ration
        self._has_pool = "kv_full" in self.tree
        self._tab = np.full((layout.max_batch, layout.pages_per_slot), -1,
                            np.int32)
        self._free = list(range(layout.num_pages)) if self._has_pool else []
        self._owned: dict[int, list[int]] = {}
        self.peak_pages = 0
        # refcounted sharing (repro_torch.serve.memory drives the policy)
        self._ref = np.zeros(layout.num_pages, np.int32)
        self._retained: set[int] = set()
        self.last_touch = np.zeros(layout.num_pages, np.int64)
        self.cow_copies = 0

    # ---- accounting --------------------------------------------------
    @property
    def pages_total(self) -> int:
        return self.layout.num_pages if self._has_pool else 0

    @property
    def pages_in_use(self) -> int:
        """Distinct physical pages not on the free list (a page shared by
        N block tables counts once)."""
        return self.pages_total - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cold(self) -> int:
        """Resident pages no slot maps: index-retained, evictable."""
        return sum(1 for p in self._retained if self._ref[p] == 0)

    def can_alloc(self, tokens: int, shared: int = 0) -> bool:
        if not self._has_pool:
            return True
        return len(self._free) >= self.layout.pages_for(tokens) - shared

    def alloc(self, slot: int, tokens: int, shared=()) -> None:
        """Map pages for `tokens` logical positions onto `slot`: the
        leading `shared` pages are already-resident prefix pages (refcount
        bumped), the rest come fresh from the free list. Raises when the
        pool is exhausted."""
        lo = self.layout
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages; free() it "
                             f"before re-allocating")
        if tokens > lo.max_len:
            raise ValueError(f"{tokens} tokens exceed max_len={lo.max_len}")
        if not self._has_pool:
            if shared:
                raise ValueError("shared prefix pages need a kv_full pool; "
                                 "this family's state is per-slot only")
            self._owned[slot] = []
            return
        shared = list(shared)
        need = lo.pages_for(tokens)
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"{need} pages {tokens} tokens need")
        for p in shared:
            if self._ref[p] == 0 and p not in self._retained:
                raise ValueError(f"shared page {p} is not resident (free "
                                 f"list); the prefix index is stale")
        fresh_n = need - len(shared)
        if fresh_n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {fresh_n} fresh pages for "
                f"{tokens} tokens ({len(shared)} shared), "
                f"{len(self._free)}/{lo.num_pages} free")
        fresh = self._free[:fresh_n]
        del self._free[:fresh_n]
        pages = shared + fresh
        for p in pages:
            self._ref[p] += 1
        self._owned[slot] = pages
        self._tab[slot, :] = -1
        self._tab[slot, :need] = pages
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        self._sync_tab()

    def free(self, slot: int) -> list:
        """Unmap `slot`'s pages. Pages reaching refcount zero return to the
        free list unless the prefix index retains them — those go cold and
        are returned so the caller can stamp their LRU clock."""
        pages = self._owned.pop(slot, None)
        if not pages:
            return []
        cold = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if p in self._retained:
                    cold.append(p)
                else:
                    self._free.append(p)
        self._free.sort()
        self._tab[slot, :] = -1
        self._sync_tab()
        return cold

    # ---- sharing / eviction mechanics (policy in serve.memory) --------
    def retain(self, page: int) -> None:
        self._retained.add(page)

    def release(self, page: int) -> bool:
        """Drop the index hold on `page`; True when it went back to the
        free list (no slot still maps it)."""
        self._retained.discard(page)
        if self._ref[page] == 0 and page not in self._free:
            self._free.append(page)
            self._free.sort()
            return True
        return False

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write primitive: device-copy page `src` -> `dst` across
        the K and V pools of every layer group, in place."""
        for pool in self.tree["kv_full"]:
            pool[:, dst].copy_(pool[:, src])
        self.cow_copies += 1

    def touch(self, pages, step: int) -> None:
        for p in pages:
            self.last_touch[p] = step

    def _sync_tab(self) -> None:
        self.tree["block_tab"].copy_(torch.from_numpy(self._tab))

    # ---- views / updates ---------------------------------------------
    def prefill_input(self, slots, skip_pages=None):
        """The cache tree a prefill step writes into: the live page pool
        (written in place), a block table whose row j maps to slots[j]'s
        pages (-1 rows for unused prefill rows), and fresh zeroed per-slot
        state (adopted into the slots by append_rows).

        skip_pages[j] masks row j's first N page entries to -1 in this
        view only: those pages hold a shared, already-written prefix, so
        the row's recomputed K/V for them goes to the trash page."""
        lo = self.layout
        tab = np.full((lo.max_batch, lo.pages_per_slot), -1, np.int32)
        for j, s in enumerate(slots):
            tab[j] = self._tab[s]
            if skip_pages is not None and skip_pages[j]:
                tab[j, :skip_pages[j]] = -1
        out = {"block_tab": torch.from_numpy(tab).to(self.device)}
        structs = paged_struct(self.cfg, lo, dtype=self.dtype)
        for key in SLOT_KEYS:
            if key in structs:
                out[key] = _zeros(structs[key], self.device)
        if self._has_pool:
            out["kv_full"] = self.tree["kv_full"]
        return out

    def append_rows(self, out_tree, pairs) -> None:
        """Absorb a prefill step's output: the pool was written in place;
        per-slot leaves are row-copied src -> dst for each (src, dst) in
        pairs (whole-row replacement clears a slot's previous occupant)."""
        if not pairs:
            return
        srcs = torch.tensor([s for s, _ in pairs], device=self.device)
        dsts = torch.tensor([d for _, d in pairs], device=self.device)
        for key in SLOT_KEYS:
            if key in self.tree:
                leaves = self.tree[key]
                news = out_tree[key]
                pairs_ = zip(leaves, news) if isinstance(leaves, tuple) \
                    else [(leaves, news)]
                for big, f in pairs_:
                    big[:, dsts] = f[:, srcs]

    def update(self, out_tree) -> None:
        """Absorb a decode step's output tree (the host block table stays
        authoritative)."""
        tab = self.tree["block_tab"]
        self.tree = dict(out_tree)
        self.tree["block_tab"] = tab

    # ---- reporting ---------------------------------------------------
    def stats(self) -> dict:
        """Page accounting + bytes."""
        lo = self.layout
        page_bytes = 0
        if self._has_pool:
            k, _ = self.tree["kv_full"]
            # one page across both K and V pools, all layer groups
            page_bytes = 2 * k.shape[0] * lo.page_size * int(
                np.prod(k.shape[3:])) * k.element_size()
        slot_bytes = 0
        for key in SLOT_KEYS:
            if key in self.tree:
                leaves = self.tree[key]
                leaves = leaves if isinstance(leaves, tuple) else (leaves,)
                slot_bytes += sum(t.numel() * t.element_size() for t in leaves)
        return {
            "page_size": lo.page_size,
            "pages_total": self.pages_total,
            "pages_in_use": self.pages_in_use,
            "pages_free": len(self._free),
            "pages_cold": self.pages_cold,
            "pages_shared": int((self._ref > 1).sum()) if self._has_pool
            else 0,
            "cow_copies": self.cow_copies,
            "peak_pages": self.peak_pages,
            "page_bytes": page_bytes,
            "pool_bytes": page_bytes * self.pages_total,
            "slot_state_bytes": slot_bytes,
            "utilization": (self.pages_in_use / self.pages_total
                            if self.pages_total else 0.0),
        }
