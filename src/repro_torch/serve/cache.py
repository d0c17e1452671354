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
#: the per-slot keys that hold recurrent (SSD / RWKV6) state
SSM_KEYS = ("ssm_state", "conv_tail", "shift")


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
S_AX, T_AX, D_AX = "stage", "tp", "data"


def _kv_tp(cfg):
    """The tp axis the KV-head dim splits over, or None where the spec keeps
    KV whole (KV % tp != 0, trap Y3)."""
    return T_AX if (cfg.num_kv_heads and cfg.tp > 1
                    and cfg.num_kv_heads % cfg.tp == 0) else None


def cache_struct(cfg, batch: int, max_len: int, *, seq_shards: int = 1,
                 dtype=torch.bfloat16):
    """({name: (shape, dtype)}, {name: spec}) of the contiguous cache (K/V
    groups are pairs). A spec names, per dim, the mesh axis the dim splits
    over (None: whole), as the JAX package's PartitionSpecs do. Group
    layout (global, stage-major):
      kv_full [stages*m_full, B, S, KV, hd]  (S split over data when
                                              seq_shards > 1)
      kv_win  [stages*m_win,  B, W, KV, hd]
      ssm_state [stages*m_ssm, B, H, K, P] f32; conv_tail / shift small
    B splits over data from 16 rows on; KV over tp where KV % tp == 0.
    Each kind of state covers its own layers: a one-kind model's SSM
    state every layer (m_ssm = layer_slots), a mixed-kind model's K/V its
    attention layers and its SSM state and conv tails its Mamba layers.
    """
    from repro_torch.models.lm import layer_meta, ssm_slots
    meta = layer_meta(cfg)
    n_ssm = cfg.stages * ssm_slots(cfg)[1]
    st, Lp = cfg.stages, cfg.padded_layers
    hd, KV = cfg.head_dim, cfg.num_kv_heads
    kv_tp = _kv_tp(cfg)
    batch_ax = D_AX if batch >= 16 else None
    seq_ax = D_AX if seq_shards > 1 else None
    shapes, specs = {}, {}
    if meta["m_full"] > 0 and cfg.attn_type != "none":
        shp = (st * meta["m_full"], batch, max_len, KV, hd)
        shapes["kv_full"] = ((shp, dtype), (shp, dtype))
        specs["kv_full"] = ((S_AX, batch_ax, seq_ax, kv_tp, None),) * 2
    if meta["m_win"] > 0:
        W = min(cfg.window_size, max_len)
        shp = (st * meta["m_win"], batch, W, KV, hd)
        shapes["kv_win"] = ((shp, dtype), (shp, dtype))
        specs["kv_win"] = ((S_AX, batch_ax, None, kv_tp, None),) * 2
    if cfg.ssm_type == "ssd":
        H, N = cfg.n_ssm_heads, cfg.ssm_state
        shapes["ssm_state"] = ((n_ssm, batch, H, N, cfg.d_inner // H),
                               torch.float32)
        specs["ssm_state"] = (S_AX, batch_ax, None, None, None)
        shapes["conv_tail"] = ((n_ssm, batch, 3, cfg.d_inner + 2 * N), dtype)
        specs["conv_tail"] = (S_AX, batch_ax, None, None)
    if cfg.ssm_type == "rwkv6":
        H = cfg.n_ssm_heads
        hds = cfg.d_model // H
        shapes["ssm_state"] = ((Lp, batch, H, hds, hds), torch.float32)
        specs["ssm_state"] = (S_AX, batch_ax, None, None, None)
        shapes["shift"] = ((Lp, batch, 2, cfg.d_model), dtype)
        specs["shift"] = (S_AX, batch_ax, None, None)
    return shapes, specs


def init_cache(cfg, batch: int, max_len: int, *, seq_shards: int = 1,
               dtype=torch.bfloat16, device="cpu"):
    shapes, _ = cache_struct(cfg, batch, max_len, seq_shards=seq_shards,
                             dtype=dtype)
    return {k: _zeros(s, device) for k, s in shapes.items()}


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
    """(shapes, specs) of the paged tree: the contiguous struct with kv_full
    re-homed to the page pool (split over stage and, as the contiguous
    group, over tp), plus the block table (whole: every stage resolves the
    same logical -> physical map)."""
    from repro_torch.models.lm import layer_meta
    shapes, specs = cache_struct(cfg, layout.max_batch, layout.max_len,
                                 dtype=dtype)
    if "kv_full" in shapes:
        shp = (cfg.stages * layer_meta(cfg)["m_full"], layout.num_pages + 1,
               layout.page_size, cfg.num_kv_heads, cfg.head_dim)
        shapes["kv_full"] = ((shp, dtype), (shp, dtype))
        specs["kv_full"] = ((S_AX, None, None, _kv_tp(cfg), None),) * 2
    shapes["block_tab"] = ((layout.max_batch, layout.pages_per_slot),
                           torch.int32)
    specs["block_tab"] = (None, None)
    return shapes, specs


def init_paged(cfg, layout: PageLayout, *, dtype=torch.bfloat16,
               device="cpu"):
    tree = {k: _zeros(s, device) for k, s in
            paged_struct(cfg, layout, dtype=dtype)[0].items()}
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
# the spmd placement and the pipeline's microbatch views
# ----------------------------------------------------------------------------
def shard_cache(cfg, cache, mesh, specs):
    """Every (data, stage, tp) slot's own cache: out[d][s][t] is a dict
    with the keys of `cache` (a global tree of init_cache / init_paged)
    whose leaves are the slot's part of each global leaf under `specs`
    (cache_struct's or paged_struct's).

    A leaf's stage part is its `layer_slots` groups of dim 0; a dim the
    spec splits over tp (the KV heads) or data (batch rows, or sequence
    positions) gives each slot its chunk. Every slot leaf is contiguous —
    a view where the chunk already is, else a copy made here once (so a
    KV-head chunk of a page pool is a pool of its own, as the paged
    decode kernel needs). A leaf the spec keeps whole over tp (KV % tp !=
    0, trap Y3; the SSM / RWKV state) or over data is one tensor on the
    (0, s, 0) slot's device, the same object in every such slot: written
    once, by shard 0 of data slot 0. The block table (no stage dim) is one
    copy per device. `cache` is not used after: its leaves may be shared."""
    grid = mesh.devices.reshape(-1, mesh.shape[S_AX], mesh.shape[T_AX])
    n_d, n_s, n_t = grid.shape
    out = [[[{} for _ in range(n_t)] for _ in range(n_s)] for _ in range(n_d)]
    tabs: dict = {}
    for key, leaf in cache.items():
        spec = specs[key]
        pair = isinstance(leaf, tuple)
        parts = [_shard_leaf(x, sp, grid, tabs) for x, sp in
                 (zip(leaf, spec) if pair else [(leaf, spec)])]
        for d in range(n_d):
            for s in range(n_s):
                for t in range(n_t):
                    got = tuple(p[d][s][t] for p in parts)
                    out[d][s][t][key] = got if pair else got[0]
    return out


def _shard_leaf(x, spec, grid, tabs):
    """[d][s][t] parts of one global leaf (see shard_cache)."""
    n_d, n_s, n_t = grid.shape
    if S_AX not in spec:                     # the block table, read-only
        return [[[tabs.setdefault(grid[d, s, t], x.to(grid[d, s, t]))
                  for t in range(n_t)] for s in range(n_s)]
                for d in range(n_d)]
    out = []
    for d in range(n_d):
        rows = []
        for s, xs in enumerate(x.chunk(n_s, dim=spec.index(S_AX))):
            if d and D_AX not in spec:
                rows.append(out[0][s])       # whole over data: data slot 0's
                continue
            if D_AX in spec:
                xs = xs.chunk(n_d, dim=spec.index(D_AX))[d]
            if T_AX in spec:
                rows.append([c.to(grid[d, s, t]).contiguous() for t, c in
                             enumerate(xs.chunk(n_t, dim=spec.index(T_AX)))])
            else:
                rows.append([xs.to(grid[d, s, 0]).contiguous()] * n_t)
        out.append(rows)
    return out


def slot_trees(tree) -> list:
    """The per-slot cache dicts of a tree: the dict itself, or every dict
    of shard_cache's nesting."""
    if isinstance(tree, dict):
        return [tree]
    return [c for row in tree for slot in row for c in slot]


def _each(v, fn):
    """fn over a leaf or the leaves of nested tuples (K/V pairs, and the
    data slots' pairs of a sequence-sharded decode's kv_merge)."""
    return tuple(_each(a, fn) for a in v) if isinstance(v, tuple) else fn(v)


def _leaves(v) -> list:
    return [x for a in v for x in _leaves(a)] if isinstance(v, tuple) \
        else [v]


def slice_mb(cache, j, mb):
    """The per-microbatch view of a (slot's) cache the pipeline stage
    computes on: per-slot leaves sliced to rows [j*mb, (j+1)*mb) at dim 1,
    the page pool whole (microbatches own disjoint pages; writes are
    scatters), the block table row-sliced alongside the batch. Every leaf
    is a view: the stage's writes land in `cache`."""
    if cache is None:
        return None
    paged = is_paged(cache)
    out = {}
    for key, v in cache.items():
        if key == "block_tab":
            out[key] = v[j * mb:(j + 1) * mb]
        elif paged and key == "kv_full":
            out[key] = v
        else:
            out[key] = _each(v, lambda a: a[:, j * mb:(j + 1) * mb])
    return out


def update_mb(cache, new_rows, j, mb, valid):
    """Write a stage's per-microbatch cache back into `cache`, as the JAX
    package's step does. The port's pipeline_wave never needs it (its
    stages write slice_mb's views in place); for a caller whose stage hands
    back new tensors, only a leaf that is not such a view is copied in: per-slot rows when the tick is `valid`, a replaced page
    pool whole (its scatters routed dead rows to the trash page, as in the
    JAX package); the block table is read-only in a step. Returns
    `cache`."""
    paged = is_paged(cache)
    for key, v in cache.items():
        pool = paged and key == "kv_full"
        if key == "block_tab" or not (valid or pool):
            continue
        for a, n in zip(_leaves(v), _leaves(new_rows[key])):
            dst = a if pool else a[:, j * mb:(j + 1) * mb]
            if n.data_ptr() != dst.data_ptr() or n.stride() != dst.stride():
                dst.copy_(n)
    return cache


# ----------------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------------
class CacheStore:
    """Owns one serve cache: the device tree plus host-side page
    accounting. The Scheduler allocates pages at admission and frees them
    at retirement; the Engine's serve steps read and write the tree in
    place.

    mesh: a launch.mesh.Mesh of the spmd backend; the tree is then
    shard_cache's per-slot nesting, one contiguous pool per (stage, tp)
    slot (None: the one global tree on `device`). The accounting and
    stats() are the global tree's either way."""

    def __init__(self, cfg, layout: PageLayout, *, dtype=torch.bfloat16,
                 device="cpu", mesh=None):
        self.cfg, self.layout, self.dtype = cfg, layout, dtype
        self.device = torch.device(device)
        self.mesh = mesh
        self.tree = self._place(init_paged(cfg, layout, dtype=dtype,
                                           device=self.device))
        # attention-free / all-windowed families have no full-attention KV
        # group: there is no pool to ration
        self._has_pool = "kv_full" in slot_trees(self.tree)[0]
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
        # slots whose recurrent state an admission replaced (append_rows)
        self.ssm_resets = 0
        self._has_ssm = any(k in slot_trees(self.tree)[0] for k in SSM_KEYS)

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
        the K and V pools of every layer group (every slot's), in place."""
        for pool in self._unique("kv_full"):
            pool[:, dst].copy_(pool[:, src])
        self.cow_copies += 1

    def touch(self, pages, step: int) -> None:
        for p in pages:
            self.last_touch[p] = step

    def _sync_tab(self) -> None:
        tab = torch.from_numpy(self._tab)
        for t in self._unique("block_tab"):
            t.copy_(tab)

    def _place(self, tree):
        """A global tree as this store holds it (see the class doc)."""
        if self.mesh is None:
            return tree
        return shard_cache(self.cfg, tree, self.mesh,
                           paged_struct(self.cfg, self.layout)[1])

    def _unique(self, key) -> list:
        """The distinct tensors under `key` over the tree's slots (a leaf
        shared by slots once)."""
        seen = {}
        for c in slot_trees(self.tree):
            v = c.get(key, ())
            for t in (v if isinstance(v, tuple) else (v,)):
                seen.setdefault(id(t), t)
        return list(seen.values())

    # ---- views / updates ---------------------------------------------
    def prefill_input(self, rows, slots, skip_pages=None):
        """The cache tree a prefill step of `rows` rows writes into: the
        live page pool (written in place), a block table whose row j maps
        to slots[j]'s pages (-1 rows for unused prefill rows), and fresh
        zeroed per-slot state (adopted into the slots by append_rows).

        skip_pages[j] masks row j's first N page entries to -1 in this
        view only: those pages hold a shared, already-written prefix, so
        the row's recomputed K/V for them goes to the trash page."""
        lo = self.layout
        tab = np.full((rows, lo.pages_per_slot), -1, np.int32)
        for j, s in enumerate(slots):
            tab[j] = self._tab[s]
            if skip_pages is not None and skip_pages[j]:
                tab[j, :skip_pages[j]] = -1
        out = {"block_tab": torch.from_numpy(tab).to(self.device)}
        structs = cache_struct(self.cfg, rows, lo.max_len,
                               dtype=self.dtype)[0]
        for key in SLOT_KEYS:
            if key in structs:
                out[key] = _zeros(structs[key], self.device)
        out = self._place(out)
        if self._has_pool:
            for o, c in zip(slot_trees(out), slot_trees(self.tree)):
                o["kv_full"] = c["kv_full"]
        return out

    def append_rows(self, out_tree, pairs) -> None:
        """Absorb a prefill step's output: the pool was written in place;
        per-slot leaves are row-copied src -> dst for each (src, dst) in
        pairs (whole-row replacement clears a slot's previous occupant:
        each such slot's recurrent state is reset, `ssm_resets`)."""
        if not pairs:
            return
        if self._has_ssm:
            self.ssm_resets += len(pairs)
        srcs = torch.tensor([s for s, _ in pairs], device=self.device)
        dsts = torch.tensor([d for _, d in pairs], device=self.device)
        done = set()
        for mine, new in zip(slot_trees(self.tree), slot_trees(out_tree)):
            for key in SLOT_KEYS:
                if key not in mine:
                    continue
                leaves, news = mine[key], new[key]
                for big, f in (zip(leaves, news) if isinstance(leaves, tuple)
                               else [(leaves, news)]):
                    if id(big) not in done:     # a shared leaf once
                        done.add(id(big))
                        big[:, dsts.to(big.device)] = f[:, srcs.to(f.device)]

    def update(self, out_tree) -> None:
        """Absorb a decode step's output tree (the host block table stays
        authoritative)."""
        for mine, new in zip(slot_trees(self.tree), slot_trees(out_tree)):
            if new is not mine:
                mine.update({k: v for k, v in new.items()
                             if k != "block_tab"})

    # ---- reporting ---------------------------------------------------
    def _slot_bytes(self, keys) -> int:
        """Bytes of the global tree's per-slot leaves under `keys`."""
        shapes = cache_struct(self.cfg, self.layout.max_batch,
                              self.layout.max_len, dtype=self.dtype)[0]
        n = 0
        for key in keys:
            st = shapes.get(key)
            for shp, dt in (() if st is None else st
                            if isinstance(st[1], tuple) else (st,)):
                n += int(np.prod(shp)) * dt.itemsize
        return n

    @property
    def ssm_state_bytes(self) -> int:
        """The recurrent state and conv tails / token shifts of every slot,
        reserved whole (a slot's share is fixed, whatever its length)."""
        return self._slot_bytes(SSM_KEYS)

    def stats(self) -> dict:
        """Page accounting + bytes."""
        lo = self.layout
        # the global tree's bytes, whatever the placement (a leaf kept whole
        # over tp counts once, as one global array)
        shapes = paged_struct(self.cfg, lo, dtype=self.dtype)[0]
        page_bytes = 0
        if self._has_pool:
            (shp, dt), _ = shapes["kv_full"]
            # one page across both K and V pools, all layer groups
            page_bytes = 2 * shp[0] * lo.page_size * int(np.prod(shp[3:])) \
                * dt.itemsize
        slot_bytes = self._slot_bytes(SLOT_KEYS)
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
