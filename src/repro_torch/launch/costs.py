"""A cost counter over torch dispatch: the port's counterpart of the JAX
package's trip-count-aware jaxpr walker (benchmarks/jaxpr_analysis.py).

`CostCounter` is a TorchDispatchMode. Inside `with CostCounter() as c:`
every aten op that runs, forward and backward, on any device (meta
included), is counted as it dispatches:

  ops          one per dispatch: the port's counterpart of the JAX
               package's HLO op count, and what sets the spmd steps' pace
               (each op is one host dispatch; PERF.md §5)
  dots         mm, bmm, addmm, baddbmm, dot, mv, addmv (what einsum,
               matmul and linear lower to; under torch.inference_mode
               those three reach the counter whole and count the same):
               2 b m n k FLOPs, their input and output bytes as dot_bytes
  views        view, reshape, transpose, permute, expand, slice, select,
               squeeze, unsqueeze, detach, alias (any op that returns a
               view) and allocations (empty*): free
  slice writes copy_, index_copy_, index_put_, scatter_ and their kin:
               2x the update's bytes, not the operand's (the JAX walker's
               dynamic_update_slice rule)
  gathers      index, index_select, gather, embedding and dtype / device
               casts (_to_copy): their output bytes
  the rest     1 FLOP per output element, the unfused sum of input and
               output bytes
  collectives  reported by launch.mesh's named collectives (kind, axis,
               axis size, payload) with the JAX walker's ring factors:
               psum / pmax 2(n-1)/n of the payload, all_gather (n-1)/n of
               the gathered bytes, all_to_all (n-1)/n, ppermute 1x
  kernels      reported by the Hopper kernel wrappers (kernels/*.py)
               from their meta branch: name, route, and the work of the
               wrapper's cost() (inputs read once, outputs written once,
               the matmul FLOPs), added to flops / dot_flops / bytes

Eager PyTorch has no scans: a loop is counted as it runs, every trip.
**A branch counts what ran.** The JAX walker takes the mean over a
cond's branches (a bubble tick counts half a stage); here a Python `if`
leaves nothing to average, so a skipped bubble tick counts nothing and a
live one its whole work (tests/test_torch_analysis.py pins the
difference).

Memory: every storage an op creates is charged, rounded up to the CUDA
caching allocator's 512-byte granule, to the (data, stage, tp) slot the
work was issued for (`slot(...)`, which launch.mesh's callers enter)
until it is freed; work outside any slot is charged to slot 0, where the
port places it (the embed, the CE, the optimizer). Backward work is
charged to the slot whose forward made its autograd node (matched by
sequence number). `arguments()` charges the inputs a step is handed
(params, optimizer state, batch, cache) where the port places them.

Counts are per slot, so a record can give the whole mesh's totals, each
slot's, and their maxima. The counter itself adds no aten op; with no
counter active `slot()` and the reporting hooks cost one global read.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the active counter (one at a time), read by slot() and the hooks
_ACTIVE: Optional["CostCounter"] = None
_NULL = contextlib.nullcontext()
_UNSEEN = object()

#: ring-model link bytes per device, as a factor of the payload
COLL_FACTORS = {
    "psum": lambda n: 2.0 * (n - 1) / n,
    "pmax": lambda n: 2.0 * (n - 1) / n,
    "pmean": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}

#: the CUDA caching allocator's rounding of a block (kMinBlockSize)
ALLOC_GRANULE = 512

#: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): bytes/s, FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}


def bound_ms(flops: float, nbytes: float, dtype=torch.bfloat16):
    """(ms, "bytes" | "operations"): the least time one H100 could take for
    `flops` at `dtype`'s peak and `nbytes` at the HBM rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


@dataclass
class Costs:
    """One slot's (or a whole run's) counts, in the JAX walker's terms."""
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_upper: float = 0.0
    dot_bytes: float = 0.0
    ops: int = 0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)

    def add_coll(self, kind: str, nbytes: float, times: float = 1.0):
        self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) \
            + nbytes * times
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) \
            + times

    def _by_op(self, name: str, nbytes: float):
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes

    def merge(self, other: "Costs") -> "Costs":
        self.flops += other.flops
        self.dot_flops += other.dot_flops
        self.bytes_upper += other.bytes_upper
        self.dot_bytes += other.dot_bytes
        self.ops += other.ops
        for mine, theirs in ((self.collective_bytes, other.collective_bytes),
                             (self.collective_counts,
                              other.collective_counts),
                             (self.bytes_by_op, other.bytes_by_op)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v
        for k, v in other.kernels.items():
            mine = self.kernels.setdefault(k, {})
            for r, n in v.items():
                mine[r] = mine.get(r, 0) + n
        return self

    @property
    def link_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(args, kwargs):
    """The tensors among an op's arguments (one level of lists, as aten
    takes them)."""
    out = []
    for a in (*args, *(kwargs.values() if kwargs else ())):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return ()


aten = torch.ops.aten
_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot, aten.mv,
         aten.addmv, aten.matmul, aten.linear, aten.einsum}
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
         aten._unsafe_view}
# (packet, index of the update operand)
_UPDATES = {aten.copy_: 1, aten.index_copy_: 3, aten.index_copy: 3,
            aten.index_put_: 2, aten.index_put: 2, aten._index_put_impl_: 2,
            aten.scatter_: 3, aten.scatter: 3, aten.scatter_add_: 3,
            aten.scatter_add: 3, aten.index_add_: 3, aten.index_add: 3,
            aten.slice_scatter: 1, aten.select_scatter: 1,
            aten.masked_scatter_: 2}
_OUT_ONLY = {aten.index, aten.index_select, aten.gather, aten.embedding,
             aten._to_copy}


def _einsum_flops(equation: str, operands, out) -> float:
    """2 x the output's elements x the sizes of the letters the operands
    contract (those missing from the output); a one-operand einsum (a sum
    or a permute) does no product."""
    if len(operands) < 2:
        return 0.0
    ins, _, outs = equation.replace(" ", "").partition("->")
    sizes = {}
    for spec, t in zip(ins.split(","), operands):
        spec = spec.replace("...", "")
        for ch, n in zip(reversed(spec), reversed(t.shape)):
            sizes[ch] = n
    k = 1
    for ch in set(ins.replace(",", "").replace(".", "")) - set(outs):
        k *= sizes.get(ch, 1)
    return 2.0 * out.numel() * k


def _dot_flops(packet, args, out) -> float:
    if packet is aten.einsum:
        return _einsum_flops(args[0], args[1], out)
    if packet is aten.matmul or packet is aten.linear:
        # what they lower to (inference mode dispatches them whole):
        # 2 x the output's elements x the contracted length
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in (aten.addmm, aten.baddbmm, aten.addmv):
        args = args[1:]
    a, b = args[0], args[1]
    if packet is aten.dot:
        return 2.0 * a.shape[0]
    if packet is aten.mv:
        return 2.0 * a.shape[0] * a.shape[1]
    if packet is aten.mm or packet is aten.addmm:
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _kind(func) -> tuple:
    """(rule, packet) of an op overload: 'dot' | 'free' | 'update' |
    'out' | 'rest'."""
    packet = func.overloadpacket
    if packet in _DOTS:
        return "dot", packet
    if packet in _UPDATES:
        return "update", packet
    if packet in _FREE or func.is_view:
        return "free", packet
    if packet in _OUT_ONLY:
        return "out", packet
    return "rest", packet


def _norm(key) -> tuple:
    """A scope as a slot: unset fields are 0; no scope is slot 0."""
    if key is None:
        return (0, 0, 0)
    return tuple(0 if x is None else x for x in key)


def _alloc(nbytes: int) -> int:
    if nbytes <= 0:
        return 0
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def _memo_kind(func):
    """How a meta call of `func` may be remembered: "new" (its outputs are
    fresh tensors), "self" (in place, returning its first operand), or None
    (a view, or anything else: always run)."""
    if func.overloadpacket in _FREE:
        return None
    schema = func._schema
    rets = schema.returns
    if not rets or any(str(r.type) not in ("Tensor", "Tensor[]")
                       for r in rets):
        return None
    if func.is_view:
        return None
    if not schema.is_mutable:
        return "new" if all(r.alias_info is None for r in rets) else None
    args = schema.arguments
    if len(rets) == 1 and rets[0].alias_info is not None and args and \
            args[0].alias_info is not None and args[0].alias_info.is_write \
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in args[1:]):
        return "self"
    return None


def _sig(a, metas):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError
        metas.append(True)
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x, metas) for x in a)
    hash(a)
    return a


def _signature(func, args, kwargs):
    """A hashable key of a call on meta tensors: the op, each tensor's
    shape, strides and dtype, every other argument's value; None when no
    tensor argument is on meta (a factory runs as called), one is not on
    meta, or an argument is unhashable."""
    metas: list = []
    try:
        key = (func, _sig(args, metas),
               tuple((k, _sig(v, metas)) for k, v in kwargs.items()))
    except TypeError:
        return None
    return key if metas else None


def _describe(out):
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return (type(out), tuple((t.shape, t.stride(), t.dtype)
                                 for t in out))
    return None


def _rebuild(desc):
    if isinstance(desc[0], type):
        kind, parts = desc
        return kind(torch.empty_strided(shp, st, dtype=dt, device="meta")
                    for shp, st, dt in parts)
    shp, st, dt = desc
    return torch.empty_strided(shp, st, dtype=dt, device="meta")


class _Slot:
    """A (data, stage, tp) scope entered on the counter; unset fields are
    inherited from the enclosing scope."""
    __slots__ = ("counter", "key", "prev")

    def __init__(self, counter, data, stage, tp):
        self.counter = counter
        self.key = (data, stage, tp)
        self.prev = None

    def __enter__(self):
        c = self.counter
        self.prev = c._scope
        d, s, t = self.key
        if self.prev is not None:
            pd, ps, pt = self.prev
            d = pd if d is None else d
            s = ps if s is None else s
            t = pt if t is None else t
        c._enter((d, s, t))
        return self

    def __exit__(self, *exc):
        c = self.counter
        c._enter(self.prev)
        if self.prev is None and self.key[0] == 0:
            c.saved_bytes_at_mark = c._pipe0_live
        return False


def slot(data: Optional[int] = None, stage: Optional[int] = None,
         tp: Optional[int] = None):
    """The scope of work issued for one mesh slot (fields left None are
    the enclosing scope's, or 0). A shared no-op context when no counter
    is active."""
    c = _ACTIVE
    if c is None:
        return _NULL
    return _Slot(c, data, stage, tp)


def collective(kind: str, axis: str, n: int, payload: float, *,
               modeled: bool = False):
    """Report one collective to the active counter (no-op without one):
    `payload` bytes a device holds (psum / pmax / all_to_all / ppermute:
    its input; all_gather: the gathered output) over an axis of `n`."""
    c = _ACTIVE
    if c is not None:
        c.collective(kind, axis, n, payload, modeled=modeled)


def kernel(name: str, route: str, flops: float, nbytes: float):
    """Report one kernel launch the meta branch of a wrapper stands in for
    (no-op without a counter)."""
    c = _ACTIVE
    if c is not None:
        c.kernel(name, route, flops, nbytes)


class CostCounter(TorchDispatchMode):
    """Counts the aten ops, FLOPs, bytes, collectives, kernel launches and
    live storages of the work run inside it (see the module docstring).

    Per-slot Costs are in `by_slot` (key (d, s, t), or None for work
    outside any slot); `total()` sums them. Memory: `peak_bytes` (the most
    bytes of storages made inside the counter alive at once, over the
    whole mesh), `peak_by_slot`, `arg_bytes` / `arg_by_slot` (what
    `arguments()` charged), `live_bytes` now. `modeled` lists the
    collectives reckoned rather than issued."""

    def __init__(self):
        super().__init__()
        self.by_slot: dict = {}
        self.modeled: list = []
        self.peak_bytes = 0
        self.live_bytes = 0
        self.peak_by_slot: dict = {}
        self.live_by_slot: dict = {}
        self.arg_bytes = 0
        self.arg_by_slot: dict = {}
        self._live: dict = {}          # storage id -> (bytes, slot, weakref)
        self._args: set = set()          # argument storages
        self._arg_views: set = set()
        self._lock = threading.Lock()
        self._scope = None             # the (d, s, t) issued for, or None
        self._segments: list = []      # (autograd seq nr, scope), ascending
        self._seqs: list = []
        self._kinds: dict = {}
        self._memo_kind: dict = {}
        self._memo: dict = {}
        # the dry run's symmetry shortcut: a step issues this many data
        # slots (None: all); launch.mesh.issued_data_slots reads it
        self.data_slots: Optional[int] = None
        self.reckoned_from: Optional[int] = None   # set when a step did
        self._quiet = False
        self._pipe0_live = 0           # bytes of data slot 0's scopes alive
        self.saved_bytes_at_mark = 0   # ... as its scope last closed
        self.peak_scoped: dict = {}    # per slot, scoped work only
        self._live_scoped: dict = {}

    # -- scopes ---------------------------------------------------------
    def _enter(self, scope):
        self._scope = scope
        if torch._C._current_autograd_node() is None:
            seq = torch._C._autograd._get_sequence_nr()
            if self._seqs and self._seqs[-1] == seq:
                self._segments[-1] = (seq, scope)
            else:
                self._seqs.append(seq)
                self._segments.append((seq, scope))

    def _slot_now(self):
        """The slot work is issued for now: the open scope's fields, the
        rest (in backward) from the scope that made the running node."""
        scope = self._scope
        node = torch._C._current_autograd_node()
        if node is None:
            return scope
        i = bisect.bisect_right(self._seqs, node._sequence_nr()) - 1
        base = self._segments[i][1] if i >= 0 else None
        if scope is None:
            return base
        if base is None or None not in scope:
            return scope
        return tuple(b if a is None else a for a, b in zip(scope, base))

    def costs(self, key) -> Costs:
        c = self.by_slot.get(key)
        if c is None:
            c = self.by_slot[key] = Costs()
        return c

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a CostCounter is already active")
        _ACTIVE = self
        self._enter(None)
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def close(self):
        """Stop tracking the storages still alive (their finalizers
        would otherwise call into this counter when they die)."""
        with self._lock:
            self._live.clear()       # the weakrefs die: no callback fires

    @contextlib.contextmanager
    def uncounted(self):
        """Ops run inside are neither counted nor charged (the stand-ins
        for data slots the dry run reckons by symmetry)."""
        prev, self._quiet = self._quiet, True
        try:
            yield
        finally:
            self._quiet = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        key = self._slot_now()
        c = self.costs(key)
        c.ops += 1
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        rule, packet = kind
        if rule == "free":
            pass
        elif rule == "dot":
            ins = _tensors(args, kwargs)
            io = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in _outputs(out))
            f = _dot_flops(packet, args, out)
            c.flops += f
            c.dot_flops += f
            c.dot_bytes += io
            c.bytes_upper += io
            c._by_op(packet.__name__, io)
        elif rule == "update":
            i = _UPDATES[packet]
            upd = args[i] if len(args) > i else None
            if isinstance(upd, (list, tuple)):
                upd = None
            nb = 2.0 * _nbytes(upd) if isinstance(upd, torch.Tensor) else 0.0
            c.bytes_upper += nb
            c._by_op(packet.__name__, nb)
        elif rule == "out":
            nb = sum(_nbytes(t) for t in _outputs(out))
            c.bytes_upper += nb
            c._by_op(packet.__name__, nb)
        else:
            outs = _outputs(out)
            io = sum(_nbytes(t) for t in _tensors(args, kwargs)) + sum(
                _nbytes(t) for t in outs)
            c.flops += sum(t.numel() for t in outs)
            c.bytes_upper += io
            c._by_op(packet.__name__, io)
        self._track(out, args, kwargs, key)
        return out

    # -- meta ops, remembered ------------------------------------------------
    def _run(self, func, args, kwargs):
        """func(*args, **kwargs), or on meta tensors its remembered result:
        a meta op's shape function runs in Python (~0.1-0.3 ms each), and a
        step repeats the same few hundred signatures (every layer, shard and
        microbatch). An op that returns new tensors gets empty meta tensors
        of the shapes, strides and dtypes its first call gave; an in-place
        op returns its operand. Views and everything else run as called."""
        how = self._memo_kind.get(func, _UNSEEN)
        if how is _UNSEEN:
            how = self._memo_kind[func] = _memo_kind(func)
        if how is None:
            return func(*args, **kwargs)
        key = _signature(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        got = self._memo.get(key)
        if got is not None:
            if how == "self":
                return args[0]
            return _rebuild(got)
        out = func(*args, **kwargs)
        if how == "self":
            if out is args[0]:
                self._memo[key] = True
        else:
            desc = _describe(out)
            if desc is not None:
                self._memo[key] = desc
        return out

    # -- memory -----------------------------------------------------------
    def _track(self, out, args, kwargs, key):
        outs = _outputs(out)
        if not outs:
            return
        seen = None
        for t in outs:
            st = t.untyped_storage()
            sid = st._cdata
            if sid in self._live or sid in self._args:
                continue
            if seen is None:
                seen = {x.untyped_storage()._cdata
                        for x in _tensors(args, kwargs)}
            if sid in seen:
                continue              # a view of, or a write into, an input
            nb = _alloc(st.nbytes())
            ref = weakref.ref(st, lambda _, sid=sid: self._free(sid))
            with self._lock:
                self._live[sid] = (nb, key, ref)
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                k0 = _norm(key)
                lv = self.live_by_slot.get(k0, 0) + nb
                self.live_by_slot[k0] = lv
                if lv > self.peak_by_slot.get(k0, 0):
                    self.peak_by_slot[k0] = lv
                if key is not None:
                    ls = self._live_scoped.get(k0, 0) + nb
                    self._live_scoped[k0] = ls
                    if ls > self.peak_scoped.get(k0, 0):
                        self.peak_scoped[k0] = ls
                    if k0[0] == 0:
                        self._pipe0_live += nb

    def _free(self, sid):
        with self._lock:
            got = self._live.pop(sid, None)
            if got is None:
                return
            nb, key, _ = got
            self.live_bytes -= nb
            k0 = _norm(key)
            self.live_by_slot[k0] -= nb
            if key is not None:
                self._live_scoped[k0] -= nb
                if k0[0] == 0:
                    self._pipe0_live -= nb

    def arguments(self, tree, slot_key=(0, 0, 0)):
        """Charge the tensors under `tree` (nested dicts, lists, tuples) to
        `slot_key`, each distinct view once: a step's inputs where the
        port places them (a slot's cache part is a view of the global
        cache when it is contiguous there: it is charged its own bytes, and
        a leaf shared by several slots once, to the first). Returns the
        bytes charged now."""
        added = 0
        stack = [tree]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                sid = x.untyped_storage()._cdata
                view = (sid, x.storage_offset(), tuple(x.shape), x.stride())
                if view in self._arg_views:
                    continue
                self._arg_views.add(view)
                self._args.add(sid)
                nb = _alloc(x.numel() * x.element_size())
                added += nb
                self.arg_by_slot[slot_key] = \
                    self.arg_by_slot.get(slot_key, 0) + nb
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        self.arg_bytes += added
        return added

    # -- reported work ------------------------------------------------------
    def collective(self, kind, axis, n, payload, *, modeled=False):
        """One collective: issued (charged to the slot issuing it), or
        modeled (reckoned, not issued: kept apart in `modeled`)."""
        nbytes = float(payload) * COLL_FACTORS[kind](max(int(n), 1))
        if modeled:
            self.modeled.append({"kind": kind, "axis": axis, "n": int(n),
                                 "payload": float(payload),
                                 "bytes": nbytes, "modeled": True})
        else:
            self.costs(self._slot_now()).add_coll(kind, nbytes)

    def kernel(self, name, route, flops, nbytes):
        c = self.costs(self._slot_now())
        k = c.kernels.setdefault(name, {})
        k[route] = k.get(route, 0) + 1
        k["flops"] = k.get("flops", 0.0) + flops
        k["bytes"] = k.get("bytes", 0.0) + nbytes
        c.flops += flops
        c.dot_flops += flops
        c.bytes_upper += nbytes
        c.dot_bytes += nbytes
        c._by_op(name, nbytes)

    # -- totals -----------------------------------------------------------
    def total(self) -> Costs:
        out = Costs()
        for c in self.by_slot.values():
            out.merge(c)
        return out

    def slot_costs(self) -> dict:
        """{(d, s, t): Costs} with the work outside any slot in slot 0."""
        out = {}
        for key, c in self.by_slot.items():
            out.setdefault(_norm(key), Costs()).merge(c)
        return out
