"""Sharded parameter server for WSP data parallelism (paper Section 5; the
port of repro.core.param_server).

Holds w_global as flat host numpy f32 shards (layer round-robin over PS
shards — the paper's 'default' placement). Virtual workers push
*wave-aggregated deltas* (one push per wave — the paper's communication
saving) and pull w_global under the WSP clock gate.

A push is split into begin_push (compress + start the transport transfer,
without blocking) and finish_push (wait for the wire, apply shard-grouped
updates, advance the WSP clock); push_wave() chains the two. The async
runtime hands the delta to a per-worker outbox thread which runs the whole
push_wave off the worker's critical path.

Trees flatten in jax.tree order (`core.tree`: sorted dict keys at every
level): leaf i here is leaf i of the JAX package's server, so the shard
split, the error-feedback keys "{wid}/{i}" and the int8 quantizer's draws
are the same. Leaves may be numpy arrays or tensors (copied to the host).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core import tree as tree_lib
from repro_torch.core.wsp import WSPClockServer
from repro_torch.dist.compression import ErrorFeedbackCompressor, make_codec
from repro_torch.dist.transport import AsyncSend, NullTransport


def host_array(leaf) -> np.ndarray:
    """A numpy view of a host leaf (a tensor is copied off its device)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_flatten_np(tree):
    """(numpy leaves in jax.tree order, the tree's structure as a template
    for core.tree.unflatten_like; it holds no arrays)."""
    return ([host_array(l) for l in tree_lib.leaves(tree)],
            tree_lib.tree_map(lambda _: 0, tree))


@dataclass
class PendingPush:
    """A push whose wire transfer has been issued but not yet applied."""
    wid: str
    updates: list                      # [(leaf_idx, topk_idx | None, vals)]
    send: AsyncSend
    applied: bool = field(default=False)
    wave: Optional[int] = None         # the pushing worker's wave (traces)


class ParameterServer:
    def __init__(self, params_tree, *, D: int = 0, num_shards: int = 4,
                 compression_ratio: Optional[float] = None,
                 codec=None, transport=None, tracer=None, injector=None):
        if tracer is None:
            from repro_torch.obs import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        leaves, self.template = tree_flatten_np(params_tree)
        self.shapes = [l.shape for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.flat = [l.astype(np.float32).ravel().copy() for l in leaves]
        self.num_shards = num_shards
        # layer/leaf round-robin over shards (paper's default placement)
        self.shard_of_leaf = [i % num_shards for i in range(len(leaves))]
        self._locks = [threading.Lock() for _ in range(num_shards)]
        # serializes the apply+clock-advance of a push against snapshots:
        # a checkpoint must never capture a clock that counts a push whose
        # weights it missed, or the reverse
        self._snapshot_lock = threading.RLock()
        # per-shard monotone version, bumped on every push that touches the
        # shard; pull() reuses a cached leaf snapshot while versions match
        self._shard_version = [0] * num_shards
        self._leaf_cache: list = [None] * len(leaves)
        self.clock = WSPClockServer(D)
        self.push_count = 0
        self.bytes_pushed = 0
        self.bytes_wire = 0
        self.comm_seconds = 0.0
        self.pull_count = 0
        self.pull_cache_hits = 0          # leaf snapshots served from cache
        self.late_pushes = 0              # applied after the pusher left
        self.injector = injector          # repro_torch.faults.FaultInjector
        self.ps_stalls = 0                # injected apply stalls taken
        self._stats_lock = threading.Lock()   # accounting fields above
        # a wave-completion signal for the trainer's supervision loop
        self.push_event = threading.Event()
        if codec is not None:
            self.compressor = make_codec(codec)
        else:
            self.compressor = (ErrorFeedbackCompressor(compression_ratio)
                               if compression_ratio else None)
        self.transport = transport if transport is not None \
            else NullTransport()

    # -- worker lifecycle -------------------------------------------------
    def register(self, wid: str):
        self.clock.register(wid)

    def deregister(self, wid: str):
        self.clock.deregister(wid)
        self.push_event.set()        # wake the supervision loop

    # -- WSP protocol -----------------------------------------------------
    def begin_push(self, wid: str, deltas_tree,
                   wave: Optional[int] = None) -> PendingPush:
        """Compress a wave-aggregated delta and start its wire transfer.
        Does not block on the (simulated) network and does not touch
        w_global; the caller finishes with finish_push. `wave`, the
        worker's wave the delta comes from, labels the apply's span."""
        leaves, _ = tree_flatten_np(deltas_tree)
        updates, wire, dense = [], 0, 0
        for i, d in enumerate(leaves):
            flat = d.astype(np.float32).ravel()
            dense += flat.nbytes
            if self.compressor is not None:
                idx, vals = self.compressor.compress(f"{wid}/{i}", flat)
                wire += self.compressor.wire_bytes(idx, vals)
                updates.append((i, idx, vals))
            else:
                wire += flat.nbytes
                updates.append((i, None, flat))
        send = self.transport.send_async(wid, "ps", wire)
        with self._stats_lock:
            self.bytes_pushed += dense
            self.bytes_wire += wire
            self.comm_seconds += send.seconds
        return PendingPush(wid, updates, send, wave=wave)

    def finish_push(self, pending: PendingPush) -> int:
        """Wait for the wire, apply the update (one lock acquisition per
        touched shard), advance the worker's WSP clock.

        Fault semantics: a transport whose retry budget is exhausted
        surfaces here as the typed PushTimeout (the wave's delta never
        reached the PS — nothing is applied, the clock does not move). A
        push from a worker that was evicted while its transfer was in
        flight still applies — the delta is a stale-but-sound gradient —
        but never advances the departed worker's clock (`late_pushes`),
        so eviction cannot move the global minimum past what survivors
        gated against."""
        assert not pending.applied, "finish_push called twice"
        try:
            pending.send.wait()
        except Exception as e:
            from repro_torch.faults.errors import FaultError, PushTimeout
            if isinstance(e, FaultError):
                raise PushTimeout(pending.wid, e) from e
            raise
        by_shard: dict[int, list] = {}
        for upd in pending.updates:
            by_shard.setdefault(self.shard_of_leaf[upd[0]], []).append(upd)
        with self.tracer.span("ps", "push_apply", wid=pending.wid,
                              shards=len(by_shard), wave=pending.wave), \
                self._snapshot_lock:
            if self.injector is not None:
                # push_count is stable under the snapshot lock, so which
                # push a PSStall lands on is deterministic
                stall = self.injector.ps_stall_sleep(self.push_count)
                if stall > 0:
                    self.ps_stalls += 1
                    self.tracer.instant("ps", "stall", wid=pending.wid,
                                        push=self.push_count, seconds=stall)
                    self.tracer.metrics.counter_inc("fault/ps_stalls")
                    time.sleep(stall)
            for sid, ups in by_shard.items():
                with self._locks[sid]:
                    for i, idx, vals in ups:
                        if idx is None:
                            self.flat[i] += vals
                        else:
                            self.flat[i][idx] += vals
                    self._shard_version[sid] += 1
            pending.applied = True
            # counted at apply time (not issue time) so a snapshot's
            # push_count is exactly the number of pushes its weights contain
            self.push_count += 1
            clock = self.clock.complete_wave_if_registered(pending.wid)
            if clock is None:
                self.late_pushes += 1
                self.tracer.instant("ps", "late_push", wid=pending.wid)
                self.tracer.metrics.counter_inc("fault/late_pushes")
                clock = -1
        self.push_event.set()
        return clock

    def push_wave(self, wid: str, deltas_tree,
                  wave: Optional[int] = None) -> int:
        """Blocking push: the wire bytes of the (possibly compressed) push
        transit the simulated transport before the update lands."""
        return self.finish_push(self.begin_push(wid, deltas_tree, wave))

    def gate(self, wid: str, timeout: float = 120.0,
             at_clock: Optional[int] = None) -> bool:
        """Typed staleness gate: True when `wid` may start its next wave,
        False when it was deregistered while waiting, and the typed
        GateTimeout when the global clock failed to catch up within
        `timeout` — a stuck fleet must fail loudly, never truncate
        silently."""
        t0 = time.monotonic()
        reason = self.clock.wait_reason(wid, timeout, at_clock)
        if reason == "timeout":
            from repro_torch.faults.errors import GateTimeout
            wave = at_clock if at_clock is not None else \
                self.clock.state.clocks.get(wid, -1)
            raise GateTimeout(wid, wave, time.monotonic() - t0)
        return reason == "ok"

    def pull(self, wid: Optional[str] = None, wave: Optional[int] = None):
        """Snapshot of w_global (consistent per leaf) as a tree of numpy
        arrays. Leaves whose shard version is unchanged since the last pull
        are served from a cached snapshot instead of re-copied — the
        returned arrays are shared between pullers and read-only. When the
        puller is identified, the full parameter payload transits the
        transport. `wave`, the wave the puller starts from these weights,
        labels the span."""
        with self.tracer.span("ps", "pull_serve",
                              wid=wid if wid is not None else "snapshot",
                              wave=wave):
            out = []
            nbytes = 0
            hits = 0
            for i, f in enumerate(self.flat):
                sid = self.shard_of_leaf[i]
                with self._locks[sid]:
                    ver = self._shard_version[sid]
                    cached = self._leaf_cache[i]
                    if cached is not None and cached[0] == ver:
                        arr = cached[1]
                        hits += 1
                    else:
                        # astype always copies, detaching the snapshot from
                        # flat
                        arr = (f.reshape(self.shapes[i])
                               .astype(self.dtypes[i]))
                        # shared between pullers and with the cache: an
                        # in-place mutation must fail loudly
                        arr.flags.writeable = False
                        self._leaf_cache[i] = (ver, arr)
                out.append(arr)
                nbytes += f.nbytes
            with self._stats_lock:
                self.pull_count += 1
                self.pull_cache_hits += hits
        if wid is not None:
            sec = self.transport.send("ps", wid, nbytes)
            with self._stats_lock:
                self.comm_seconds += sec
        return tree_lib.unflatten_like(self.template, out)

    # -- checkpointing ----------------------------------------------------
    def checkpoint_state(self):
        """(params_tree, meta) snapshotted atomically with respect to pushes:
        the weights include exactly the waves the clocks count, so a resume
        neither loses nor double-applies an in-flight async push."""
        with self.tracer.span("ps", "snapshot"), self._snapshot_lock:
            params = self.pull()
            meta = {"clocks": dict(self.clock.state.clocks),
                    "push_count": self.push_count}
        return params, meta

    def load_state_dict(self, sd):
        for i, f in enumerate(sd["flat"]):
            self.flat[i][:] = f
        self._shard_version = [v + 1 for v in self._shard_version]
        self.clock.state.clocks = dict(sd["clocks"])
        self.push_count = sd["push_count"]
