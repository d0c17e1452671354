"""Thread-safe tracer: spans, instant events and counter samples.

Events carry (track, name, timestamps, args). A *track* is the Perfetto row
the event renders on — one per virtual worker, network link, scheduler,
engine — so the exported trace reads like the cluster: wave compute per
VW and its parts, pushes in flight on the links, the serve step's parts.
Spans on one track nest: a span inside another on its track is its child,
and a span's self time is its duration minus its children's.

Timestamps come from an injectable clock (default time.monotonic). A
simulated run that scales modeled delays (`ClusterSpec.time_scale`) can
inject a clock in the same scaled currency so the trace reads in modeled
time rather than host wall time.

Disabled tracing is free: `NULL_TRACER` (and any `Tracer(enabled=False)`)
returns the shared `NULL_SPAN` singleton from span() and falls through
every other method without allocating or locking, so instrumentation can
stay unconditionally in hot paths. The attached MetricsRegistry shares the
enabled flag.

Code that holds no tracer records into a thread's bound scope:
`Tracer.bind(track, **ids)` binds the tracer, a track and ids (say
`wave=`) for the thread, and the module-level `span(name, **args)` opens
a span there (NULL_SPAN when nothing is bound). `Tracer.total(track,
name)` is the running sum of a span name's durations, for reports that
take this run's share as a delta.

While a torch.profiler is recording, each span also opens a
`record_function` range named `track/name`, so the spans sit in the
profiler's trace on its clock, above the device work they launched. The
profiler keeps the ranges only with CPU activity on (a CUDA-only profile
holds none), and only of the thread that started it unless it was made
with `profile_all_threads`. With no profiler running no profiler call is
made.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry


class _NullSpan:
    """Shared no-op context manager returned by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _recording_profiler():
    """torch's autograd profiler module while a profiler records, else None
    (a flag read: torch is not imported here, and without torch imported
    no profiler can run)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class _Span:
    __slots__ = ("_tr", "_track", "_name", "_args", "_t0", "_rf")

    def __init__(self, tr: "Tracer", track: str, name: str, args: dict):
        self._tr, self._track, self._name, self._args = tr, track, name, args

    def __enter__(self):
        prof = _recording_profiler()
        self._rf = None
        if prof is not None:
            self._rf = prof.record_function(f"{self._track}/{self._name}")
            self._rf.__enter__()
        self._t0 = self._tr.now()
        return self

    def __exit__(self, *exc):
        t1 = self._tr.now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tr.add_span(self._track, self._name, self._t0, t1, **self._args)
        return False


# the thread's bound scope: (tracer, track, ids) or unset
_scope = threading.local()


class _Bind:
    __slots__ = ("_scope", "_prev")

    def __init__(self, scope: tuple):
        self._scope = scope

    def __enter__(self):
        self._prev = getattr(_scope, "v", None)
        _scope.v = self._scope
        return self

    def __exit__(self, *exc):
        _scope.v = self._prev
        return False


def span(name: str, **args):
    """A span named `name` on the thread's bound track, carrying the bound
    ids and `args`; NULL_SPAN when no enabled tracer is bound."""
    return span_in(current_scope(), name, **args)


def current_scope():
    """The calling thread's bound scope (None: nothing bound), for work
    that runs later on another thread (autograd's backward) to record
    into with span_in."""
    return getattr(_scope, "v", None)


def span_in(scope, name: str, **args):
    """span() in a scope taken by current_scope()."""
    if scope is None:
        return NULL_SPAN
    tr, track, ids = scope
    return tr.span(track, name, **ids, **args)


class Tracer:
    """Collects trace events; export via repro_torch.obs.export / Tracer.export.

    Event tuples are (ph, track, name, t0_s, dur_s, args) with ph one of
    'X' (span), 'i' (instant), 'C' (counter sample: args {name: value}).
    """

    def __init__(self, *, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        self.enabled = enabled
        self._clock = clock if clock is not None else time.monotonic
        self.metrics = MetricsRegistry(enabled=enabled)
        self._events: list = []
        self._totals: dict = {}
        self._lock = threading.Lock()

    # -- time --------------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    # -- recording ---------------------------------------------------------
    def span(self, track: str, name: str, **args):
        """Context manager timing a region onto `track`."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, track, name, args)

    def add_span(self, track: str, name: str, t0: float, t1: float,
                 **args) -> None:
        """Record an already-timed [t0, t1) interval."""
        if not self.enabled:
            return
        dur = max(0.0, t1 - t0)
        key = (track, name)
        with self._lock:
            self._events.append(("X", track, name, t0, dur, args))
            self._totals[key] = self._totals.get(key, 0.0) + dur

    def total(self, track: str, name: str) -> float:
        """Seconds summed over every `name` span recorded on `track`."""
        if not self.enabled:
            return 0.0
        with self._lock:
            return self._totals.get((track, name), 0.0)

    def instant(self, track: str, name: str, **args) -> None:
        if not self.enabled:
            return
        t = self.now()
        with self._lock:
            self._events.append(("i", track, name, t, 0.0, args))

    def counter(self, track: str, name: str, value: float) -> None:
        """Sample a counter series (rendered as a counter track)."""
        if not self.enabled:
            return
        t = self.now()
        with self._lock:
            self._events.append(("C", track, name, t, 0.0, {name: value}))

    # -- scoping -----------------------------------------------------------
    def bind(self, track: str, **ids):
        """Context manager binding this tracer, `track` and `ids` to the
        calling thread for the module-level span(); nests, restoring the
        outer binding on exit. Disabled tracers bind nothing."""
        if not self.enabled:
            return NULL_SPAN
        return _Bind((self, track, ids))

    def scoped(self, prefix: str) -> "Tracer":
        """A view of this tracer that prepends `prefix` to every track name
        — the Router gives each serve replica `scoped('r{i}/')` so one
        exported trace reads like the fleet ('r0/sched', 'r1/sched', ...).
        Events, the lock, the clock and the MetricsRegistry are shared with
        the parent; disabled tracers return themselves (still free)."""
        if not self.enabled:
            return self
        return _ScopedTracer(self, prefix)

    # -- reading -----------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __bool__(self) -> bool:
        # len() measures recorded events, but a tracer is not a container:
        # `if tracer:` must not silently flip on the first recorded event
        return True

    # -- export ------------------------------------------------------------
    def export(self, path: str, *, telemetry: Optional[dict] = None) -> str:
        """Write Chrome-trace-event JSON (Perfetto-loadable). The metrics
        snapshot (or the given `telemetry` dict) rides along under the
        top-level 'telemetry' key for trace readers and audits."""
        from repro_torch.obs.export import write_chrome
        tel = telemetry if telemetry is not None else self.metrics.snapshot()
        return write_chrome(self.events(), path, telemetry=tel)


class _ScopedTracer(Tracer):
    """Track-prefixing view over a parent Tracer (see Tracer.scoped).

    Shares the parent's event list, lock, clock and metrics — only track
    names change, so the parent's export() sees every scoped event and
    metrics stay fleet-global (counters from all replicas accumulate in
    one registry)."""

    def __init__(self, parent: Tracer, prefix: str):
        # deliberately NOT calling super().__init__: this view delegates
        # to the parent (whose _Span objects bind to the parent, so the
        # prefix is applied exactly once), rather than owning fresh state
        self._parent = parent
        self._prefix = prefix
        self.enabled = parent.enabled
        self.metrics = parent.metrics

    def now(self) -> float:
        return self._parent.now()

    def span(self, track: str, name: str, **args):
        return self._parent.span(self._prefix + track, name, **args)

    def add_span(self, track: str, name: str, t0: float, t1: float,
                 **args) -> None:
        self._parent.add_span(self._prefix + track, name, t0, t1, **args)

    def instant(self, track: str, name: str, **args) -> None:
        self._parent.instant(self._prefix + track, name, **args)

    def counter(self, track: str, name: str, value: float) -> None:
        self._parent.counter(self._prefix + track, name, value)

    def total(self, track: str, name: str) -> float:
        return self._parent.total(self._prefix + track, name)

    def events(self) -> list:
        return self._parent.events()

    def __len__(self) -> int:
        return len(self._parent)

    def export(self, path: str, *, telemetry: Optional[dict] = None) -> str:
        return self._parent.export(path, telemetry=telemetry)

    def scoped(self, prefix: str) -> "Tracer":
        return _ScopedTracer(self._parent, self._prefix + prefix)


NULL_TRACER = Tracer(enabled=False)

