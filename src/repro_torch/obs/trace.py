"""Thread-safe tracer: spans, instant events and counter samples.

Events carry (track, name, timestamps, args). A *track* is the Perfetto row
the event renders on — one per virtual worker, pipeline stage, network link,
scheduler, engine — so the exported trace reads like the cluster: wave
compute per VW, pushes in flight on the links, pipeline bubbles per stage.

Timestamps come from an injectable clock (default time.monotonic). A
simulated run that scales modeled delays (`ClusterSpec.time_scale`) can
inject a clock in the same scaled currency so the trace reads in modeled
time rather than host wall time.

Disabled tracing is free: `NULL_TRACER` (and any `Tracer(enabled=False)`)
returns the shared `NULL_SPAN` singleton from span() and falls through
every other method without allocating or locking, so instrumentation can
stay unconditionally in hot paths. The attached MetricsRegistry shares the
enabled flag.
"""
from __future__ import annotations

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


class _Span:
    __slots__ = ("_tr", "_track", "_name", "_args", "_t0")

    def __init__(self, tr: "Tracer", track: str, name: str, args: dict):
        self._tr, self._track, self._name, self._args = tr, track, name, args

    def __enter__(self):
        self._t0 = self._tr.now()
        return self

    def __exit__(self, *exc):
        self._tr.add_span(self._track, self._name, self._t0, self._tr.now(),
                          **self._args)
        return False


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
        with self._lock:
            self._events.append(("X", track, name, t0, max(0.0, t1 - t0),
                                 args))

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

    def events(self) -> list:
        return self._parent.events()

    def __len__(self) -> int:
        return len(self._parent)

    def export(self, path: str, *, telemetry: Optional[dict] = None) -> str:
        return self._parent.export(path, telemetry=telemetry)

    def scoped(self, prefix: str) -> "Tracer":
        return _ScopedTracer(self._parent, self._prefix + prefix)


NULL_TRACER = Tracer(enabled=False)


def emit_pipeline_ticks(tracer: Tracer, track_prefix: str, schedule,
                        ticks: int, t0: float, t1: float) -> None:
    """Render one wave's pipeline schedule as per-stage tick spans.

    `schedule` is core.wave.tick_schedule output: (stage, tick, mb) entries
    with mb < 0 marking bubble ticks. The wave's measured [t0, t1) window is
    divided evenly over `ticks`; each stage gets its own track
    (`{track_prefix}/stage{s}`) carrying `mb{j}` compute spans and `bubble`
    spans. Busy/bubble seconds accumulate into the metrics counters
    `pipe/busy_s` / `pipe/bubble_s` (bubble fraction = bubble/(busy+bubble)).

    The schedule is the *modeled* intra-VW pipeline (what the wave step
    executes on its k GPUs); on the threads backend the wave step runs the
    sequential oracle, so these tracks visualize the Plan's schedule scaled
    into the wave's measured duration rather than per-tick measurements.
    """
    if not tracer.enabled or ticks <= 0:
        return
    dt = (t1 - t0) / ticks
    busy = 0
    for stage, tick, mb in schedule:
        a = t0 + tick * dt
        name = "bubble" if mb < 0 else f"mb{mb}"
        tracer.add_span(f"{track_prefix}/stage{stage}", name, a, a + dt,
                        tick=tick)
        if mb >= 0:
            busy += 1
    tracer.metrics.counter_inc("pipe/busy_s", busy * dt)
    tracer.metrics.counter_inc("pipe/bubble_s", (len(schedule) - busy) * dt)
