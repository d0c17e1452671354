"""The port's observability layer (repro_torch.obs) — the counterparts of
tests/test_obs.py: tracer and metrics semantics, the zero-overhead disabled
path, Chrome-trace export, the summary CLI (its lines equal the JAX
package's on the same trace, plus the port's self-time lines), the WSP
staleness audit, Scheduler event invariants and the Telemetry helpers. On
the CPU, at small sizes.

test_obs.py's spmd case of the wait-seconds check is in
tests/test_torch_spmd_api.py, beside the spmd backend's other tests.
"""
import json
import time

import numpy as np
import pytest

from repro.obs import Tracer as JTracer
from repro.obs.export import to_chrome as j_to_chrome
from repro.obs.summary import summarize as j_summarize
from repro_torch.api import (BSP, ClusterSpec, Engine, Plan, RunSpec,
                             ServeReport, ServeSpec, Telemetry, WSP)
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.wave import tick_schedule
from repro_torch.obs import (NULL_SPAN, NULL_TRACER, Histogram,
                             MetricsRegistry, Tracer)
from repro_torch.obs.export import load, to_chrome, validate_chrome, \
    write_chrome
from repro_torch.obs.metrics import INT_BOUNDS, quantile_from_snapshot
from repro_torch.obs.summary import main as summary_main, summarize


def _cfg(**over):
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_microbatches=2)
    base.update(over)
    return reduced(ARCHS["qwen3-0.6b"], **base)


def _wsp_plan(**over):
    kw = dict(arch=_cfg(),
              cluster=ClusterSpec(num_vw=2, topology="2node"),
              sync=WSP(D=1),
              run=RunSpec(max_waves=3, batch=4, seq=16))
    kw.update(over)
    return Plan(**kw)


def _engine(plan, **kw):
    return Engine(plan, device="cpu", **kw)


# ---------------------------------------------------------------------------
# metrics: histogram + registry semantics
# ---------------------------------------------------------------------------
def test_histogram_buckets_and_exact_sidecars():
    h = Histogram(bounds=(1, 2, 4))
    for v in (0, 1, 1.5, 3, 100):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5 and h.vmin == 0 and h.vmax == 100
    assert h.total == pytest.approx(105.5)
    assert h.quantile(0.1) == 1
    assert h.quantile(0.5) == 2
    assert h.quantile(0.99) == 100
    snap = h.snapshot()
    assert quantile_from_snapshot(snap, 0.5) == h.quantile(0.5)
    assert quantile_from_snapshot(snap, 0.99) == 100
    assert quantile_from_snapshot({}, 0.5) is None
    assert quantile_from_snapshot(None, 0.5) is None


def test_registry_roundtrip_and_disabled_noop():
    m = MetricsRegistry()
    m.counter_inc("a")
    m.counter_inc("a", 2.0)
    m.gauge_set("g", 7)
    m.observe("h", 3, bounds=INT_BOUNDS)
    snap = m.snapshot()
    assert snap["counters"]["a"] == 3.0
    assert snap["gauges"]["g"] == 7.0
    assert snap["histograms"]["h"]["count"] == 1
    off = MetricsRegistry(enabled=False)
    off.counter_inc("a")
    off.gauge_set("g", 1)
    off.observe("h", 1)
    assert off.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


# ---------------------------------------------------------------------------
# tracer: disabled is a true no-op; enabled records typed events
# ---------------------------------------------------------------------------
def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    assert tr.span("t", "x") is NULL_SPAN
    assert NULL_TRACER.span("t", "y", a=1) is NULL_SPAN
    with tr.span("t", "x"):
        pass
    tr.add_span("t", "x", 0.0, 1.0)
    tr.instant("t", "x")
    tr.counter("t", "c", 3)
    tr.metrics.observe("h", 1)
    assert len(tr) == 0
    assert tr.metrics.snapshot() == {"counters": {}, "gauges": {},
                                     "histograms": {}}


def test_disabled_tracer_hot_path_overhead():
    """100k disabled span() + counter() calls in well under a second."""
    tr = Tracer(enabled=False)
    t0 = time.monotonic()
    for _ in range(100_000):
        with tr.span("track", "name", k=1):
            pass
        tr.counter("track", "c", 1)
    assert time.monotonic() - t0 < 1.0
    assert len(tr) == 0


def test_tracer_records_span_instant_counter():
    t = {"v": 0.0}

    def clk():
        t["v"] += 1.0
        return t["v"]

    tr = Tracer(clock=clk)
    with tr.span("trk", "work", tag="x"):
        pass
    tr.instant("trk", "mark", n=1)
    tr.counter("trk", "depth", 4)
    evs = tr.events()
    assert [e[0] for e in evs] == ["X", "i", "C"]
    ph, track, name, t0, dur, args = evs[0]
    assert (track, name, t0, dur, args) == ("trk", "work", 1.0, 1.0,
                                            {"tag": "x"})
    assert evs[2][5] == {"depth": 4}


# ---------------------------------------------------------------------------
# the pipeline tick schedule
# ---------------------------------------------------------------------------
def test_tick_schedule_shapes():
    sched, ticks = tick_schedule(2, 2)
    assert ticks == 3
    assert len(sched) == 2 * 3
    for s in range(2):
        mbs = [mb for st, _, mb in sched if st == s and mb >= 0]
        assert mbs == [0, 1]
    _, ticks_ov = tick_schedule(3, 4, overlap=True)
    assert ticks_ov == 4 + 2 * 2


# ---------------------------------------------------------------------------
# Chrome trace export and the summary CLI
# ---------------------------------------------------------------------------
def _sample_tracer(cls=Tracer):
    t = {"v": 10.0}

    def clk():
        t["v"] += 0.5
        return t["v"]

    tr = cls(clock=clk)
    with tr.span("alpha", "work"):
        tr.instant("beta", "mark")
    tr.counter("alpha", "depth", 2)
    return tr


def test_export_chrome_schema(tmp_path):
    tr = _sample_tracer()
    doc = to_chrome(tr.events(), telemetry=tr.metrics.snapshot())
    validate_chrome(doc)
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"
    names = {e["args"]["name"]: e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert set(names) == {"alpha", "beta"}
    xs = [e for e in evs if e["ph"] == "X"]
    ins = [e for e in evs if e["ph"] == "i"]
    assert len(xs) == 1 and len(ins) == 1
    assert xs[0]["tid"] == names["alpha"] and xs[0]["dur"] > 0
    assert ins[0]["s"] == "t"
    assert min(e["ts"] for e in evs if e["ph"] != "M") == 0
    p = tmp_path / "t.json"
    assert write_chrome(tr.events(), str(p)) == str(p)
    assert load(str(p))["traceEvents"]
    json.loads(p.read_text())
    # the JAX package exports the same events to the same document
    jtr = _sample_tracer(JTracer)
    assert json.loads(json.dumps(j_to_chrome(
        jtr.events(), telemetry=jtr.metrics.snapshot()))) == \
        json.loads(json.dumps(doc))


def test_validate_chrome_rejects_malformed():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome({})
    with pytest.raises(ValueError, match="empty"):
        validate_chrome({"traceEvents": []})
    doc = to_chrome(_sample_tracer().events())
    bad = json.loads(json.dumps(doc))
    bad["traceEvents"][1]["ph"] = "Z"
    with pytest.raises(ValueError, match="ph"):
        validate_chrome(bad)
    bad2 = json.loads(json.dumps(doc))
    for e in bad2["traceEvents"]:
        if e["ph"] == "X":
            e["ts"] = -5
    with pytest.raises(ValueError, match="ts"):
        validate_chrome(bad2)


def test_summary_cli_exit_codes(tmp_path):
    tr = _sample_tracer()
    p = tmp_path / "ok.json"
    tr.export(str(p))
    assert summary_main([str(p)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert summary_main([str(bad)]) == 1
    assert summary_main([str(tmp_path / "missing.json")]) == 1


def test_summary_module_runs_as_a_cli(tmp_path):
    """python -m repro_torch.obs.summary trace.json: exit 0 and the lines;
    exit 1 on a trace whose staleness exceeds its D."""
    import os
    import subprocess
    import sys
    tr = Tracer()
    tr.metrics.gauge_set("wsp/D", 1)
    tr.metrics.observe("wsp/staleness", 1, bounds=INT_BOUNDS)
    with tr.span("vw0", "wave"):
        pass
    ok = tmp_path / "ok.json"
    tr.export(str(ok))
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.obs.summary",
                          str(ok)], capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode == 0 and "bound D=1 -> OK" in run.stdout
    doc = load(str(ok))
    doc["telemetry"]["histograms"]["wsp/staleness"]["max"] = 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    run = subprocess.run([sys.executable, "-m", "repro_torch.obs.summary",
                          str(bad)], capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode == 1 and "staleness audit failed" in run.stderr


# ---------------------------------------------------------------------------
# instrumented training: bit-identity, staleness audit, wait_seconds
# ---------------------------------------------------------------------------
def test_fit_bit_identical_with_and_without_tracer():
    """Tracing observes, never perturbs: a one-VW WSP fleet and the BSP loop
    give the same losses, bit for bit, traced and untraced."""
    def solo():
        return _wsp_plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=0))
    plain = _engine(solo()).fit()
    tr = Tracer()
    traced = _engine(solo(), tracer=tr).fit()
    assert plain.losses_by_worker() == traced.losses_by_worker()
    assert plain.telemetry is None and traced.telemetry is not None
    assert len(tr) > 0

    def bsp():
        return Plan(arch=_cfg(), cluster=ClusterSpec(num_vw=2,
                                                     topology="2node"),
                    sync=BSP(), run=RunSpec(max_waves=2, batch=4, seq=16))
    p = _engine(bsp()).fit()
    t = _engine(bsp(), tracer=Tracer()).fit()
    assert p.losses_by_worker() == t.losses_by_worker()


def test_generate_bit_identical_with_and_without_tracer():
    def plan():
        return Plan(arch=_cfg(), run=RunSpec(),
                    serve=ServeSpec(prompt_len=8, gen=4, max_batch=2))
    plain = _engine(plan()).generate()
    traced = _engine(plan(), tracer=Tracer()).generate()
    np.testing.assert_array_equal(plain.tokens, traced.tokens)
    assert plain.telemetry is None and traced.telemetry is not None
    assert traced.prefill_calls == 1


def test_traced_wsp_staleness_audited_against_D(tmp_path):
    tr = Tracer()
    plan = _wsp_plan(cluster=ClusterSpec(num_vw=2, topology="2node",
                                         speeds=(0.0, 0.05)),
                     sync=WSP(D=2, pull_every=2, async_push=True),
                     run=RunSpec(max_waves=4, batch=4, seq=16))
    rep = _engine(plan, tracer=tr).fit()
    tel = rep.telemetry
    st = tel.histograms["wsp/staleness"]
    assert st["count"] >= plan.run.max_waves
    assert st["max"] <= 2
    assert tel.gauges["wsp/D"] == 2
    assert "wsp/staleness_violations" not in tel.counters
    assert any(k.startswith("link/") for k in tel.gauges)
    p = tmp_path / "wsp.json"
    tr.export(str(p))
    lines = summarize(load(str(p)))
    assert any("bound D=2 -> OK" in ln for ln in lines)
    # the JAX package's summary reads the port's trace line for line; the
    # port's adds each span name's self time by track
    own = [ln for ln in lines if ln.startswith("  self ")]
    assert any(ln.startswith("  self vw0 wave ") for ln in own)
    assert j_summarize(load(str(p))) == [ln for ln in lines
                                         if ln not in own]
    doc = load(str(p))
    doc["telemetry"]["histograms"]["wsp/staleness"]["max"] = 3
    with pytest.raises(ValueError, match="staleness audit failed"):
        summarize(doc)


def test_wait_seconds_normalized_across_backends():
    # threads: wid -> gate-blocked seconds for every worker
    rep = _engine(_wsp_plan()).fit()
    assert sorted(rep.wait_seconds) == ["vw0", "vw1"]
    # bsp: wid -> straggler wait; the barrier charges somebody
    bsp = Plan(arch=_cfg(),
               cluster=ClusterSpec(num_vw=2, topology="2node",
                                   speeds=(0.0, 0.05)),
               sync=BSP(), run=RunSpec(max_waves=2, batch=4, seq=16))
    rep = _engine(bsp).fit()
    assert sorted(rep.wait_seconds) == ["vw0", "vw1"]
    assert all(v >= 0 for v in rep.wait_seconds.values())
    assert max(rep.wait_seconds.values()) > 0


# ---------------------------------------------------------------------------
# scheduler: event invariants, admission groups, TTFT
# ---------------------------------------------------------------------------
def _sched_run(n_requests=6, tracer=None):
    plan = Plan(arch=_cfg(),
                serve=ServeSpec(prompt_len=8, gen=3, max_batch=2,
                                page_size=4),
                run=RunSpec())
    eng = _engine(plan, tracer=tracer)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, 256, size=int(rng.integers(2, 9)),
                                        dtype=np.int32))
            for i in range(n_requests)]
    return Scheduler(eng).run(reqs), eng


def test_scheduler_event_invariants():
    tr = Tracer()
    rep, _ = _sched_run(tracer=tr)
    evs = tr.events()
    admits = [e for e in evs if e[0] == "i" and e[2] == "admit"]
    retires = [e for e in evs if e[0] == "i" and e[2] == "retire"]
    assert sorted(e[5]["rid"] for e in admits) == list(range(6))
    assert sorted(e[5]["rid"] for e in retires) == list(range(6))
    steps = [e for e in evs if e[0] == "X" and e[2] == "decode_step"]
    assert len(steps) == rep.decode_steps
    assert sum(e[5]["slots"] for e in steps) == rep.slot_steps
    groups = [e for e in evs if e[0] == "X" and e[2] == "prefill_group"]
    assert len(groups) == rep.prefill_calls
    assert {e[5]["group"] for e in groups} == \
        {e[5]["group"] for e in admits}


def test_scheduler_groups_and_ttft():
    rep, _ = _sched_run()
    assert rep.prefill_calls >= 2
    by_group: dict = {}
    for r in rep.requests:
        assert 0 <= r.group < rep.prefill_calls
        assert r.ttft_s > 0
        by_group.setdefault(r.group, []).append(r)
    for rs in by_group.values():
        assert len({r.prefill_s for r in rs}) == 1
        assert len({r.ttft_s for r in rs}) == 1
    assert rep.mean_ttft() <= rep.wall_s
    assert sum({r.group: r.prefill_s for r in rep.requests}.values()) == \
        pytest.approx(rep.prefill_s)
    ttfts = {r.group: r.ttft_s for r in rep.requests}
    ordered = [ttfts[g] for g in sorted(ttfts)]
    assert ordered == sorted(ordered)
    assert ServeReport().mean_ttft() is None


def test_telemetry_helpers():
    m = MetricsRegistry()
    m.observe("wsp/staleness", 1, bounds=INT_BOUNDS)
    m.observe("wsp/staleness", 2, bounds=INT_BOUNDS)
    m.gauge_set("link/eth/bytes", 1e6)
    m.gauge_set("link/eth/modeled_s", 0.5)
    tel = Telemetry.from_metrics(m)
    assert tel.staleness_max() == 2
    assert tel.hist_quantile("wsp/staleness", 0.5) == 1
    assert tel.link_utilization(1.0) == {"eth": 0.5}
    assert tel.to_dict()["gauges"]["link/eth/bytes"] == 1e6
    assert Telemetry().staleness_max() is None
