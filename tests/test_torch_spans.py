"""The spans inside the serve step and the training wave (repro_torch.obs):
the Scheduler's admission / d2h / pick and the Engine's issue / drain, the
ServeReport totals read from them and the prefill's real and padded
tokens; the wave's fwd_bwd / optim and the pull's pull_wait / h2d in the
worker's bound scope, the parameter server's spans with their wave; the
Tracer's bind / span / total; torch.profiler ranges on the spans; the
summary's self times. On the CPU, at small sizes."""
import numpy as np
import pytest
import torch

from repro_torch.api import ClusterSpec, Engine, PartitionSpec, Plan, \
    RunSpec, ServeReport, ServeSpec, WSP
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.obs import NULL_SPAN, NULL_TRACER, Tracer, span, trace
from repro_torch.obs.export import to_chrome
from repro_torch.obs.summary import self_times, summarize

B, P = 2, 8
PARTS = ("decode_issue_s", "decode_drain_s", "logits_d2h_s", "pick_s",
         "admit_s")


def _cfg(arch="qwen3-0.6b", **over):
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_microbatches=2)
    base.update(over)
    return reduced(ARCHS[arch], **base)


def _requests(n=6, seed=7, ragged=False):
    """n requests of 2..P tokens; ragged: budgets of 1..3 tokens, so slots
    retire apart and admission groups hold fewer than B rows."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, 256, size=int(rng.integers(2, P + 1)), dtype=np.int32),
        max_new_tokens=1 + i % 3 if ragged else 0)
        for i in range(n)]


def _serve(tracer=None, n=6, ragged=False, **cfg):
    plan = Plan(arch=_cfg(**cfg),
                serve=ServeSpec(prompt_len=P, gen=3, max_batch=B,
                                page_size=4),
                run=RunSpec())
    eng = Engine(plan, device="cpu", tracer=tracer)
    reqs = _requests(n, ragged=ragged)
    return Scheduler(eng).run(reqs), reqs


def _spans(tr, track, name):
    return [e for e in tr.events()
            if e[0] == "X" and e[1] == track and e[2] == name]


def _inside(child, parent, eps=1e-9):
    return parent[3] - eps <= child[3] and \
        child[3] + child[4] <= parent[3] + parent[4] + eps


# ---------------------------------------------------------------------------
# the serve step
# ---------------------------------------------------------------------------
def test_traced_scheduler_fills_the_serve_step_totals():
    tr = Tracer()
    rep, _ = _serve(tr)
    assert rep.decode_steps > 0
    for name in PARTS:
        assert getattr(rep, name) > 0, name
    for name, track, span_name in (("logits_d2h_s", "sched", "d2h"),
                                   ("pick_s", "sched", "pick"),
                                   ("admit_s", "sched", "admission")):
        got = sum(e[4] for e in _spans(tr, track, span_name))
        assert getattr(rep, name) == pytest.approx(got)
    assert len(_spans(tr, "sched", "pick")) == rep.decode_steps
    assert len(_spans(tr, "sched", "d2h")) == rep.decode_steps


def test_issue_plus_drain_equals_the_engine_decode_spans():
    tr = Tracer()
    # deep enough that a step dwarfs the spans' own few microseconds
    rep, _ = _serve(tr, num_layers=12, d_model=64, d_ff=128)
    decode = _spans(tr, "engine", "decode")
    assert len(decode) == rep.decode_steps
    for d in decode:
        issue = [e for e in _spans(tr, "engine", "issue") if _inside(e, d)]
        drain = [e for e in _spans(tr, "engine", "drain") if _inside(e, d)]
        assert len(issue) == 1 and len(drain) == 1
        assert issue[0][3] + issue[0][4] <= drain[0][3]
    total = sum(e[4] for e in decode)
    assert rep.decode_issue_s + rep.decode_drain_s == \
        pytest.approx(total, rel=0.01)


@pytest.mark.parametrize("traced", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_prefill_tokens_count_real_and_padded_rows(arch, traced):
    """The slots a prefill call runs: qwen3's rows do not couple, so a
    group runs its own rows at its width (each prefill_group's rows x
    width, fewer than B x P a call); granite's MoE capacity couples them
    (trap M1), so every call runs B x P."""
    tr = Tracer() if traced else None
    rep, reqs = _serve(tr, n=7, ragged=True, arch=arch)
    assert rep.prefill_tokens == sum(len(r.prompt) for r in reqs)
    assert 0 < rep.prefill_tokens < rep.prefill_slot_tokens
    if arch.startswith("granite"):
        assert rep.prefill_slot_tokens == rep.prefill_calls * B * P
        return
    rows = {}
    for r in rep.requests:
        rows.setdefault(r.group, []).append(r.prompt_len)
    assert len(rows) == rep.prefill_calls
    assert rep.prefill_slot_tokens == sum(len(v) * P for v in rows.values())
    assert rep.prefill_slot_tokens < rep.prefill_calls * B * P
    if traced:
        groups = [e[5] for e in _spans(tr, "sched", "prefill_group")]
        assert rep.prefill_slot_tokens == sum(g["rows"] * g["width"]
                                              for g in groups)


def test_d2h_nests_in_decode_step_and_pick_follows_it():
    tr = Tracer()
    rep, _ = _serve(tr)
    steps = sorted(_spans(tr, "sched", "decode_step"), key=lambda e: e[3])
    d2h = _spans(tr, "sched", "d2h")
    picks = {e[5]["step"]: e for e in _spans(tr, "sched", "pick")}
    assert len(steps) == len(picks) == rep.decode_steps
    for k, st in enumerate(steps):
        assert sum(_inside(e, st) for e in d2h) == 1
        pick = picks[st[5]["step"]]
        assert pick[3] >= st[3] + st[4]
        if k + 1 < len(steps):
            assert pick[3] + pick[4] <= steps[k + 1][3]


def test_no_sched_span_is_named_admit():
    tr = Tracer()
    _serve(tr)
    sched = [e for e in tr.events() if e[1] == "sched"]
    assert not [e for e in sched if e[0] == "X" and e[2] == "admit"]
    assert [e for e in sched if e[0] == "i" and e[2] == "admit"]
    rounds = _spans(tr, "sched", "admission")
    groups = _spans(tr, "sched", "prefill_group")
    assert len(rounds) >= len(groups) > 0
    # the round that admitted a group ends before the group's prefill
    for g in groups:
        r = max((r for r in rounds if r[3] <= g[3]), key=lambda r: r[3])
        assert r[3] + r[4] <= g[3]


def test_null_tracer_serves_the_same_tokens_with_zero_totals():
    traced, _ = _serve(Tracer())
    plain, _ = _serve()
    assert [r.tokens for r in plain.requests] == \
        [r.tokens for r in traced.requests]
    for name in PARTS:
        assert getattr(plain, name) == 0.0, name
    assert plain.prefill_tokens == traced.prefill_tokens
    assert plain.prefill_slot_tokens == traced.prefill_slot_tokens


def test_report_totals_are_this_runs_share_of_a_lasting_tracer():
    tr = Tracer()
    plan = Plan(arch=_cfg(), serve=ServeSpec(prompt_len=P, gen=3,
                                             max_batch=B, page_size=4),
                run=RunSpec())
    sched = Scheduler(Engine(plan, device="cpu", tracer=tr.scoped("r0/")))
    first = sched.run(_requests(4, seed=1))
    n0 = len(_spans(tr, "r0/sched", "pick"))
    second = sched.run(_requests(4, seed=2))
    picks = _spans(tr, "r0/sched", "pick")[n0:]
    assert len(picks) == second.decode_steps
    assert second.pick_s == pytest.approx(sum(e[4] for e in picks))
    assert tr.total("r0/sched", "pick") == pytest.approx(
        first.pick_s + second.pick_s)
    merged = ServeReport.merge([first, second])
    for name in PARTS + ("prefill_tokens", "prefill_slot_tokens"):
        assert getattr(merged, name) == pytest.approx(
            getattr(first, name) + getattr(second, name))


# ---------------------------------------------------------------------------
# the training wave
# ---------------------------------------------------------------------------
def _fit(tracer=None, waves=4):
    plan = Plan(arch=_cfg(), cluster=ClusterSpec(num_vw=1),
                sync=WSP(D=1, pull_every=2, async_push=True),
                run=RunSpec(max_waves=waves, batch=4, seq=16))
    return Engine(plan, device="cpu", tracer=tracer).fit(), plan


def test_traced_fit_records_the_waves_parts():
    tr = Tracer()
    rep, plan = _fit(tr)
    nm = plan.num_microbatches
    waves = _spans(tr, "vw0", "wave")
    assert [e[5]["wave"] for e in waves] == list(range(plan.run.max_waves))
    fb, opt = _spans(tr, "vw0", "fwd_bwd"), _spans(tr, "vw0", "optim")
    for w in waves:
        k = w[5]["wave"]
        mine = [e for e in fb if e[5]["wave"] == k]
        assert sorted(e[5]["mb"] for e in mine) == list(range(nm))
        assert all(_inside(e, w) for e in mine)
        o = [e for e in opt if e[5]["wave"] == k]
        assert len(o) == 1 and _inside(o[0], w)
    pulls = _spans(tr, "vw0", "pull")
    assert [e[5]["wave"] for e in pulls] == [2, 4]
    for p in pulls:
        for name in ("pull_wait", "h2d"):
            kids = [e for e in _spans(tr, "vw0", name) if _inside(e, p)]
            assert len(kids) == 1 and kids[0][5]["wave"] == p[5]["wave"]
    applies = _spans(tr, "ps", "push_apply")
    assert sorted(e[5]["wave"] for e in applies) == \
        list(range(plan.run.max_waves))
    serves = [e[5]["wave"] for e in _spans(tr, "ps", "pull_serve")]
    assert serves == [0, 2, 4]
    assert not [e for e in tr.events() if "stage" in e[1]
                or e[2] == "bubble"]
    assert "pipe/busy_s" not in rep.telemetry.counters


def test_untraced_fit_binds_no_scope_and_calls_no_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("entered untraced")
    monkeypatch.setattr(trace._Bind, "__enter__", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    rep, plan = _fit(waves=2)
    assert rep.waves == plan.run.max_waves
    assert len(NULL_TRACER) == 0


# ---------------------------------------------------------------------------
# the Tracer: bound scopes, totals, profiler ranges, self times
# ---------------------------------------------------------------------------
def test_bind_scopes_nest_and_a_disabled_tracer_binds_nothing():
    assert span("x") is NULL_SPAN
    assert NULL_TRACER.bind("vw0", wave=1) is NULL_SPAN
    tr = Tracer()
    with tr.bind("vw0", wave=3):
        with span("outer", mb=0):
            with tr.bind("vw0/inner", wave=4):
                with span("inner"):
                    pass
            with span("after"):
                pass
    assert span("x") is NULL_SPAN
    got = {e[2]: (e[1], e[5]) for e in tr.events()}
    assert got == {"outer": ("vw0", {"wave": 3, "mb": 0}),
                   "inner": ("vw0/inner", {"wave": 4}),
                   "after": ("vw0", {"wave": 3})}
    assert tr.total("vw0", "outer") == pytest.approx(
        _spans(tr, "vw0", "outer")[0][4])
    assert tr.total("vw0", "missing") == 0.0
    assert NULL_TRACER.total("vw0", "outer") == 0.0


def test_spans_are_profiler_ranges_around_their_ops():
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep, _ = _serve(tr, n=3)
    events = prof.events()
    ops = [e for e in events if e.name.startswith("aten::")]
    ranges: dict = {}
    for e in events:
        ranges.setdefault(e.name, []).append(e)
    recorded = [e for e in tr.events() if e[0] == "X"]
    assert recorded
    for key in {(e[1], e[2]) for e in recorded}:
        name = "/".join(key)
        n = len([e for e in recorded if (e[1], e[2]) == key])
        assert len(ranges.get(name, [])) == n, name
    issued = ("engine/issue", "sched/d2h", "sched/prefill_group")
    for name in issued:
        for r in ranges[name]:
            a, b = r.time_range.start, r.time_range.end
            inside = [o for o in ops if a <= o.time_range.start
                      and o.time_range.end <= b]
            assert inside, name
    assert rep.decode_steps == len(ranges["engine/issue"])


def test_no_profiler_call_without_a_running_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    tr = Tracer()
    rep, _ = _serve(tr, n=3)
    assert rep.pick_s > 0 and len(tr) > 0


def test_summary_prints_self_time_by_track():
    t = {"v": 0.0}

    def clk():
        return t["v"]

    tr = Tracer(clock=clk)
    with tr.bind("vw0", wave=0):
        with tr.span("vw0", "wave", wave=0):
            t["v"] += 1.0
            with span("fwd_bwd", mb=0):
                t["v"] += 2.0
            with span("fwd_bwd", mb=1):
                t["v"] += 3.0
            with span("optim"):
                t["v"] += 0.5
            t["v"] += 0.25
    with tr.span("ps", "push_apply", wave=0):
        t["v"] += 4.0
    doc = to_chrome(tr.events())
    own = self_times(doc)
    assert own[("vw0", "wave")] == pytest.approx([1.25, 6.75, 1])
    assert own[("vw0", "fwd_bwd")] == pytest.approx([5.0, 5.0, 2])
    assert own[("vw0", "optim")] == pytest.approx([0.5, 0.5, 1])
    assert own[("ps", "push_apply")] == pytest.approx([4.0, 4.0, 1])
    lines = summarize(doc)
    assert any(ln.startswith("  self vw0 wave ") and "self=1.25s" in ln
               for ln in lines)


def test_threads_keep_their_own_scope_and_the_totals_add_up():
    """More threads than cores, each bound to its own wave, record spans
    under a short switch interval: every span carries its thread's wave
    and the running totals equal the recorded durations."""
    import sys
    import threading
    tr = Tracer()
    n_threads, n_spans = 16, 200

    def worker(w):
        with tr.bind(f"vw{w % 2}", wave=w):
            for j in range(n_spans):
                with span("fwd_bwd", mb=j):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    evs = tr.events()
    assert len(evs) == n_threads * n_spans
    for w in range(n_threads):
        mine = [e for e in evs if e[5]["wave"] == w]
        assert len(mine) == n_spans and {e[1] for e in mine} == {f"vw{w % 2}"}
    for track in ("vw0", "vw1"):
        assert tr.total(track, "fwd_bwd") == pytest.approx(
            sum(e[4] for e in evs if e[1] == track))
    assert span("fwd_bwd") is NULL_SPAN


def test_spmd_fit_records_the_stage_sends_and_their_gradients():
    """Engine.fit on the spmd backend (mesh (1, 2, 1) on the CPU) binds
    each wave to the engine track: every ppermute between stages is a
    `pp_send` span (`dir="act"`) and so is its gradient's send back in
    backward (`dir="grad"`, recorded from autograd's thread), each with
    the wave; untraced, the wave's loss is the same."""
    def fit(tracer):
        plan = Plan(arch=_cfg(), partition=PartitionSpec(stages=2, tp=1),
                    run=RunSpec(backend="spmd", max_waves=2, batch=4,
                                seq=8))
        return Engine(plan, device="cpu", tracer=tracer).fit()

    tr = Tracer()
    rep = fit(tr)
    sends = _spans(tr, "engine", "pp_send")
    nm = _cfg().num_microbatches
    for w in range(2):
        dirs = sorted(e[5]["dir"] for e in sends if e[5]["wave"] == w)
        assert dirs == ["act"] * nm + ["grad"] * nm
    waves = _spans(tr, "engine", "wave")
    assert all(any(_inside(e, wv) for wv in waves) for e in sends)
    assert [l for *_, l in fit(None).losses] == [l for *_, l in rep.losses]
