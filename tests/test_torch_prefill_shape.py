"""The shape of the Scheduler's prefill calls (Engine.prefill_shape): the
admitted rows at their longest prompt rounded up to 64 for models whose
rows do not couple, the frozen [max_batch, prompt_len] for capacity-routed
MoE and the spmd step. Each row's logits, pages and per-slot state, and
the Scheduler's token streams, are the same at either shape. On the CPU,
at small sizes."""
import numpy as np
import pytest
import torch

from repro_torch.api import Engine, PartitionSpec, Plan, RunSpec, ServeSpec
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.faults.plan import FaultPlan, FaultPolicy, SlotFault
from repro_torch.obs import Tracer
from repro_torch.serve.cache import SLOT_KEYS

B, P = 4, 192
DENSE = ("qwen3-0.6b", "rwkv6-3b", "hymba-1.5b")
TOL = dict(rtol=1e-5, atol=1e-5)


def _plan(arch, *, backend="ref", gen=6, **run):
    return Plan(arch=reduced(ARCHS[arch], num_layers=2),
                serve=ServeSpec(prompt_len=P, gen=gen, max_batch=B,
                                page_size=16, kernel_backend=backend),
                run=RunSpec(**run))


def _frozen(eng):
    """Force `eng` onto the frozen [max_batch, prompt_len] prefill."""
    eng.prefill_shape = lambda rows, longest: (B, P)
    return eng


def _prompts(n, lo, hi, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi + 1)),
                         dtype=np.int32) for _ in range(n)]


def _prefill(eng, prompts, slots, shape):
    store = eng.serve_store()
    for s, p in zip(slots, prompts):
        store.alloc(s, p.shape[0] + 1)
    b, w = shape
    arr = np.zeros((b, w), np.int32)
    lens = np.ones(b, np.int32)
    for j, p in enumerate(prompts):
        arr[j, :p.shape[0]] = p
        lens[j] = p.shape[0]
    logits = eng.prefill_into(store, arr, lens, slots)
    return logits, store


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_trimmed_prefill_writes_what_the_frozen_one_does(arch, backend):
    """Two rows (57 and 100 tokens: widths 64 and 128, hymba's window of 32
    wrapped) prefilled at [2, 128] against [4, 192]: each row's logits,
    its pages and every per-slot leaf (WKV state and token shifts, SSD
    state and conv tail, the rings) agree within f32 round-off."""
    eng = Engine(_plan(arch, backend=backend), device="cpu")
    prompts = [np.arange(57, dtype=np.int32) % 251,
               (np.arange(100, dtype=np.int32) * 7) % 253]
    slots = [2, 0]
    shape = eng.prefill_shape(2, 100)
    assert shape == (2, 128)
    got, s_got = _prefill(eng, prompts, slots, shape)
    want, s_want = _prefill(eng, prompts, slots, (B, P))
    assert got.shape[0] == 2 and want.shape[0] == B
    torch.testing.assert_close(got, want[:2], **TOL)
    keys = [k for k in SLOT_KEYS if k in s_got.tree]
    assert keys or "kv_full" in s_got.tree
    for key in keys:
        pair = s_got.tree[key], s_want.tree[key]
        for a, b in (zip(*pair) if isinstance(pair[0], tuple) else [pair]):
            torch.testing.assert_close(a[:, slots], b[:, slots], **TOL)
    if "kv_full" in s_got.tree:
        for s, p in zip(slots, prompts):
            pages = torch.as_tensor(
                s_got._tab[s, :s_got.layout.pages_for(p.shape[0])]).long()
            for a, b in zip(s_got.tree["kv_full"], s_want.tree["kv_full"]):
                torch.testing.assert_close(a[:, pages], b[:, pages], **TOL)


def _requests(n=7, seed=5):
    prompts = _prompts(n, 3, P, seed)
    return [Request(rid=i, prompt=p, max_new_tokens=1 + i % 4)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch", DENSE)
def test_scheduler_streams_equal_the_frozen_shape(arch):
    """Ragged lengths and budgets (groups of 1-4 rows): the trimmed
    Scheduler serves the frozen-shape Scheduler's token streams, in fewer
    prefill slots, each call's rows x width from its prefill_group span."""
    plan = _plan(arch)
    tr = Tracer()
    eng = Engine(plan, device="cpu", tracer=tr)
    got = Scheduler(eng).run(_requests())
    frozen = _frozen(Engine(plan, params=eng._params, device="cpu"))
    want = Scheduler(frozen).run(_requests())
    assert [(r.rid, r.tokens) for r in got.requests] == \
        [(r.rid, r.tokens) for r in want.requests]
    assert got.prefill_calls == want.prefill_calls
    assert want.prefill_slot_tokens == want.prefill_calls * B * P
    groups = [e[5] for e in tr.events()
              if e[0] == "X" and e[1] == "sched" and e[2] == "prefill_group"]
    assert len(groups) == got.prefill_calls
    assert got.prefill_slot_tokens == sum(g["rows"] * g["width"]
                                          for g in groups)
    assert got.prefill_slot_tokens < want.prefill_slot_tokens
    assert all(g["width"] % 64 == 0 for g in groups)


@pytest.mark.parametrize("plan", [
    pytest.param(lambda: Plan(
        arch=reduced(ARCHS["granite-moe-1b-a400m"], num_layers=2),
        serve=ServeSpec(prompt_len=P, gen=6, max_batch=B, page_size=16)),
        id="granite-moe"),
    pytest.param(lambda: _plan("qwen3-0.6b", backend="ref").replace(
        run=RunSpec(backend="spmd"),
        partition=PartitionSpec(stages=2, tp=1, data=1)), id="qwen3-spmd"),
])
def test_coupled_rows_keep_the_frozen_shape(plan):
    """Capacity-routed MoE (trap M1) and the spmd step prefill every group
    at [max_batch, prompt_len], and prefill_into refuses another shape."""
    eng = Engine(plan(), device="cpu")
    assert eng.prefill_shape(1, 5) == (B, P)
    rep = Scheduler(eng).run(_requests(5))
    assert rep.prefill_calls > 1
    assert rep.prefill_slot_tokens == rep.prefill_calls * B * P
    with pytest.raises(ValueError, match="frozen prefill shape"):
        _prefill(eng, _prompts(1, 5, 5), [0], (1, 64))


def test_reprefill_runs_at_one_row_of_its_own_width():
    """A slot fault recovered in place rebuilds the slot from prompt +
    tokens at [1, ceil64(len)], and the request keeps its stream."""
    prompt = _prompts(1, 70, 70)[0]
    base = _plan("qwen3-0.6b", gen=8)
    plan = base.replace(faults=FaultPlan(events=(SlotFault(slot=0,
                                                           step=3),)),
                        fault_policy=FaultPolicy(slot_recovery="reprefill",
                                                 quarantine_slots=False))
    tr = Tracer()
    eng = Engine(plan, device="cpu", tracer=tr)
    rep = Scheduler(eng).run([Request(rid=0, prompt=prompt.copy())])
    ref = Scheduler(Engine(base, params=eng._params, device="cpu")).run(
        [Request(rid=0, prompt=prompt.copy())])
    assert rep.reprefills == 1
    (re,) = [e[5] for e in tr.events()
             if e[0] == "X" and e[1] == "sched" and e[2] == "reprefill"]
    assert 70 < re["depth"] <= 70 + 3
    assert re["width"] == 128
    assert rep.prefill_slot_tokens == 128 + 128
    assert rep.requests[0].tokens == ref.requests[0].tokens


def test_prefill_shape_rounds_up_and_caps():
    eng = Engine(_plan("rwkv6-3b"), device="cpu")
    assert eng.prefill_shape(1, 1) == (1, 64)
    assert eng.prefill_shape(3, 64) == (3, 64)
    assert eng.prefill_shape(3, 65) == (3, 128)
    assert eng.prefill_shape(B, 190) == (B, P)
    for rows, longest in ((0, 5), (B + 1, 5), (1, 0), (1, P + 1)):
        with pytest.raises(ValueError):
            eng.prefill_shape(rows, longest)
