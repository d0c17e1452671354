"""The port's serve stack against the JAX package's, on the CPU in f32.

The same Plans (the serve presets), the same weights (the JAX init scaled
up so streams do not repeat one token, carried with params_from_numpy),
the same requests: greedy token streams and the Scheduler's counters must
be identical. The JAX side runs its "ref" path, or its Pallas kernels in
interpret mode for serve_kernels; the port's "cuda" backend runs the
kernels' plain versions on these CPU tensors. Inside the port, paged
streams equal contiguous ones, fp8 pools included.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import get_preset as j_preset
from repro.api.serving import Request as JRequest
from repro.api.serving import Scheduler as JScheduler
from repro.serve import cache as jcache
from repro_torch.api import (Engine, FaultPlan, FaultPolicy, PartitionSpec,
                             Plan, ReplicaDown, ServeSpec, SlotFault,
                             get_preset)
from repro_torch.api.serving import Request, Scheduler
from repro_torch.serve import cache as tcache
from test_torch_model import carried_params

PROMPT, GEN = 8, 8


COUNTERS = ("peak_pages", "pages_total", "prefill_calls", "decode_steps",
            "slot_steps", "page_steps", "admit_blocked", "prefix_hit_tokens",
            "pages_shared", "cow_copies", "evictions", "preemptions")


def make_requests(seed, *, lo=2, prompt=PROMPT, gen=GEN, n=8, vocab=256,
                  shared=False):
    """n (rid, prompt, max_new_tokens) triples: prompts of lo..prompt
    tokens, 1..gen new tokens; with `shared` the even requests repeat
    request 0's prompt (prefixes to share)."""
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, vocab, int(rng.integers(lo, prompt + 1)),
                             dtype=np.int32), int(rng.integers(1, gen + 1)))
            for i in range(n)]
    if shared:
        reqs = [(i, (reqs[0] if i % 2 == 0 else reqs[i])[1], m)
                for i, _, m in reqs]
    return reqs


def assert_scheduler_matches(got, want, reqs):
    """The port's ServeReport is the JAX package's: the requests in the same
    order, each with the same stream, slot, group and admit / finish steps,
    every counter equal, and every requested token out."""
    assert [r.rid for r in got.requests] == [r.rid for r in want.requests]
    for a, b in zip(got.requests, want.requests):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)
        assert (a.slot, a.group, a.admitted_step, a.finished_step) == \
            (b.slot, b.group, b.admitted_step, b.finished_step)
    for f in COUNTERS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.tokens_out == sum(n for *_, n in reqs)


def _port_run(plan, tp, reqs, **kw):
    return Scheduler(Engine(plan, params=tp, device="cpu"), **kw).run(
        [Request(i, p.copy(), n) for i, p, n in reqs])


def _jax_run(plan, jp, reqs, **kw):
    return JScheduler(JEngine(plan, params=jp), **kw).run(
        [JRequest(i, p.copy(), n) for i, p, n in reqs])


@pytest.fixture(scope="module")
def weights():
    return carried_params(j_preset("serve_tiny").arch)


def test_generate_matches_reference(weights):
    """Engine.generate on serve_tiny: the JAX "ref" stream, the port's
    "ref" stream and the port's "cuda" stream are one stream."""
    jp, tp = weights
    prompts = np.random.default_rng(0).integers(0, 256, (4, PROMPT)).astype(
        np.int32)
    want = JEngine(j_preset("serve_tiny"), params=jp).generate(prompts)
    for backend in ("ref", "cuda"):
        plan = get_preset("serve_tiny", serve__kernel_backend=backend)
        got = Engine(plan, params=tp, device="cpu").generate(prompts)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.decode_steps == want.decode_steps == GEN - 1
    assert len(np.unique(want.tokens)) > 8


@pytest.mark.parametrize("preset,policy", [
    ("serve_paged", "fifo"), ("serve_kernels", "fifo"),
    ("serve_kernels", "deadline"), ("serve_shared", "fifo")])
def test_scheduler_matches_reference(weights, preset, policy):
    """Scheduler.run: per-request streams and the page / prefill / decode /
    memory counters equal the JAX package's (serve_kernels: Pallas in
    interpret mode against the port's kernel wrappers)."""
    jp, tp = weights
    # serve_shared: repeated prompts share pages
    reqs = make_requests(1, shared=preset == "serve_shared")
    plan = get_preset(preset)
    assert dataclasses.asdict(plan.serve) == \
        dataclasses.asdict(j_preset(preset).serve) | {
            "kernel_backend": plan.serve.kernel_backend}
    want = _jax_run(j_preset(preset), jp, reqs, policy=policy)
    got = _port_run(plan, tp, reqs, policy=policy)
    assert_scheduler_matches(got, want, reqs)
    if preset == "serve_shared":
        assert got.prefix_hit_tokens > 0 and got.pages_shared > 0


@pytest.mark.parametrize("cache_dtype", ["", "f8"])
def test_paged_streams_equal_contiguous(weights, cache_dtype):
    """Inside the port: 4-token pages, one page per slot (page_size 0) and
    the kernel backend give one stream per request — fp8 pools too."""
    _, tp = weights
    reqs = make_requests(2)
    base = get_preset("serve_paged", serve__cache_dtype=cache_dtype)
    runs = [_port_run(base.replace(serve__page_size=ps,
                                   serve__max_pages=mp,
                                   serve__kernel_backend=kb), tp, reqs)
            for ps, mp, kb in ((4, 12, "ref"), (0, 0, "ref"),
                               (4, 12, "cuda"))]
    for rs in zip(*(r.requests for r in runs)):
        assert rs[0].tokens == rs[1].tokens == rs[2].tokens, rs[0].rid
    assert runs[0].pages_total == 12 and runs[1].pages_total == 4


def test_fp8_pool_matches_reference(weights):
    """An fp8 e4m3 KV pool quantizes identically on both sides."""
    jp, tp = weights
    reqs = make_requests(3)
    want = _jax_run(j_preset("serve_paged", serve__cache_dtype="f8"), jp,
                    reqs)
    got = _port_run(get_preset("serve_kernels", serve__cache_dtype="f8"), tp,
                    reqs)
    for a, b in zip(got.requests, want.requests):
        assert a.tokens == b.tokens, a.rid


def test_sampled_streams_independent_of_cobatching(weights):
    """temperature > 0: picks are keyed by (sample_seed, rid, k), so a
    request samples the same stream alone or co-batched (trap T2: the
    draws differ from jax.random, the invariance holds)."""
    _, tp = weights
    plan = get_preset("serve_paged", serve__temperature=0.8)
    reqs = make_requests(4)
    together = _port_run(plan, tp, reqs)
    for r in reqs[:3]:
        alone = _port_run(plan, tp, [r])
        assert alone.requests[0].tokens == together.requests[r[0]].tokens
    again = _port_run(plan, tp, reqs)
    assert [r.tokens for r in again.requests] == \
        [r.tokens for r in together.requests]


def test_cache_store_accounting_matches_reference():
    """The same alloc / free / share sequence leaves the port's CacheStore
    and the JAX one with the same block table and stats."""
    arch = get_preset("serve_tiny").arch
    jarch = j_preset("serve_tiny").arch
    ts = tcache.CacheStore(arch, tcache.make_layout(4, 16, page_size=4,
                                                    max_pages=10),
                           dtype=torch.float32)
    js = jcache.CacheStore(jarch, jcache.make_layout(4, 16, page_size=4,
                                                     max_pages=10),
                           dtype=jax.numpy.float32)
    for st in (ts, js):
        st.alloc(0, 9)
        st.alloc(2, 16)
        st.retain(st._owned[0][0])
        st.free(0)
        st.alloc(1, 5, shared=[st._owned[2][0]])
        st.copy_page(st._owned[2][1], st._owned[1][1])
    np.testing.assert_array_equal(ts._tab, js._tab)
    np.testing.assert_array_equal(ts.tree["block_tab"].numpy(),
                                  np.asarray(js.tree["block_tab"]))
    assert ts.stats() == js.stats()
    assert not ts.can_alloc(16 * 2) and ts.can_alloc(8)


def test_page_ops_match_reference():
    """The in-place page / row writes and the page view equal the JAX
    package's functional ones on the same data (live pages compared: the
    trash page takes dead rows' writes in any order)."""
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((2, 7, 4, 2, 8)).astype(np.float32)
    tab = np.array([[3, 0, -1], [5, 1, 2], [-1, -1, -1]], np.int32)
    kv = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    row = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    lens = np.array([6, 10, 3], np.int32)
    sel = np.array([True, True, False])
    pos = np.array([6, 11, 0], np.int32)
    jp = jcache.page_write_prompt(jax.numpy.asarray(pool), 1,
                                  jax.numpy.asarray(tab), kv, sel,
                                  jax.numpy.asarray(lens))
    jp = jcache.page_write_token(jp, 1, jax.numpy.asarray(tab),
                                 jax.numpy.asarray(pos), row, sel)
    tp = torch.from_numpy(pool.copy())
    ttab = torch.from_numpy(tab)
    tcache.page_write_prompt(tp, 1, ttab, torch.from_numpy(kv),
                             torch.from_numpy(sel), torch.from_numpy(lens))
    tcache.page_write_token(tp, 1, ttab, torch.from_numpy(pos),
                            torch.from_numpy(row), torch.from_numpy(sel))
    np.testing.assert_array_equal(tp[:, :6].numpy(), np.asarray(jp)[:, :6])
    jv, jg = jcache.page_view(jp, 1, jax.numpy.asarray(tab))
    tv, tg = tcache.page_view(tp, 1, ttab)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    live = np.asarray(jg) >= 0
    np.testing.assert_array_equal(tv.numpy()[live], np.asarray(jv)[live])
    group = rng.standard_normal((2, 3, 12, 2, 8)).astype(np.float32)
    jg = jcache.upd_kv_rows(jax.numpy.asarray(group), 1,
                            jax.numpy.asarray(pos), row, sel)
    jg = jcache.upd_kv(jg, 0, 4, row, True)
    tg = torch.from_numpy(group.copy())
    tcache.upd_kv_rows(tg, 1, torch.from_numpy(pos), torch.from_numpy(row),
                       torch.from_numpy(sel))
    tcache.upd_kv(tg, 0, 4, torch.from_numpy(row), True)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_cache_layouts_match_reference():
    """cache_struct / paged_struct give the JAX package's groups and shapes
    for every architecture (the layout knowledge later families reuse);
    their specs are held to JAX's in tests/test_torch_spmd_serve.py."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import reduced as j_reduced
    from repro_torch.configs import ARCHS, reduced
    for name in ARCHS:
        arch, jarch = reduced(ARCHS[name]), j_reduced(J_ARCHS[name])
        got, _ = tcache.cache_struct(arch, 2, 16)
        want, _ = jcache.cache_struct(jarch, 2, 16)
        assert jax.tree.map(lambda s: tuple(s.shape), want) == \
            {k: tuple(s[0]) if isinstance(s[1], torch.dtype)
             else tuple(tuple(x[0]) for x in s) for k, s in got.items()}
        lo = tcache.make_layout(2, 16, page_size=4)
        jlo = jcache.make_layout(2, 16, page_size=4)
        got, _ = tcache.paged_struct(arch, lo)
        want, _ = jcache.paged_struct(jarch, jlo)
        assert jax.tree.map(lambda s: tuple(s.shape), want) == \
            {k: tuple(s[0]) if isinstance(s[1], torch.dtype)
             else tuple(tuple(x[0]) for x in s) for k, s in got.items()}


def test_plan_validation():
    """The port's backends are ref / cuda; spmd serve Plans and replica
    fleets are checked as the JAX package checks them."""
    arch = get_preset("serve_tiny").arch
    for bad in ("interpret", "tpu"):
        with pytest.raises(ValueError, match="kernel_backend"):
            Plan(arch=arch, serve=ServeSpec(kernel_backend=bad))
    # a FaultPlan of slot faults is accepted; ReplicaDown needs a fleet of
    # Router replicas with a survivor
    plan = Plan(arch=arch, serve=ServeSpec(max_batch=2),
                faults=FaultPlan(events=(SlotFault(slot=1, step=2),)),
                fault_policy=FaultPolicy(slot_recovery="reprefill"))
    assert plan.faults.of_type(SlotFault) == [SlotFault(slot=1, step=2)]
    with pytest.raises(ValueError, match="survivor"):
        Plan(arch=arch, serve=ServeSpec(),
             faults=FaultPlan(events=(ReplicaDown(replica=0, step=1),)))
    with pytest.raises(TypeError, match="ReplicaSpec"):
        Plan(arch=arch, serve=ServeSpec(replicas=(object(),)))
    # spmd serve keeps one replica on the mesh (test_serve.py:79-81)
    spmd = dataclasses.replace(get_preset("serve_tiny").run, backend="spmd")
    assert Plan(arch=arch, serve=ServeSpec(), run=spmd).run.backend == "spmd"
    with pytest.raises(ValueError, match="data-parallel serve"):
        Plan(arch=arch, serve=ServeSpec(), run=spmd,
             partition=PartitionSpec(stages=2, tp=1, data=2, devices=4))
    with pytest.raises(ValueError, match="evict"):
        Plan(arch=arch, serve=ServeSpec(evict=True))
    # the full-width arch serves (its train-only microbatch rule is skipped)
    from repro_torch.configs import ARCHS
    Plan(arch=ARCHS["qwen3-0.6b"], serve=ServeSpec(max_batch=8))
    with pytest.raises(ValueError, match="describes serving"):
        Engine(get_preset("serve_tiny"), device="cpu").fit()


def test_serve_cli_on_cpu(capsys):
    """launch/serve.py: threads only, --device / --kernel-backend, and
    --reduced as a real on/off switch (the JAX CLI's flag cannot be
    turned off)."""
    from repro_torch.launch import serve as cli
    a = cli.build_parser().parse_args(["--no-reduced"])
    assert a.reduced is False and a.device == "cuda"
    assert cli.build_parser().parse_args([]).reduced is True
    cli.main(["--device", "cpu", "--kernel-backend", "cuda", "--requests",
              "3", "--batch", "2", "--prompt-len", "6", "--gen", "3",
              "--page-size", "4"])
    out = capsys.readouterr().out
    assert "requests=3" in out and "tokens=9" in out
    cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
              "--gen", "3"])
    assert "generated ids[0]" in capsys.readouterr().out
