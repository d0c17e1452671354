"""The port's sliding-window family (h2o-danube) against the JAX package's,
on the CPU in f32.

h2o-danube is windowed in every layer: prefill runs banded attention (or its
masked flash_attention fallback when the band covers the prompt) and writes
each layer's kv_win ring, decode writes and reads the ring; there is no
full-attention K/V, so no page pool, and no kernel runs under either
kernel_backend (as in the JAX package). Weights are the JAX init with the
block matrices scaled up, carried with params_from_numpy. Prompts run
longer than the reduced window of 32, so the ring wraps in prefill and in
decode. Logits agree to 1e-4; greedy streams and the Scheduler's counters
are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import Plan as JPlan
from repro.api import ServeSpec as JServeSpec
from repro.api.serving import Request as JRequest
from repro.api.serving import Scheduler as JScheduler
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm
from repro.serve import cache as jcache
from repro_torch.api import Engine, Plan, ServeSpec
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import lm as tlm
from repro_torch.serve import cache as tcache
from test_torch_model import _jitted, carried_params
from test_torch_serve import assert_scheduler_matches, make_requests

LOGIT_TOL = 1e-4
PROMPT, GEN = 40, 6           # prompts past the reduced window of 32
KNOBS = dict(page_size=4, share_prefix=True, evict=True, preempt=True)


def _archs():
    return (reduced(ARCHS["h2o-danube-1.8b"]),
            j_reduced(J_ARCHS["h2o-danube-1.8b"]))


@pytest.fixture(scope="module")
def weights():
    return carried_params(_archs()[1])


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_forward_prefill_decode_logits_match_reference(weights,
                                                       kernel_backend):
    """forward_ref prefill of right-padded rows longer than the window, then
    four decode positions over the contiguous cache (the ring wraps in
    both): logits and every ring slot match the JAX forward_ref, and no
    kernel launches."""
    arch, jarch = _archs()
    jp, tp = weights
    B, S, steps = 3, 45, 4
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([45, 33, 4], np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    assert sorted(tc) == ["kv_win"]
    assert tc["kv_win"][0].shape[2] == arch.window_size < S
    pre, dec = _jitted(jarch)
    reset_launches()
    jh, jc = pre(jp, jnp.asarray(prompts), jc, jnp.asarray(lens))
    th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                             mode="prefill", cache=tc,
                             lens=torch.from_numpy(lens),
                             kernel_backend=kernel_backend)
    live = np.arange(S)[None] < lens[:, None]
    jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
    np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy()[live],
                               jl[live], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert np.std(jl[live]) > 0.1
    tok = jl[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    pos = lens.copy()
    for _ in range(steps):
        jh, jc = dec(jp, jnp.asarray(tok[:, None]), jc, jnp.asarray(pos))
        th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(tok[:, None]),
                                 mode="decode", cache=tc,
                                 pos=torch.from_numpy(pos),
                                 kernel_backend=kernel_backend)
        jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
        np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy(), jl,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = jl[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1
    for want, got in zip(jc["kv_win"], tc["kv_win"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    assert all(n == 0 for n in LAUNCHES.values())


def _serve(**over):
    return dict(dict(prompt_len=PROMPT, gen=GEN, max_batch=4), **over)


def _requests(shared):
    return make_requests(3, lo=20, prompt=PROMPT, gen=GEN, shared=shared)


_JAX_RUNS: dict = {}


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_generate_matches_reference(weights, kernel_backend):
    """Engine.generate, prompts past the window: the JAX package's stream."""
    arch, jarch = _archs()
    jp, tp = weights
    prompts = np.random.default_rng(0).integers(0, 256, (4, PROMPT)).astype(
        np.int32)
    if "generate" not in _JAX_RUNS:
        _JAX_RUNS["generate"] = JEngine(JPlan(arch=jarch, serve=JServeSpec(
            **_serve())), params=jp).generate(prompts)
    want = _JAX_RUNS["generate"]
    got = Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend))), params=tp,
        device="cpu").generate(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.decode_steps == want.decode_steps == GEN - 1
    assert len(np.unique(want.tokens)) > 6


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("knobs", [{}, KNOBS], ids=["fifo", "memory_knobs"])
def test_scheduler_matches_reference(weights, kernel_backend, knobs):
    """Scheduler.run over a CacheStore with no page pool (the rings are per
    slot): per-request streams and every counter equal the JAX package's,
    with pages_total 0 and the memory knobs inert."""
    arch, jarch = _archs()
    jp, tp = weights
    reqs = _requests(bool(knobs))
    key = tuple(sorted(knobs))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = JScheduler(JEngine(JPlan(arch=jarch, serve=JServeSpec(
            **_serve(**knobs))), params=jp)).run(
            [JRequest(i, p.copy(), n) for i, p, n in reqs])
    want = _JAX_RUNS[key]
    got = Scheduler(Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend, **knobs))), params=tp,
        device="cpu")).run([Request(i, p.copy(), n) for i, p, n in reqs])
    assert_scheduler_matches(got, want, reqs)
    assert got.pages_total == 0 and got.prefix_hit_tokens == 0
    assert len({t for r in got.requests for t in r.tokens}) > 6


def test_cache_store_rings_match_reference():
    """The pool-free CacheStore of an all-windowed family: kv_win rings of
    min(window, max_len) slots per layer group and slot, and stats() (ring
    bytes as slot state) equal to the JAX package's."""
    arch, jarch = _archs()
    ts = tcache.CacheStore(arch, tcache.make_layout(4, 46, page_size=4),
                           dtype=torch.float32)
    js = jcache.CacheStore(jarch, jcache.make_layout(4, 46, page_size=4),
                           dtype=jnp.float32)
    assert sorted(ts.tree) == ["block_tab", "kv_win"]
    assert [tuple(t.shape) for t in ts.tree["kv_win"]] == \
        [tuple(a.shape) for a in js.tree["kv_win"]] == [(4, 4, 32, 2, 16)] * 2
    for st in (ts, js):
        st.alloc(1, 46)
        st.free(1)
    assert ts.stats() == js.stats()


def test_serve_cli_danube_on_cpu(capsys):
    """launch/serve.py serves the reduced h2o-danube on the CPU."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "h2o-danube-1.8b", "--device", "cpu", "--requests",
              "3", "--batch", "2", "--prompt-len", "36", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=h2o-danube-1.8b" in out and "tokens=9" in out
    assert "pages=0/0" in out
