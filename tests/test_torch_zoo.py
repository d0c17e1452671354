"""The rest of the model zoo against the JAX package, on the CPU in f32:
gemma3-1b (5 windowed layers : 1 global, sandwich norms, GeGLU, embedding
scaling, two rope thetas), minitron-8b (dense, squared-ReLU MLP) and the
stub-frontend archs (chameleon-34b, musicgen-medium: inputs are
[B, S, d_model] embeddings).

Weights are the JAX init with the block matrices scaled up, carried with
`lm.params_from_numpy`; token ids and embeddings are drawn with numpy from a
seed (trap T2: jax.random draws cannot be reproduced, so embeddings cross as
numpy). Logits agree within LOGIT_TOL; greedy streams, every Scheduler
counter and CacheStore.stats() are identical, and each greedy pick's top-2
margin exceeds the tolerance (trap T3). gemma3 runs at 6 layers: the reduced
config's 4 are all windowed and never reach the global layer (trap G1).
"""
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
from repro_torch.models import lm as tlm
from repro_torch.serve import cache as tcache
from test_torch_model import _jitted, carried_params
from test_torch_serve import assert_scheduler_matches, make_requests

LOGIT_TOL = 1e-4
PROMPT, GEN = 40, 6           # gemma3's prompts run past its window of 32
KNOBS = dict(page_size=4, share_prefix=True, evict=True, preempt=True)
# gemma3: 6 layers reach the global layer (trap G1)
ZOO = {"gemma3-1b": dict(num_layers=6), "minitron-8b": {}}
STUBS = ("chameleon-34b", "musicgen-medium")


def _pair(name):
    kw = ZOO.get(name, {})
    return reduced(ARCHS[name], **kw), j_reduced(J_ARCHS[name], **kw)


_WEIGHTS: dict = {}


def _weights(name):
    if name not in _WEIGHTS:
        _WEIGHTS[name] = carried_params(_pair(name)[1])
    return _WEIGHTS[name]


class MarginScheduler(Scheduler):
    """Records each greedy pick's top-2 logit margin."""

    def __init__(self, engine, **kw):
        super().__init__(engine, **kw)
        self.margins = []

    def _pick_one(self, row, rid, k):
        top = np.partition(np.asarray(row), -2)[-2:]
        self.margins.append(float(top[1] - top[0]))
        return super()._pick_one(row, rid, k)


def test_gemma3_reaches_its_global_layer():
    """Trap G1: reduced gemma3 has 4 windowed layers; at 6 the sixth is
    global, with its own rope theta and the paged kv_full group."""
    arch, jarch = _pair("gemma3-1b")
    assert list(arch.layer_kinds()[:arch.num_layers]) == [1, 1, 1, 1, 1, 0]
    assert list(reduced(ARCHS["gemma3-1b"]).layer_kinds()) == [1, 1, 1, 1]
    assert list(jarch.layer_kinds()[:6]) == [1, 1, 1, 1, 1, 0]
    tree = tcache.CacheStore(arch, tcache.make_layout(4, 46, page_size=4),
                             dtype=torch.float32).tree
    assert sorted(tree) == ["block_tab", "kv_full", "kv_win"]


@pytest.mark.parametrize("name", list(ZOO))
def test_forward_prefill_decode_logits_match_reference(name):
    """forward_ref prefill of right-padded rows (past gemma3's window), then
    four decode positions over the contiguous cache: logits within
    LOGIT_TOL of the JAX forward_ref, top-2 margins above it."""
    arch, jarch = _pair(name)
    jp, tp = _weights(name)
    B, S, steps = 3, 45, 4
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([45, 33, 4], np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    pre, dec = _jitted(jarch)
    jh, jc = pre(jp, jnp.asarray(prompts), jc, jnp.asarray(lens))
    th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                             mode="prefill", cache=tc,
                             lens=torch.from_numpy(lens))
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
                                 pos=torch.from_numpy(pos))
        jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
        np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy(), jl,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        top = np.sort(jl[:, -1], axis=-1)[:, -2:]
        assert (top[:, 1] - top[:, 0]).min() > LOGIT_TOL
        tok = jl[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1


def _serve(**over):
    return dict(dict(prompt_len=PROMPT, gen=GEN, max_batch=4), **over)


_JAX_RUNS: dict = {}


@pytest.mark.parametrize("name", list(ZOO))
@pytest.mark.parametrize("knobs", [{}, KNOBS], ids=["fifo", "memory_knobs"])
def test_scheduler_matches_reference(name, knobs):
    """Scheduler.run under fifo, and under 4-token pages with share_prefix,
    evict and preempt: every stream and counter equal to the JAX
    package's, the CacheStore's stats too, each pick's top-2 margin above
    the tolerance."""
    arch, jarch = _pair(name)
    jp, tp = _weights(name)
    reqs = make_requests(3, lo=20, prompt=PROMPT, gen=GEN,
                         shared=bool(knobs))
    key = (name, tuple(sorted(knobs)))
    if key not in _JAX_RUNS:
        je = JEngine(JPlan(arch=jarch, serve=JServeSpec(**_serve(**knobs))),
                     params=jp)
        want = JScheduler(je).run(
            [JRequest(i, p.copy(), n) for i, p, n in reqs])
        _JAX_RUNS[key] = want, je.serve_store().stats()
    want, jstats = _JAX_RUNS[key]
    eng = Engine(Plan(arch=arch, serve=ServeSpec(**_serve(**knobs))),
                 params=tp, device="cpu")
    sched = MarginScheduler(eng)
    got = sched.run([Request(i, p.copy(), n) for i, p, n in reqs])
    assert_scheduler_matches(got, want, reqs)
    assert eng.serve_store().stats() == jstats
    assert min(sched.margins) > LOGIT_TOL
    assert len({t for r in got.requests for t in r.tokens}) > 6
    if knobs:
        assert got.pages_total > 0


@pytest.mark.parametrize("name", STUBS)
def test_stub_frontend_logits_match_reference(name):
    """Engine.prefill / decode with [B, S, d_model] embeddings passed
    across as numpy: the last-position logits within LOGIT_TOL for the
    prompt and three decode steps."""
    arch, jarch = _pair(name)
    jp, tp = carried_params(jarch)
    sv = dict(prompt_len=8, gen=4, max_batch=2)
    je = JEngine(JPlan(arch=jarch, serve=JServeSpec(**sv)), params=jp)
    te = Engine(Plan(arch=arch, serve=ServeSpec(**sv)), params=tp,
                device="cpu")
    rng = np.random.default_rng(4)
    emb = (0.5 * rng.standard_normal((2, 8, arch.d_model))).astype(
        np.float32)
    jl, jc = je.prefill(emb)
    tl, tc = te.prefill(emb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert np.std(np.asarray(jl)) > 0.05
    for t in range(3):
        step = (0.5 * rng.standard_normal((2, 1, arch.d_model))).astype(
            np.float32)
        jl, jc = je.decode(step, jc, 8 + t)
        tl, tc = te.decode(step, tc, 8 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("name", STUBS)
def test_stub_frontend_scheduler_refuses_and_generate_runs(name):
    """The Scheduler refuses a stub-frontend arch with the JAX package's
    message; Engine.generate runs it (prompts and each decode step's input
    are stub embeddings), on both backends."""
    arch, jarch = _pair(name)
    sv = dict(prompt_len=6, gen=3, max_batch=2)
    with pytest.raises(ValueError) as jerr:
        JScheduler(JEngine(JPlan(arch=jarch, serve=JServeSpec(**sv))))
    with pytest.raises(ValueError) as terr:
        Scheduler(Engine(Plan(arch=arch, serve=ServeSpec(**sv)),
                         device="cpu"))
    assert str(terr.value) == str(jerr.value)
    for kb in ("ref", "cuda"):
        rep = Engine(Plan(arch=arch, serve=ServeSpec(kernel_backend=kb,
                                                     **sv)),
                     device="cpu").generate()
        assert rep.tokens.shape == (2, 3)
        assert ((rep.tokens >= 0) & (rep.tokens < arch.vocab_size)).all()


def test_stub_embeddings_are_seeded_on_the_generator_device():
    """frontend.stub_embeddings / stub_labels draw from the generator they
    are handed: same seed, same draw; shapes and ranges as JAX's."""
    from repro_torch.models import frontend
    arch = reduced(ARCHS["musicgen-medium"])
    a = frontend.stub_embeddings(arch, torch.Generator().manual_seed(1), 2,
                                 5)
    b = frontend.stub_embeddings(arch, torch.Generator().manual_seed(1), 2,
                                 5)
    assert a.shape == (2, 5, arch.d_model) and torch.equal(a, b)
    assert 0.005 < float(a.std()) < 0.05          # 0.02 N(0, 1), as JAX's
    lab = frontend.stub_labels(arch, torch.Generator().manual_seed(2), 3, 4)
    assert lab.dtype == torch.int32 and lab.shape == (3, 4)
    assert int(lab.min()) >= 0 and int(lab.max()) < arch.vocab_size
