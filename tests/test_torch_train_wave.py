"""One training wave of the port against the JAX package's: the delta
optimizers, the data stream, build_local_wave_step's deltas and
Engine.step()'s loss sequence, on the CPU in f32.

Tolerances: optimizer deltas on the same grads within 1e-6 relative;
SGD wave deltas within 5e-4 of the leaf's largest |delta|: the CE input
grads are rounded to bf16 on both sides (trap T4), and over a wave's 8
rows a few land on the neighbouring bf16 value (2^-8 relative) when the
two f32 sums differ in their last bit, which moves the matrices' grads by
up to ~1e-4 of their maximum. adamw's first step maps g to about sign(g)
(m̂ / (sqrt(v̂) + eps) = g / (|g| + eps)), so a grad near zero may land on
either side and its delta anywhere in [-lr, lr]: adamw deltas are compared
only where |g| exceeds ten times the grads' tolerance and 1e3 eps, within
1e-7 (lr 1e-3), and that mask must cover most of every matrix.
Engine.step() losses over 4 waves within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClusterSpec as JClusterSpec
from repro.api import Engine as JEngine
from repro.api import Plan as JPlan
from repro.api import RunSpec as JRunSpec
from repro.api import WSP as JWSP
from repro.api.presets import _tiny_arch as j_tiny_arch
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.core.wave import build_local_wave_step as j_wave_step
from repro.core.wave import tick_schedule as j_tick_schedule
from repro.data.pipeline import MarkovLM as JMarkovLM
from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.models import lm as jlm
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch.api import ClusterSpec, Engine, Plan, RunSpec, WSP
from repro_torch.api.presets import _tiny_arch
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import tree as tree_lib
from repro_torch.core.wave import build_local_wave_step, tick_schedule
from repro_torch.core.wave import wave_grads
from repro_torch.data.pipeline import MarkovLM, ShardedLoader
from repro_torch.models import lm as tlm
from repro_torch.optim import make_optimizer, warmup_cosine

GRAD_RTOL = 1e-4
WAVE_RTOL = 5e-4
ADAM_LR = 1e-3
ADAM_EPS = 1e-8


def _archs():
    return {"tiny": (_tiny_arch(), j_tiny_arch()),
            "qwen3_reduced": (reduced(ARCHS["qwen3-0.6b"]),
                              j_reduced(J_ARCHS["qwen3-0.6b"]))}


def _params(jarch, seed=0):
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    return jp, tlm.params_from_numpy(jax.device_get(jp), device="cpu")


def _batch(vocab, B=8, S=32):
    return ShardedLoader(MarkovLM(vocab, seed=0), B, S, 0, 1, seed=17).next()


# -- optimizers --------------------------------------------------------------

def test_optimizers_basic():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 2.0)}
    for name, expect in (("sgd", -0.2), ("momentum", -0.2)):
        opt = make_optimizer(name, 0.1)
        st = opt.init(params)
        d, st = opt.update(grads, st, params)
        np.testing.assert_allclose(d["w"].numpy(), expect, rtol=1e-6)
        assert st["step"] == 1
    opt = make_optimizer("adamw", 0.1, weight_decay=0.0)
    st = opt.init(params)
    d, st = opt.update(grads, st, params)
    np.testing.assert_allclose(d["w"].numpy(), -0.1, rtol=1e-4)
    with pytest.raises(ValueError):
        make_optimizer("lion", 0.1)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizer_deltas_match_jax_over_three_steps(name):
    """The same grads through both packages' optimizers, three updates (the
    moments and the bias corrections carry), with a warmup-cosine rate."""
    rng = np.random.default_rng(5)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jopt = j_make_optimizer(name, j_warmup_cosine(0.1, 2, 10))
    topt = make_optimizer(name, warmup_cosine(0.1, 2, 10))
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_lib.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = tree_lib.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), p)
        jd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        td, ts = topt.update(tree_lib.tree_map(torch.from_numpy, g), ts, tp)
        for (path, a), (_, b) in zip(
                tree_lib.flatten_with_path(jax.device_get(jd)),
                tree_lib.flatten_with_path(td)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-8,
                                       err_msg=path)
    assert ts["step"] == int(js["step"]) == 3


def test_warmup_cosine_matches_jax():
    jl, tl = j_warmup_cosine(3e-4, 10, 100), warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(tl(step), float(jl(jnp.int32(step))),
                                   rtol=1e-6)


# -- data ------------------------------------------------------------------

@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2), (3, 4)])
def test_loader_batches_identical_to_jax(shard, num_shards):
    """The numpy copy draws the JAX package's batches, bit for bit."""
    a = ShardedLoader(MarkovLM(256, seed=3), 4, 16, shard, num_shards,
                      seed=17)
    b = JShardedLoader(JMarkovLM(256, seed=3), 4, 16, shard, num_shards,
                       seed=17)
    for _ in range(3):
        (xa, ya), (xb, yb) = a.next(), b.next()
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_loader_deterministic_resumable_and_disjoint():
    src = MarkovLM(256, seed=3)
    a = ShardedLoader(src, 4, 16, 0, 2, seed=5)
    a.next()
    sd = a.state_dict()
    x2, _ = a.next()
    c = ShardedLoader(src, 4, 16, 0, 2, seed=5)
    c.load_state_dict(sd)
    np.testing.assert_array_equal(x2, c.next()[0])
    other = ShardedLoader(src, 4, 16, 1, 2, seed=5)
    assert not np.array_equal(x2, other.next()[0])
    assert x2.max() < src.v


def test_tick_schedule_matches_jax():
    for stages, nm, overlap in ((1, 2, False), (2, 4, False), (4, 3, True)):
        assert tick_schedule(stages, nm, overlap=overlap) == \
            j_tick_schedule(stages, nm, overlap=overlap)


# -- one wave ------------------------------------------------------------------

_JAX_GRADS = {}


def _jax_wave_grads(name):
    """(mean loss, grads) of the JAX package's wave step on the test batch:
    build_local_wave_step with sgd(-1) returns the grads themselves as its
    deltas (-(-1) g is exact), one jit compile per arch for every test."""
    if name not in _JAX_GRADS:
        _, jarch = _archs()[name]
        jp, _ = _params(jarch)
        x, y = _batch(jarch.vocab_size)
        opt = j_make_optimizer("sgd", -1.0)
        g, _, loss = j_wave_step(jarch, jarch.num_microbatches, opt)(
            jp, opt.init(jp), x, y)
        _JAX_GRADS[name] = (float(loss), g)
    return _JAX_GRADS[name]


@pytest.mark.parametrize("name", ["tiny", "qwen3_reduced"])
def test_sgd_wave_deltas_match_jax(name):
    """One wave (Nm 2 microbatches of 4 rows) with SGD: loss and every
    leaf's delta."""
    arch, jarch = _archs()[name]
    jp, tp = _params(jarch)
    x, y = _batch(jarch.vocab_size)
    jl, jg = _jax_wave_grads(name)
    jopt, topt = j_make_optimizer("sgd", 0.3), make_optimizer("sgd", 0.3)
    jd, _ = jopt.update(jg, jopt.init(jp), jp)
    td, ts, tl = build_local_wave_step(arch, arch.num_microbatches, topt)(
        tp, topt.init(tp), x, y)
    assert abs(jl - float(tl)) <= 1e-5
    assert ts["step"] == 1
    for (path, a), (_, b) in zip(
            tree_lib.flatten_with_path(jax.device_get(jd)),
            tree_lib.flatten_with_path(td)):
        a = np.asarray(a)
        tol = WAVE_RTOL * float(np.abs(a).max()) + 1e-9
        assert float(np.abs(a - b.numpy()).max()) <= tol, path


@pytest.mark.parametrize("name", ["tiny", "qwen3_reduced"])
def test_adamw_wave_deltas_match_jax_where_grads_are_resolved(name):
    arch, jarch = _archs()[name]
    jp, tp = _params(jarch)
    x, y = _batch(jarch.vocab_size)
    nm = arch.num_microbatches
    _, jg = _jax_wave_grads(name)
    jopt = j_make_optimizer("adamw", ADAM_LR)
    topt = make_optimizer("adamw", ADAM_LR)
    jd, _ = jopt.update(jg, jopt.init(jp), jp)
    td, _, _ = build_local_wave_step(arch, nm, topt)(tp, topt.init(tp), x, y)
    _, tg = wave_grads(arch, nm, tp, torch.from_numpy(x),
                       torch.from_numpy(y))
    host_p = dict(tree_lib.flatten_with_path(jax.device_get(jp)))
    for (path, g), (_, gt), (_, a), (_, b) in zip(
            tree_lib.flatten_with_path(jax.device_get(jg)),
            tree_lib.flatten_with_path(tg),
            tree_lib.flatten_with_path(jax.device_get(jd)),
            tree_lib.flatten_with_path(td)):
        g, a, b = np.asarray(g), np.asarray(a), b.numpy()
        grad_tol = WAVE_RTOL * float(np.abs(g).max()) + 1e-8
        assert float(np.abs(g - gt.numpy()).max()) <= grad_tol, path
        # resolved: far from sign flips, and far enough above eps that a
        # grad error of grad_tol moves g / (|g| + eps) by < 1e-4
        resolved = (np.abs(g) > 10 * grad_tol) & (np.abs(g) > 1e3 * ADAM_EPS)
        if g.ndim >= 2:           # the matrices: the mask is not vacuous
            assert resolved.mean() > 0.5, (path, resolved.mean())
        np.testing.assert_allclose(b[resolved], a[resolved], atol=1e-7,
                                   rtol=0, err_msg=path)
        # elsewhere the port stays inside adamw's first-step range
        bound = ADAM_LR * (1 + 0.1 * np.abs(host_p[path])) + 1e-9
        assert np.all(np.abs(b) <= bound), path


def test_engine_step_loss_sequence_matches_jax():
    """Engine.step() x 4 (one VW, D 0, adamw 1e-3) on injected identical
    params: the parameter server, the WSP clock and the pulls carry the
    deltas from wave to wave on both sides."""
    arch, jarch = _archs()["tiny"]
    jp, tp = _params(jarch)
    jopt = j_make_optimizer("adamw", ADAM_LR)
    topt = make_optimizer("adamw", ADAM_LR)
    kw = dict(max_waves=4, batch=8, seq=32, vocab=arch.vocab_size,
              optimizer="adamw", lr=ADAM_LR)
    jeng = JEngine(JPlan(cluster=JClusterSpec(num_vw=1), sync=JWSP(D=0),
                         run=JRunSpec(**kw)),
                   params=jp, optimizer=jopt,
                   wave_step=j_wave_step(jarch, 2, jopt))
    teng = Engine(Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=0),
                       run=RunSpec(**kw)),
                  params=tp, optimizer=topt,
                  wave_step=build_local_wave_step(arch, 2, topt),
                  device="cpu")
    jl = [jeng.step() for _ in range(4)]
    tl = [teng.step() for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert jl[-1] < jl[0]
    assert teng.ps.clock.state.clocks == {"vw0": 4}
    assert set(teng.step_times) == {"wave_s", "d2h_s", "push_s", "pull_s",
                                    "h2d_s"}
