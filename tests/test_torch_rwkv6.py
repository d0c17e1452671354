"""The port's RWKV6 family against the JAX package's, on the CPU in f32.

The plain WKV6 recurrence (the Hopper kernel's plain version) is held
against the Pallas rwkv6_chunked kernel in interpret mode within 5e-4, the
tolerance of tests/test_kernels.py (chunked and sequential sums differ in
order; the chunk's exp(-cumsum) scaling costs a few more ulps). The model,
the Engine and the Scheduler on reduced(rwkv6-3b) run the JAX package's
own init carried across with params_from_numpy, with the block matrices
scaled up (so the layers, not the embedding, decide the logits) and the
decay LoRA (wa, wb), the token-shift mixes (mu_*) and the u-bonus drawn
from a seed: the JAX init's wa = wb = 0 makes the decay one constant and
would leave the data-dependent decay and its clip unchecked. Logits agree
to 1e-4; greedy streams and the Scheduler's counters are identical, with
no page pool (the family keeps fixed-size per-slot state only).
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
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_chunked as j_rwkv6_chunked
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import cache as jcache
from repro_torch.api import Engine, Plan, ServeSpec
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import cache as tcache
from test_torch_serve import assert_scheduler_matches, make_requests

KERNEL_TOL = dict(atol=5e-4, rtol=5e-4)
LOGIT_TOL = 1e-4
WEIGHT_SCALE = 20.0
MATS = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")
PROMPT, GEN = 8, 6


def _archs():
    return reduced(ARCHS["rwkv6-3b"]), j_reduced(J_ARCHS["rwkv6-3b"])


def carried_params(jarch, seed=0):
    """The JAX init with the block matrices scaled, nonzero wa/wb and drawn
    mu_* / u, as (jax tree, port tree, host numpy tree)."""
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    rng = np.random.default_rng(seed)
    blocks = {}
    for name, a in host["blocks"].items():
        a = np.asarray(a, np.float32)
        if name in MATS:
            a = a * WEIGHT_SCALE
        elif name in ("wa", "wb"):
            a = 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        elif name.startswith(("mu_", "cm_mu_")) or name == "u":
            a = rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        blocks[name] = a
    host["blocks"] = blocks
    return (jax.tree.map(jnp.asarray, host),
            tlm.params_from_numpy(host, device="cpu"), host)


@pytest.fixture(scope="module")
def weights():
    return carried_params(_archs()[1])


def _wkv_inputs(B, H, S, hd, seed=0):
    """r, k, v (0.5 N(0,1)), w = -exp(clip(N(0,1), -8, 1.386)) in [-4, 0)
    and u = 0.3 + 0.1 N(0,1), as numpy f32 (tests/test_kernels.py's mix)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, H, S, hd)) for _ in range(3))
    w = -np.exp(np.clip(rng.standard_normal((B, H, S, hd)), -8.0, 1.386))
    u = 0.3 + 0.1 * rng.standard_normal((H, hd))
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u)]


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,S,hd", [(1, 2, 64, 16), (2, 3, 96, 32),
                                      (2, 2, 13, 16)])
@pytest.mark.parametrize("chunk", [8, 16])
def test_rwkv6_ref_matches_pallas(B, H, S, hd, chunk):
    """The port's sequential rwkv6_ref against the Pallas rwkv6_chunked in
    interpret mode: y and the final state (S 13 is prime: Pallas runs
    chunks of 1 there, the Hopper kernel a masked tail)."""
    arrs = _wkv_inputs(B, H, S, hd, seed=S + chunk)
    y_j, st_j = j_rwkv6_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                interpret=True)
    y_t, st_t = tref.rwkv6_ref(*map(torch.from_numpy, arrs))
    assert y_t.dtype == torch.float32 and st_t.shape == (B, H, hd, hd)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **KERNEL_TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **KERNEL_TOL)
    # and the JAX package's own sequential oracle, tighter
    y_r, st_r = jref.rwkv6_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_r), atol=1e-5,
                               rtol=1e-5)


def test_ops_rwkv6_cuda_backend_on_cpu_is_the_plain_version():
    """On CPU tensors ops.rwkv6(backend="cuda") runs the plain version —
    strided [B, S, H, hd] views included — and counts no launch."""
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(2, 3, 21, 16))
    views = [a.transpose(1, 2).contiguous().transpose(1, 2)
             for a in (r, k, v, w)]
    before = dict(LAUNCHES)
    want = tref.rwkv6_ref(r, k, v, w, u)
    for got in (ops.rwkv6(*views, u, backend="cuda"),
                ops.rwkv6(r, k, v, w, u, backend="ref"),
                rwkv6_chunked(*views, u)):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="kernel backend"):
        ops.rwkv6(r, k, v, w, u, backend="interpret")
    with pytest.raises(ValueError, match=r"\[H,hd\]"):
        rwkv6_chunked(r, k, v, w, u[:, :8])


# ---------------------------------------------------------------------------
# the time-mix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("with_lens", [False, True])
def test_rwkv6_mix_and_step_match_reference(weights, kernel_backend,
                                            with_lens):
    """rwkv6_mix (right-padded rows through lens) then two rwkv6_mix_step
    tokens: outputs, states and token-shift carries equal JAX's."""
    arch, _ = _archs()
    _, _, host = weights
    p_np = {k: v[1] for k, v in host["blocks"].items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.tensor(v) for k, v in p_np.items()}
    H = arch.n_ssm_heads
    rng = np.random.default_rng(7)
    xx = rng.standard_normal((3, 12, arch.d_model)).astype(np.float32)
    lens = np.array([12, 5, 1], np.int32) if with_lens else None
    jy, jst, jlast = jssm.rwkv6_mix(
        jp, jnp.asarray(xx), heads=H,
        lens=None if lens is None else jnp.asarray(lens))
    ty, tst, tlast = tssm.rwkv6_mix(
        tp, torch.from_numpy(xx), heads=H,
        lens=None if lens is None else torch.from_numpy(lens),
        kernel_backend=kernel_backend)
    live = slice(None) if lens is None else \
        np.arange(12)[None] < lens[:, None]
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    for _ in range(2):
        x1 = rng.standard_normal((3, 1, arch.d_model)).astype(np.float32)
        jy, jst, jlast = jssm.rwkv6_mix_step(jp, jnp.asarray(x1), jst,
                                             jlast, heads=H)
        ty, tst, tlast = tssm.rwkv6_mix_step(tp, torch.from_numpy(x1), tst,
                                             tlast, heads=H)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-4,
                                   rtol=1e-5)
    # the drawn LoRA makes the decay vary per token and channel
    _, _, _, _, logw = tssm.rwkv6_projections(tp, torch.from_numpy(xx),
                                              None, H)
    assert float(logw.std()) > 0.1 and float(logw.min()) >= -4.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_params_layout_matches_reference():
    arch, jarch = _archs()
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(0))
    tp = tlm.init_params(arch, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=torch.is_tensor) == shapes
    # the deterministic inits equal the JAX package's leaf for leaf
    for name in ("ln1", "mu_r", "w0", "wa", "wb", "u", "gn_scale",
                 "cm_mu_k"):
        np.testing.assert_array_equal(tp["blocks"][name].numpy(),
                                      np.asarray(jp["blocks"][name]))


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_forward_prefill_decode_logits_match_reference(weights,
                                                       kernel_backend):
    """forward_ref prefill of right-padded rows, then three decode positions
    over the contiguous cache: logits, the WKV state and both token shifts
    match the JAX forward_ref."""
    arch, jarch = _archs()
    jp, tp, _ = weights
    B, S, steps = 3, 10, 3
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([10, 7, 1], np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    pre = jax.jit(lambda p, x, c, n: jlm.forward_ref(
        jarch, p, x, mode="prefill", cache=c, lens=n)[:2])
    dec = jax.jit(lambda p, x, c, n: jlm.forward_ref(
        jarch, p, x, mode="decode", cache=c, pos=n)[:2])
    jh, jc = pre(jp, jnp.asarray(prompts), jc, jnp.asarray(lens))
    th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                             mode="prefill", cache=tc,
                             lens=torch.from_numpy(lens),
                             kernel_backend=kernel_backend)
    live = np.arange(S)[None] < lens[:, None]
    jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
    np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy()[live],
                               jl[live], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert np.std(jl[live]) > 0.1         # the layers, not a constant, decide
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
    for key in ("ssm_state", "shift"):
        want = np.asarray(jc[key])
        np.testing.assert_allclose(tc[key].numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve(**over):
    return dict(dict(prompt_len=PROMPT, gen=GEN, max_batch=4), **over)


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_generate_matches_reference(weights, kernel_backend):
    """Engine.generate over the contiguous cache: the port's stream is the
    JAX package's, token for token."""
    arch, jarch = _archs()
    jp, tp, _ = weights
    prompts = np.random.default_rng(0).integers(0, 256, (4, PROMPT)).astype(
        np.int32)
    want = JEngine(JPlan(arch=jarch, serve=JServeSpec(**_serve())),
                   params=jp).generate(prompts)
    got = Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend))), params=tp,
        device="cpu").generate(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.decode_steps == want.decode_steps == GEN - 1
    assert len(np.unique(want.tokens)) > 6


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("policy,knobs", [
    ("fifo", {}), ("deadline", {}),
    ("fifo", dict(page_size=4, share_prefix=True, evict=True,
                  preempt=True))])
def test_scheduler_matches_reference(weights, kernel_backend, policy, knobs):
    """Scheduler.run over a CacheStore with no page pool (the family keeps
    per-slot state only): per-request streams and every counter equal the
    JAX package's, with pages_total 0, no prefix hits and nothing blocked,
    whatever the memory knobs say."""
    arch, jarch = _archs()
    jp, tp, _ = weights
    reqs = make_requests(1, prompt=PROMPT, gen=GEN,
                         shared=bool(knobs.get("share_prefix")))
    deadline = (lambda i: 3 * (8 - i)) if policy == "deadline" else \
        (lambda i: 0)
    want = JScheduler(JEngine(JPlan(arch=jarch, serve=JServeSpec(
        **_serve(**knobs))), params=jp), policy=policy).run(
        [JRequest(i, p.copy(), n, deadline(i)) for i, p, n in reqs])
    got = Scheduler(Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend, **knobs))), params=tp,
        device="cpu"), policy=policy).run(
        [Request(i, p.copy(), n, deadline(i)) for i, p, n in reqs])
    assert_scheduler_matches(got, want, reqs)
    assert got.pages_total == 0 and got.prefix_hit_tokens == 0
    assert got.admit_blocked == 0
    assert len({t for r in got.requests for t in r.tokens}) > 6


def test_cache_store_without_pool():
    """The pool-free CacheStore: per-slot ssm_state / shift leaves only,
    admission never blocks, shared pages are refused, the stats are the
    JAX package's."""
    arch, jarch = _archs()
    lo = tcache.make_layout(4, 14, page_size=4)
    ts = tcache.CacheStore(arch, lo, dtype=torch.float32)
    js = jcache.CacheStore(jarch, jcache.make_layout(4, 14, page_size=4),
                           dtype=jnp.float32)
    assert sorted(ts.tree) == ["block_tab", "shift", "ssm_state"]
    assert tuple(ts.tree["ssm_state"].shape) == (4, 4, 2, 32, 32)
    for st in (ts, js):
        assert st.pages_total == 0 and st.can_alloc(10 ** 6)
        st.alloc(0, 14)
        st.alloc(3, 2)
        st.free(0)
        with pytest.raises(ValueError, match="per-slot only"):
            st.alloc(1, 8, shared=[0])
    assert ts.stats() == js.stats()


def test_serve_cli_rwkv6_on_cpu(capsys):
    """launch/serve.py serves the reduced rwkv6-3b on the CPU, through the
    Scheduler and through generate()."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "rwkv6-3b", "--device", "cpu", "--kernel-backend",
              "cuda", "--requests", "3", "--batch", "2", "--prompt-len", "6",
              "--gen", "3", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b" in out and "tokens=9" in out
    assert "pages=0/0" in out
    cli.main(["--arch", "rwkv6-3b", "--device", "cpu", "--batch", "2",
              "--prompt-len", "6", "--gen", "3"])
    assert "generated ids[0]" in capsys.readouterr().out
