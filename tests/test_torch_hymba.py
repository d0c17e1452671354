"""The port's SSD hybrid family (hymba) against the JAX package's, on the
CPU in f32.

The plain SSD recurrence (the Hopper ssd_chunked kernel's plain version) is
held against the Pallas ssd_chunked kernel in interpret mode within 1e-4,
the tolerance of tests/test_kernels.py (chunked and sequential sums differ
in order), and against the JAX package's sequential oracle within 1e-5.
The model, the Engine and the Scheduler on reduced(hymba-1.5b) run the JAX
package's own init carried across with params_from_numpy, with the block
matrices scaled up (so the layers, not the embedding, decide the logits),
the dt columns of the SSD in_proj left at the init's scale and dt_bias
drawn in [-4, -1] (so the per-step decays exp(dt a) spread over (0, 1)
instead of underflowing to 0), and D, the SSD norm scale and the two
branch norms drawn away from their constant inits. Prompts run longer than
the reduced window of 32, so the kv_win ring wraps. Logits agree to 1e-4;
greedy streams and every Scheduler counter are identical.
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
from repro.kernels.mamba_ssd import ssd_chunked as j_ssd_chunked
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import cache as jcache
from repro_torch.api import Engine, Plan, ServeSpec
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mamba_ssd import ssd_chunked
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import cache as tcache
from test_torch_model import _jitted
from test_torch_serve import assert_scheduler_matches, make_requests

KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = 1e-4
WEIGHT_SCALE = 20.0
MATS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo", "ssd_conv_w",
        "ssd_out_proj")
PROMPT, GEN = 40, 6           # prompts past the reduced window of 32
KNOBS = dict(page_size=4, max_pages=20, share_prefix=True, evict=True,
             preempt=True)


def _archs():
    return reduced(ARCHS["hymba-1.5b"]), j_reduced(J_ARCHS["hymba-1.5b"])


def carried_params(jarch, seed=0):
    """The JAX init with the block matrices and the non-dt columns of the
    SSD in_proj scaled, dt_bias, D, the SSD norm scale and the branch norms
    drawn: (jax tree, port tree, host numpy tree)."""
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    rng = np.random.default_rng(seed)
    H = jarch.n_ssm_heads
    blocks = {}
    for name, a in host["blocks"].items():
        a = np.array(a, np.float32)
        if name in MATS:
            a = a * WEIGHT_SCALE
        elif name == "ssd_in_proj":
            a[..., :-H] *= WEIGHT_SCALE
        elif name == "ssd_dt_bias":
            a = rng.uniform(-4.0, -1.0, a.shape).astype(np.float32)
        elif name == "ssd_D":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif name in ("ssd_norm_scale", "bn_attn", "bn_ssm"):
            a = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        blocks[name] = a
    host["blocks"] = blocks
    return (jax.tree.map(jnp.asarray, host),
            tlm.params_from_numpy(host, device="cpu"), host)


@pytest.fixture(scope="module")
def weights():
    return carried_params(_archs()[1])


def _ssd_inputs(B, H, S, N, P, seed=0):
    """x, B, C (0.5 N(0,1)), dt = softplus(N(0,1)), a = -exp(linspace(0, 2,
    H)) as numpy f32 (tests/test_kernels.py's mix)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, H, S, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S))))
    Bm, Cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    a = -np.exp(np.linspace(0.0, 2.0, H))
    return [np.asarray(t, np.float32) for t in (x, dt, Bm, Cm, a)]


def _ssd_leaves(host, layer=1):
    """The ssd_* leaves of one layer, prefix stripped: (jax, port)."""
    p_np = {k[4:]: v[layer] for k, v in host["blocks"].items()
            if k.startswith("ssd_")}
    return ({k: jnp.asarray(v) for k, v in p_np.items()},
            {k: torch.tensor(v) for k, v in p_np.items()})


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,S,N,P", [(1, 2, 64, 8, 16), (2, 4, 128, 16, 32),
                                       (2, 3, 13, 8, 16)])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_ref_matches_pallas(B, H, S, N, P, chunk):
    """The port's sequential ssd_ref against the Pallas ssd_chunked in
    interpret mode: y and the final state (S 13 is prime: Pallas runs
    chunks of 1 there, the Hopper kernel a masked tail)."""
    arrs = _ssd_inputs(B, H, S, N, P, seed=S + chunk)
    y_j, st_j = j_ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                              interpret=True)
    y_t, st_t = tref.ssd_ref(*map(torch.from_numpy, arrs))
    assert y_t.dtype == torch.float32 and st_t.shape == (B, H, N, P)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **KERNEL_TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **KERNEL_TOL)
    # and the JAX package's own sequential oracle, tighter
    y_r, st_r = jref.ssd_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_r), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("S", [100, 13, 1])
def test_ssd_chunked_scan_matches_ref(S):
    """The plain chunked scan the "ref" serve path runs (chunks of the
    largest divisor of S up to 64) against the sequential recurrence."""
    x, dt, Bm, Cm, a = map(torch.from_numpy, _ssd_inputs(2, 3, S, 8, 16))
    y, st = tssm.ssd_chunked_scan(x.transpose(1, 2), dt.transpose(1, 2),
                                  Bm, Cm, a)
    y_r, st_r = tref.ssd_ref(x, dt, Bm, Cm, a)
    torch.testing.assert_close(y.transpose(1, 2), y_r, **KERNEL_TOL)
    torch.testing.assert_close(st, st_r, **KERNEL_TOL)


def test_ops_ssd_cuda_backend_on_cpu_is_the_plain_version():
    """On CPU tensors ops.ssd(backend="cuda") runs the plain version — the
    model's strided views included (x and B/C column slices of one conv
    output, dt a transposed [B, S, H] view) — and counts no launch."""
    B, H, S, N, P = 2, 3, 21, 8, 16
    x, dt, Bm, Cm, a = map(torch.from_numpy, _ssd_inputs(B, H, S, N, P))
    conv = torch.cat([x.transpose(1, 2).reshape(B, S, H * P), Bm, Cm], -1)
    xv = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    Bv, Cv = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dtv = dt.transpose(1, 2).contiguous().transpose(1, 2)
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    before = dict(LAUNCHES)
    want = tref.ssd_ref(x, dt, Bm, Cm, a)
    for got in (ops.ssd(xv, dtv, Bv, Cv, a, backend="cuda"),
                ops.ssd(x, dt, Bm, Cm, a, backend="ref"),
                ssd_chunked(xv, dtv, Bv, Cv, a)):
        for u, v in zip(got, want):
            torch.testing.assert_close(u, v, atol=0, rtol=0)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="kernel backend"):
        ops.ssd(x, dt, Bm, Cm, a, backend="interpret")
    with pytest.raises(ValueError, match=r"a \[H\]"):
        ssd_chunked(x, dt, Bm, Cm, a[:2])


# ---------------------------------------------------------------------------
# the mixes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("with_lens", [False, True])
def test_ssd_mix_and_step_match_reference(weights, kernel_backend,
                                          with_lens):
    """ssd_mix (right-padded rows through lens) then two ssd_mix_step
    tokens: outputs, final states and conv tails equal JAX's."""
    arch, _ = _archs()
    jp, tp = _ssd_leaves(weights[2])
    kw = dict(heads=arch.n_ssm_heads, d_state=arch.ssm_state,
              d_inner=arch.d_inner)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 70, arch.d_model)).astype(np.float32)
    lens = np.array([70, 37, 2], np.int32) if with_lens else None
    jy, jst, jtail = jssm.ssd_mix(
        jp, jnp.asarray(x), lens=None if lens is None else jnp.asarray(lens),
        **kw)
    ty, tst, ttail = tssm.ssd_mix(
        tp, torch.from_numpy(x),
        lens=None if lens is None else torch.from_numpy(lens),
        kernel_backend=kernel_backend, **kw)
    live = slice(None) if lens is None else \
        np.arange(70)[None] < lens[:, None]
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail), atol=1e-5,
                               rtol=1e-5)
    for _ in range(2):
        x1 = rng.standard_normal((3, 1, arch.d_model)).astype(np.float32)
        jy, jst, jtail = jssm.ssd_mix_step(jp, jnp.asarray(x1), jst, jtail,
                                           **kw)
        ty, tst, ttail = tssm.ssd_mix_step(tp, torch.from_numpy(x1), tst,
                                           ttail, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail),
                                   atol=1e-5, rtol=1e-5)
    # the drawn dt_bias spreads the per-step decays over (0, 1)
    *_, dt, _ = tssm.ssd_projections(tp, torch.from_numpy(x),
                                     arch.n_ssm_heads, arch.d_inner,
                                     arch.ssm_state)
    dec = torch.exp(dt * -torch.exp(tp["A_log"]))
    assert float(((dec > 0.01) & (dec < 0.99)).float().mean()) > 0.5


@pytest.mark.parametrize("S,window,q_block", [(96, 24, 16), (160, 40, 32)])
def test_banded_attention_matches_reference(S, window, q_block):
    """banded_attention at S > window + q_block, so the band is sliced
    (not the flash_attention fallback): JAX's output, and the masked full
    attention's."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    assert window + q_block < S
    want = jattn.banded_attention(*map(jnp.asarray, (q, k, v)),
                                  window=window, q_block=q_block)
    got = tattn.banded_attention(*map(torch.from_numpy, (q, k, v)),
                                 window=window, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    full = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 window=window)
    torch.testing.assert_close(got, full, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_params_layout_matches_reference():
    """The hybrid leaves (bn_attn, bn_ssm, ssd_*) beside the dense ones:
    names, [padded_layers, ...] shapes and the deterministic inits."""
    arch, jarch = _archs()
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(0))
    tp = tlm.init_params(arch, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=torch.is_tensor) == shapes
    assert {"bn_attn", "bn_ssm", "ssd_in_proj", "ssd_conv_w", "ssd_dt_bias",
            "ssd_A_log", "ssd_D", "ssd_norm_scale",
            "ssd_out_proj"} <= set(tp["blocks"])
    di, N, H = arch.d_inner, arch.ssm_state, arch.n_ssm_heads
    assert tuple(tp["blocks"]["ssd_in_proj"].shape) == \
        (4, arch.d_model, 2 * di + 2 * N + H)
    for name in ("ssd_dt_bias", "ssd_D", "ssd_norm_scale", "bn_attn",
                 "bn_ssm"):
        np.testing.assert_array_equal(tp["blocks"][name].numpy(),
                                      np.asarray(jp["blocks"][name]))
    np.testing.assert_allclose(tp["blocks"]["ssd_A_log"].numpy(),
                               np.asarray(jp["blocks"]["ssd_A_log"]),
                               atol=1e-6)


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_forward_prefill_decode_logits_match_reference(weights,
                                                       kernel_backend):
    """forward_ref prefill of right-padded rows longer than the window,
    then three decode positions over the contiguous cache: logits, the SSD
    state, the conv tail, the kv_win ring and the full-layer K/V match the
    JAX forward_ref."""
    arch, jarch = _archs()
    jp, tp, _ = weights
    B, S, steps = 3, 45, 3
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([45, 37, 3], np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    assert tc["kv_win"][0].shape[2] == arch.window_size < S
    pre, dec = _jitted(jarch)
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
    for key in ("ssm_state", "conv_tail", "kv_win", "kv_full"):
        got_leaves = jax.tree.leaves(tc[key], is_leaf=torch.is_tensor)
        for want, got in zip(jax.tree.leaves(jc[key]), got_leaves):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=1e-5 * np.abs(want).max(),
                                       rtol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve(**over):
    return dict(dict(prompt_len=PROMPT, gen=GEN, max_batch=4), **over)


def _requests(shared):
    return make_requests(1, lo=24, prompt=PROMPT, gen=GEN, shared=shared)


def _deadline(policy):
    return (lambda i: 3 * (8 - i)) if policy == "deadline" else (lambda i: 0)


_JAX_RUNS: dict = {}


def _jax_scheduler_run(jp, policy, knobs):
    """The JAX Scheduler's report, built once per (policy, knobs) in this
    module; one JAX Engine (and its jit cache) per ServeSpec."""
    key = (policy, tuple(sorted(knobs.items())))
    if key not in _JAX_RUNS:
        _, jarch = _archs()
        eng_key = ("engine", tuple(sorted(knobs.items())))
        if eng_key not in _JAX_RUNS:
            _JAX_RUNS[eng_key] = JEngine(JPlan(arch=jarch, serve=JServeSpec(
                **_serve(**knobs))), params=jp)
        dl = _deadline(policy)
        _JAX_RUNS[key] = JScheduler(_JAX_RUNS[eng_key], policy=policy).run(
            [JRequest(i, p.copy(), n, dl(i))
             for i, p, n in _requests(bool(knobs))])
    return _JAX_RUNS[key]


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_generate_matches_reference(weights, kernel_backend):
    """Engine.generate over the contiguous cache, prompts past the window:
    the port's stream is the JAX package's, token for token."""
    arch, jarch = _archs()
    jp, tp, _ = weights
    prompts = np.random.default_rng(0).integers(0, 256, (4, PROMPT)).astype(
        np.int32)
    key = "generate"
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = JEngine(JPlan(arch=jarch, serve=JServeSpec(
            **_serve())), params=jp).generate(prompts)
    want = _JAX_RUNS[key]
    got = Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend))), params=tp,
        device="cpu").generate(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.decode_steps == want.decode_steps == GEN - 1
    assert len(np.unique(want.tokens)) > 6


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("policy,knobs", [("fifo", {}), ("deadline", {}),
                                          ("fifo", KNOBS)])
def test_scheduler_matches_reference(weights, kernel_backend, policy, knobs):
    """Scheduler.run over the paged CacheStore (the 3 full layers' K/V in
    the pool, the windowed layers' rings and the SSD state per slot):
    per-request streams and every counter equal the JAX package's. With
    4-token pages, shared prefixes, eviction and preemption the pool is
    under pressure, and the counters show it."""
    arch, _ = _archs()
    jp, tp, _ = weights
    want = _jax_scheduler_run(jp, policy, knobs)
    dl = _deadline(policy)
    reqs = _requests(bool(knobs))
    got = Scheduler(Engine(Plan(arch=arch, serve=ServeSpec(
        **_serve(kernel_backend=kernel_backend, **knobs))), params=tp,
        device="cpu"), policy=policy).run(
        [Request(i, p.copy(), n, dl(i)) for i, p, n in reqs])
    assert_scheduler_matches(got, want, reqs)
    assert got.pages_total > 0
    if knobs:
        assert got.prefix_hit_tokens > 0 and got.preemptions > 0 and \
            got.evictions > 0 and got.admit_blocked > 0
    assert len({t for r in got.requests for t in r.tokens}) > 6


def test_cache_store_layout_and_stats_match_reference():
    """The hybrid's paged CacheStore: the pool holds stages * m_full
    kv_full groups (16 at full width, of which 3 are written), the rings,
    SSD states and conv tails are per slot, and stats() is the JAX
    package's, pool and slot bytes included."""
    arch, jarch = _archs()
    lo = tcache.make_layout(4, 46, page_size=4, max_pages=20)
    ts = tcache.CacheStore(arch, lo, dtype=torch.float32)
    js = jcache.CacheStore(jarch, jcache.make_layout(4, 46, page_size=4,
                                                     max_pages=20),
                           dtype=jnp.float32)
    assert sorted(ts.tree) == ["block_tab", "conv_tail", "kv_full",
                               "kv_win", "ssm_state"]
    for key in ("kv_full", "kv_win", "ssm_state", "conv_tail"):
        assert jax.tree.map(lambda t: tuple(t.shape), ts.tree[key],
                            is_leaf=torch.is_tensor) == \
            jax.tree.map(lambda a: tuple(a.shape), js.tree[key])
    for st in (ts, js):
        st.alloc(0, 46)
        st.alloc(2, 9)
        st.free(0)
    assert ts.stats() == js.stats()
    full = ARCHS["hymba-1.5b"]
    meta = tlm.layer_meta(full)
    assert full.stages * meta["m_full"] == 16 and \
        sum(k == 0 for k in full.layer_kinds()) == 3


def test_serve_cli_hymba_on_cpu(capsys):
    """launch/serve.py serves the reduced hymba-1.5b on the CPU, through the
    Scheduler (a page pool for the full layers) and through generate()."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--kernel-backend",
              "cuda", "--requests", "3", "--batch", "2", "--prompt-len", "36",
              "--gen", "3", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b" in out and "tokens=9" in out
    assert "pages=0/0" not in out
    cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--batch", "2",
              "--prompt-len", "36", "--gen", "3"])
    assert "generated ids[0]" in capsys.readouterr().out
