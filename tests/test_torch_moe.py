"""The port's MoE family (granite) against the JAX package's, on the CPU.

The grouped matmul's plain version (gmm_ref, the Hopper grouped_matmul
kernel's plain version) is held against the Pallas grouped_matmul in
interpret mode within tests/test_kernels.py's tolerances (2e-5 in f32, the
sums run in another order; 5e-2 in bf16, one rounding of the output).
Routing and the MoE MLP agree with JAX's to 1e-5 (f32, sums in another
order), with and without capacity drops. The model, the Engine and the
Scheduler on reduced granite configs run the JAX package's own init
carried across with params_from_numpy, the block matrices and the router
scaled up (so the layers decide the logits and the routing is not a near
tie); logits agree to 1e-4 and greedy streams and every Scheduler counter
are identical.

Routing is discrete: before any comparison, every routed position's
margin between its K-th and (K+1)-th router logit (measured on the port's
side) must exceed ROUTE_TOL, far above the 1e-6-level differences between
the two frameworks' f32 router logits; otherwise a swapped expert, not a
fault, could explain a difference.
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
from repro.kernels.moe_gmm import grouped_matmul as j_grouped_matmul
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import cache as jcache
from repro_torch.api import Engine, Plan, ServeSpec, get_preset
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serve import cache as tcache
from test_torch_model import _jitted
from test_torch_serve import assert_scheduler_matches, make_requests

LOGIT_TOL = 1e-4
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
ROUTE_TOL = 1e-4
WEIGHT_SCALE = 20.0
MATS = ("wq", "wk", "wv", "wo", "router", "moe_w_in", "moe_w_out")
PROMPT, GEN = 12, 6
# reduced() cuts both granites to 4 experts, top-2; granite-moe-3b keeps a
# different expert count (5, not a power of two, as its 40 is not)
CONFIGS = {"granite-moe-1b-a400m": {},
           "granite-moe-3b-a800m": dict(num_experts=5)}


def _archs(name="granite-moe-1b-a400m", **over):
    over = dict(CONFIGS[name], **over)
    return reduced(ARCHS[name], **over), j_reduced(J_ARCHS[name], **over)


def carried_params(jarch, seed=0):
    """The JAX init with the block matrices and the router scaled: (jax
    tree, port tree)."""
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    host["blocks"] = {k: np.asarray(v, np.float32) *
                      (WEIGHT_SCALE if k in MATS else 1.0)
                      for k, v in host["blocks"].items()}
    return (jax.tree.map(jnp.asarray, host),
            tlm.params_from_numpy(host, device="cpu"))


_WEIGHTS: dict = {}


def weights(name="granite-moe-1b-a400m", **over):
    key = (name, tuple(sorted(over.items())))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = carried_params(_archs(name, **over)[1])
    return _WEIGHTS[key]


def assert_routing_margins(records):
    """Every routed position of every recorded moe_mlp call has its K-th
    and (K+1)-th router logits more than ROUTE_TOL apart."""
    assert records
    for rec in records:
        K = rec["idx"].shape[1]
        m = float(tmoe.topk_margin(rec["logits"], K).min())
        assert m > ROUTE_TOL, f"routing near-tie: margin {m:.2e}"


def _gmm_tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,f", [(2, 32, 16, 24), (4, 64, 48, 96),
                                     (3, 13, 72, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_ref_matches_pallas(E, C, d, f, dtype):
    """gmm_ref against the Pallas grouped_matmul in interpret mode, on
    tests/test_kernels.py's sweep and a ragged C 13 / d 72 / f 40 (Pallas
    shrinks its blocks to divisors there; the Hopper kernel masks)."""
    rng = np.random.default_rng(E * C + d + f)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    jx, jw = (jnp.asarray(a, dtype) for a in (x, w))
    want = j_grouped_matmul(jx, jw, block_c=16, block_f=16, block_d=16,
                            interpret=True)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
              for a in (jx, jw))
    got = tref.gmm_ref(tx, tw)
    assert got.dtype == tdt and got.shape == (E, C, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_gmm_tol(dtype))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jref.gmm_ref(jx, jw), np.float32),
        **_gmm_tol(dtype))


def test_ops_gmm_cuda_backend_on_cpu_is_the_plain_version():
    """On CPU tensors ops.gmm(backend="cuda") is gmm_ref, bit for bit, for
    a strided x (a transposed view, last dim contiguous) and the [E, d,
    G ff] view of a [E, d, G, ff] weight; it counts no launch and refuses
    bad shapes and backends."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 24, generator=g).transpose(0, 1)   # [3, 5, 24]
    w = torch.randn(3, 24, 2, 8, generator=g).reshape(3, 24, 16)
    assert not x.is_contiguous()
    before = dict(LAUNCHES)
    want = tref.gmm_ref(x, w)
    for got in (ops.gmm(x, w, backend="cuda"), ops.gmm(x, w, backend="ref"),
                grouped_matmul(x, w)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="kernel backend"):
        ops.gmm(x, w, backend="interpret")
    with pytest.raises(ValueError, match=r"w \[E, d, f\]"):
        grouped_matmul(x, w[:, :10])


# ---------------------------------------------------------------------------
# routing and the MoE MLP
# ---------------------------------------------------------------------------
def test_route_topk_matches_reference():
    rng = np.random.default_rng(0)
    logits = 3.0 * rng.standard_normal((40, 6)).astype(np.float32)
    tw, tidx, taux = tmoe.route_topk(torch.from_numpy(logits), 2)
    assert float(tmoe.topk_margin(torch.from_numpy(logits), 2).min()) > \
        ROUTE_TOL
    jw, jidx, jaux = jmoe.route_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)


@pytest.mark.parametrize("T,E,K,cf,cap", [(10, 8, 2, 1.0, 4),
                                          (17, 4, 2, 1.0, 8),
                                          (1024, 32, 8, 1.25, 320),
                                          (8, 32, 8, 1.25, 8),
                                          (3, 4, 2, 0.5, 4),
                                          (96, 4, 2, 0.5, 24)])
def test_capacity_matches_reference(T, E, K, cf, cap):
    """The JAX expression with Python's round (half to even): T K / E cf =
    2.5 and 8.5 round down (8.5 -> cap 8, where floor(x + 0.5) would give
    12); granite's prefill group (T 1024) gets 320, its decode step 8."""
    want = int(max(K, round(T * K / E * cf)))
    assert tmoe.capacity(T, E, K, cf) == max(4, (want + 3) // 4 * 4) == cap


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("B,S,cf,drops", [(2, 16, 4.0, False),
                                          (2, 16, 0.5, True),
                                          (1, 17, 1.0, True)])
def test_moe_mlp_matches_reference(backend, B, S, cf, drops):
    """moe_mlp against JAX's, without drops (capacity over the demand),
    with drops (capacity factor 0.5) and at T 17, where T K / E cf = 8.5
    rounds to a capacity of 8: outputs, the aux loss, and the number of
    dropped choices."""
    E, K, d, ff = 4, 2, 32, 24
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    p = {"router": 0.5 * rng.standard_normal((d, E)),
         "w_in": 0.2 * rng.standard_normal((E, d, 2, ff)),
         "w_out": 0.2 * rng.standard_normal((E, ff, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    kw = dict(num_experts=E, top_k=K, mlp_type="swiglu", capacity_factor=cf)
    with tmoe.record_routing() as recs:
        out, aux = tmoe.moe_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), backend=backend, **kw)
    assert_routing_margins(recs)
    (rec,) = recs
    jout, jaux = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    dropped = int((~rec["keep"]).sum())
    assert (dropped > 0) == drops
    assert rec["cap"] == tmoe.capacity(B * S, E, K, cf)
    # the kept choices per expert fill at most cap rows
    loads = torch.bincount(rec["idx"][rec["keep"]], minlength=E)
    assert int(loads.max()) <= rec["cap"]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_params_layout_matches_reference():
    """router, moe_w_in and moe_w_out replace mlp_wi / mlp_wo: names and
    [padded_layers, ...] shapes are the JAX package's, and
    params_from_numpy carries them leaf for leaf."""
    arch, jarch = _archs()
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(0))
    tp = tlm.init_params(arch, torch.Generator().manual_seed(0))
    carried = tlm.params_from_numpy(jax.device_get(jp), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    for tree in (tp, carried):
        assert jax.tree.map(lambda t: tuple(t.shape), tree,
                            is_leaf=torch.is_tensor) == shapes
    E, d, ff = arch.num_experts, arch.d_model, arch.d_ff
    Lp = arch.padded_layers
    blk = tp["blocks"]
    assert "mlp_wi" not in blk and "mlp_wo" not in blk
    assert tuple(blk["router"].shape) == (Lp, d, E)
    assert tuple(blk["moe_w_in"].shape) == (Lp, E, d, 2, ff)
    assert tuple(blk["moe_w_out"].shape) == (Lp, E, ff, d)
    np.testing.assert_array_equal(carried["blocks"]["moe_w_in"].numpy(),
                                  np.asarray(jp["blocks"]["moe_w_in"]))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_forward_prefill_decode_logits_match_reference(name, kernel_backend):
    """forward_ref prefill of right-padded rows, then three decode positions
    (the last at per-row depths) over the contiguous cache: logits match
    the JAX forward_ref at every step."""
    arch, jarch = _archs(name)
    jp, tp = weights(name)
    B, S, steps = 3, 10, 3
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([10, 7, 2], np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    pre, dec = _jitted(jarch)
    jh, jc = pre(jp, jnp.asarray(prompts), jc, jnp.asarray(lens))
    with tmoe.record_routing() as recs:
        th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                                 mode="prefill", cache=tc,
                                 lens=torch.from_numpy(lens),
                                 kernel_backend=kernel_backend)
    assert len(recs) == arch.num_layers
    assert_routing_margins(recs)
    live = np.arange(S)[None] < lens[:, None]
    jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
    np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy()[live],
                               jl[live], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert np.std(jl[live]) > 0.1         # the layers, not a constant, decide
    tok = jl[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    pos = lens.copy()
    for t in range(steps):
        with tmoe.record_routing() as recs:
            th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(tok[:, None]),
                                     mode="decode", cache=tc,
                                     pos=torch.from_numpy(pos),
                                     kernel_backend=kernel_backend)
        assert_routing_margins(recs)
        jh, jc = dec(jp, jnp.asarray(tok[:, None]), jc, jnp.asarray(pos))
        jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
        np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy(), jl,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = jl[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1
    # the deeper layers' K/V carry the residual stream's f32 rounding
    # differences, of order 1e-5 of its scale
    want = np.asarray(jc["kv_full"][0])
    np.testing.assert_allclose(tc["kv_full"][0].numpy(), want,
                               atol=5e-5 * np.abs(want).max(), rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve(**over):
    return dict(dict(prompt_len=PROMPT, gen=GEN, max_batch=4), **over)


def _requests():
    return make_requests(2, lo=3, prompt=PROMPT, gen=GEN)


_JAX_RUNS: dict = {}


def _jax_scheduler_run(name, arch_over, knobs):
    """The JAX Scheduler's report, built once per (arch, knobs) here."""
    key = (name, tuple(sorted(arch_over.items())),
           tuple(sorted(knobs.items())))
    if key not in _JAX_RUNS:
        _, jarch = _archs(name, **arch_over)
        jp, _ = weights(name, **arch_over)
        _JAX_RUNS[key] = JScheduler(JEngine(JPlan(arch=jarch, serve=JServeSpec(
            **_serve(**knobs))), params=jp)).run(
            [JRequest(i, p.copy(), n) for i, p, n in _requests()])
    return _JAX_RUNS[key]


def dropped_real_choices(records, report, prompt_len):
    """(dropped choices at real prompt positions, at padding) summed over
    the recorded prefill groups of a Scheduler run: group g's rows are its
    requests in slot order, each real up to its prompt length; the rest of
    the [max_batch, prompt_len] group is padding."""
    real = pad = 0
    pre = [r for r in records if r["shape"][1] == prompt_len]
    L = len(pre) // report.prefill_calls
    for i, rec in enumerate(pre):
        B, S = rec["shape"]
        rows = sorted((r for r in report.requests if r.group == i // L),
                      key=lambda r: r.slot)
        live = torch.zeros(B, S, dtype=torch.bool)
        for j, r in enumerate(rows):
            live[j, :r.prompt_len] = True
        drop = (~rec["keep"]).view(B, S, -1)
        real += int(drop[live].sum())
        pad += int(drop[~live].sum())
    return real, pad


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_generate_matches_reference(kernel_backend):
    """Engine.generate over the contiguous cache: the port's stream is the
    JAX package's, token for token."""
    arch, jarch = _archs()
    jp, tp = weights()
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (4, PROMPT)).astype(np.int32)
    if "generate" not in _JAX_RUNS:
        _JAX_RUNS["generate"] = JEngine(JPlan(arch=jarch, serve=JServeSpec(
            **_serve())), params=jp).generate(prompts)
    want = _JAX_RUNS["generate"]
    with tmoe.record_routing() as recs:
        got = Engine(Plan(arch=arch, serve=ServeSpec(
            **_serve(kernel_backend=kernel_backend))), params=tp,
            device="cpu").generate(prompts)
    assert_routing_margins(recs)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.decode_steps == want.decode_steps == GEN - 1
    assert len(np.unique(want.tokens)) > 6


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
@pytest.mark.parametrize("case", ["fifo", "paged", "drops"])
def test_scheduler_matches_reference(kernel_backend, case):
    """Scheduler.run over the paged CacheStore: per-request streams and
    every counter equal the JAX package's — one page per slot, 4-token
    pages from a short pool, and capacity_factor 0.5, where prefill groups
    drop real tokens' expert choices (the padding of short prompts and dead
    rows takes capacity as in the JAX package)."""
    arch_over = dict(capacity_factor=0.5) if case == "drops" else {}
    knobs = dict(page_size=4, max_pages=14) if case == "paged" else {}
    arch, _ = _archs(**arch_over)
    _, tp = weights(**arch_over)
    want = _jax_scheduler_run("granite-moe-1b-a400m", arch_over, knobs)
    reqs = _requests()
    with tmoe.record_routing() as recs:
        got = Scheduler(Engine(Plan(arch=arch, serve=ServeSpec(
            **_serve(kernel_backend=kernel_backend, **knobs))), params=tp,
            device="cpu")).run([Request(i, p.copy(), n) for i, p, n in reqs])
    assert_routing_margins(recs)
    assert_scheduler_matches(got, want, reqs)
    assert got.pages_total > 0
    if case == "paged":
        assert got.admit_blocked > 0
    # at the default capacity factor only padding loses choices here
    real, pad = dropped_real_choices(recs, got, PROMPT)
    assert pad > 0 and (real > 0) == (case == "drops")
    assert len({t for r in got.requests for t in r.tokens}) > 6


def test_cache_store_stats_match_reference():
    """MoE uses the dense pool layout: the CacheStore's tree shapes and
    stats() equal the JAX package's for a granite Plan, and at full width
    the 24 layers fill 8 stages of 3 slots, so no pool group is padding."""
    arch, jarch = _archs()
    lo = tcache.make_layout(4, 18, page_size=4, max_pages=14)
    ts = tcache.CacheStore(arch, lo, dtype=torch.float32)
    js = jcache.CacheStore(jarch, jcache.make_layout(4, 18, page_size=4,
                                                     max_pages=14),
                           dtype=jnp.float32)
    assert sorted(ts.tree) == ["block_tab", "kv_full"]
    assert jax.tree.map(lambda t: tuple(t.shape), ts.tree["kv_full"],
                        is_leaf=torch.is_tensor) == \
        jax.tree.map(lambda a: tuple(a.shape), js.tree["kv_full"])
    for st in (ts, js):
        st.alloc(0, 18)
        st.alloc(2, 7)
        st.free(0)
    assert ts.stats() == js.stats()
    full = ARCHS["granite-moe-1b-a400m"]
    assert full.padded_layers == full.num_layers == 24
    assert full.stages * tlm.layer_meta(full)["m_full"] == 24


def test_plan_and_presets_accept_granite():
    """Plan.validate takes a granite serve Plan, and the serve presets take
    a granite arch through Plan.replace."""
    arch, _ = _archs()
    plan = Plan(arch=ARCHS["granite-moe-1b-a400m"],
                serve=ServeSpec(prompt_len=128, gen=32, max_batch=8,
                                page_size=16, max_pages=48,
                                kernel_backend="cuda"))
    assert plan.serve.max_len == 160
    for name in ("serve_tiny", "serve_paged", "serve_kernels"):
        p = get_preset(name, arch=arch)
        assert p.arch.num_experts == 4
        rep = Engine(p, device="cpu").generate()
        assert rep.tokens.shape == (p.serve.max_batch, p.serve.gen)


def test_serve_cli_granite_on_cpu(capsys):
    """launch/serve.py serves the reduced granite-moe-1b on the CPU, through
    the Scheduler over a page pool and through generate()."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
              "--kernel-backend", "cuda", "--requests", "4", "--batch", "2",
              "--prompt-len", "16", "--gen", "4", "--page-size", "4",
              "--max-pages", "12"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-1b-a400m" in out and "tokens=16" in out
    assert "pages=0/0" not in out
    cli.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu", "--batch",
              "2", "--prompt-len", "16", "--gen", "4"])
    assert "generated ids[0]" in capsys.readouterr().out
