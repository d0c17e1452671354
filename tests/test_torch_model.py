"""The port's dense model against the JAX package's, on the CPU in f32.

Weights are the JAX package's own init (scaled up so the layers, not the
tied embedding, decide the logits) carried across with
`lm.params_from_numpy`; inputs are made with numpy from a seed. Logits
agree to 1e-4 absolute (values of order 1-10): both sides compute in f32
but sum in different orders (XLA's CPU dot against PyTorch's), and the
differences grow a little through the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.presets import _tiny_arch as j_tiny_arch
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import cache as jcache
from repro_torch.api.presets import _tiny_arch
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import cache as tcache

LOGIT_TOL = 1e-4
WEIGHT_SCALE = 20.0


def _archs():
    """(port arch, JAX arch) pairs: the presets' tiny qwen3 (MHA) and
    reduced qwen3 with 4 query / 2 kv heads of 32 (GQA G = 2)."""
    gqa = dict(num_heads=4, num_kv_heads=2, head_dim=32)
    return {"tiny": (_tiny_arch(), j_tiny_arch()),
            "reduced_gqa": (reduced(ARCHS["qwen3-0.6b"], **gqa),
                            j_reduced(J_ARCHS["qwen3-0.6b"], **gqa))}


def carried_params(jarch, scale=WEIGHT_SCALE, seed=0):
    """JAX init (block matrices scaled) as (jax tree, port tree)."""
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    mats = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo")
    host["blocks"] = {k: np.asarray(v) * (scale if k in mats else 1.0)
                      for k, v in host["blocks"].items()}
    return (jax.tree.map(jnp.asarray, host),
            tlm.params_from_numpy(host, device="cpu"))


def _jitted(jarch):
    """The JAX forward_ref prefill / decode, jit-compiled (eager JAX
    dispatch is slow): (params, x, cache[, lens | pos]) -> (hidden, cache)."""
    def pre(p, x, c, lens=None):
        h, c, _ = jlm.forward_ref(jarch, p, x, mode="prefill", cache=c,
                                  lens=lens)
        return h, c

    def dec(p, x, c, pos):
        h, c, _ = jlm.forward_ref(jarch, p, x, mode="decode", cache=c,
                                  pos=pos)
        return h, c
    return jax.jit(pre), jax.jit(dec)


def test_configs_match_reference():
    """Every ARCHS entry and its reduced() twin equal the JAX package's
    field for field, as do the shape cells; the fields the port alone has
    (per-layer kinds, NoPE, the expert share, the shared expert, Mamba-2's
    conv bias and gate order) hold their defaults there."""
    assert sorted(ARCHS) == sorted(J_ARCHS)
    jax_fields = {f.name for f in dataclasses.fields(J_ARCHS["qwen3-0.6b"])}
    defaults = {f.name: f.default for f in dataclasses.fields(
        ARCHS["qwen3-0.6b"]) if f.name not in jax_fields}
    assert set(defaults) == {"layer_types", "pos_emb", "experts_held",
                             "expert_offset", "shared_ff", "ssm_conv_bias",
                             "ssm_gate_norm"}

    def split(cfg):
        d = dataclasses.asdict(cfg)
        return ({k: v for k, v in d.items() if k in jax_fields},
                {k: v for k, v in d.items() if k not in jax_fields})

    for name in ARCHS:
        for mine, jax_cfg in ((ARCHS[name], J_ARCHS[name]),
                              (reduced(ARCHS[name]),
                               j_reduced(J_ARCHS[name]))):
            shared, own = split(mine)
            assert shared == dataclasses.asdict(jax_cfg)
            assert own == defaults
    from repro.configs import SHAPES as J_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("which", ["tiny", "reduced_gqa"])
def test_params_layout_matches_reference(which):
    """init_params and params_from_numpy give the JAX leaf names, shapes
    and [padded_layers, ...] stacking; layer_meta and the vocab pad too."""
    arch, jarch = _archs()[which]
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(0))
    tp = tlm.init_params(arch, torch.Generator().manual_seed(0))
    carried = tlm.params_from_numpy(jax.device_get(jp), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    for tree in (tp, carried):
        assert jax.tree.map(lambda t: tuple(t.shape), tree,
                            is_leaf=torch.is_tensor) == shapes
    np.testing.assert_array_equal(carried["blocks"]["wq"].numpy(),
                                  np.asarray(jp["blocks"]["wq"]))
    assert tlm.padded_vocab(arch) == jlm.padded_vocab(jarch)
    tm, jm = tlm.layer_meta(arch), jlm.layer_meta(jarch)
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k])


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    for theta in (10_000.0, 1_000_000.0):
        for pos in (np.arange(5), np.array([[3], [17]])):
            tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), 32, theta)
            jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 32, theta)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        tc, ts = tlayers.rope_cos_sin(torch.arange(5), 32, theta)
        jc, js = jlayers.rope_cos_sin(jnp.arange(5), 32, theta)
        np.testing.assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "reduced_gqa"])
@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_forward_prefill_decode_logits_match_reference(which,
                                                       kernel_backend):
    """forward_ref prefill then three decode positions over the contiguous
    cache: logits match the JAX forward_ref at every step. The "cuda"
    backend runs the kernels' plain versions on these CPU tensors."""
    arch, jarch = _archs()[which]
    jp, tp = carried_params(jarch)
    B, S, steps = 3, 6, 3
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    jc = jcache.init_cache(jarch, B, S + steps, dtype=jnp.float32)
    tc = tcache.init_cache(arch, B, S + steps, dtype=torch.float32)
    j_pre, j_dec = _jitted(jarch)
    jh, jc = j_pre(jp, jnp.asarray(prompts), jc)
    th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                             mode="prefill", cache=tc,
                             kernel_backend=kernel_backend)
    jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
    tl = tlm.logits_ref(arch, tp, th).numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert np.std(jl) > 0.1          # the layers, not a constant, decide
    tok = jl[:, -1].argmax(-1).astype(np.int32)
    for t in range(steps):
        # the last step decodes each row at its own depth
        pos = S + t if t < steps - 1 else np.array([S + t, S + t - 1, 0])
        jh, jc = j_dec(jp, jnp.asarray(tok[:, None]), jc,
                       jnp.asarray(pos, jnp.int32))
        th, tc = tlm.forward_ref(arch, tp, torch.from_numpy(tok[:, None]),
                                 mode="decode", cache=tc,
                                 pos=torch.as_tensor(pos),
                                 kernel_backend=kernel_backend)
        jl = np.asarray(jlm.logits_ref(jarch, jp, jh))
        np.testing.assert_allclose(tlm.logits_ref(arch, tp, th).numpy(), jl,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = jl[:, -1].argmax(-1).astype(np.int32)
    np.testing.assert_allclose(tc["kv_full"][0].numpy(),
                               np.asarray(jc["kv_full"][0]), atol=1e-4)


@pytest.mark.parametrize("kernel_backend", ["ref", "cuda"])
def test_paged_prefill_decode_match_reference(kernel_backend):
    """Variable-length prefill into a paged pool through the block table,
    then a per-row decode step: logits and the written pool pages match
    the JAX package."""
    arch, jarch = _archs()["reduced_gqa"]
    jp, tp = carried_params(jarch)
    layout = tcache.make_layout(3, 12, page_size=4, max_pages=8)
    jlayout = jcache.make_layout(3, 12, page_size=4, max_pages=8)
    tab = np.array([[2, 5, 0], [7, 1, -1], [-1, -1, -1]], np.int32)
    lens = np.array([9, 5, 1], np.int32)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, arch.vocab_size, (3, 10)).astype(np.int32)
    jtree = jcache.init_paged(jarch, jlayout, dtype=jnp.float32)
    jtree["block_tab"] = jnp.asarray(tab)
    ttree = tcache.init_paged(arch, layout, dtype=torch.float32)
    ttree["block_tab"] = torch.from_numpy(tab)
    j_pre, j_dec = _jitted(jarch)
    jh, jtree = j_pre(jp, jnp.asarray(prompts), jtree, jnp.asarray(lens))
    th, ttree = tlm.forward_ref(arch, tp, torch.from_numpy(prompts),
                                mode="prefill", cache=ttree,
                                lens=torch.from_numpy(lens),
                                kernel_backend=kernel_backend)
    # live pages only: the trash page takes dead rows' writes in any order
    for jpool, tpool in zip(jtree["kv_full"], ttree["kv_full"]):
        np.testing.assert_allclose(tpool[:, :8].numpy(),
                                   np.asarray(jpool)[:, :8], atol=1e-4)
    tok = np.array([[3], [4], [5]], np.int32)
    pos = lens.copy()
    jh, jtree = j_dec(jp, jnp.asarray(tok), jtree, jnp.asarray(pos))
    th, ttree = tlm.forward_ref(arch, tp, torch.from_numpy(tok),
                                mode="decode", cache=ttree,
                                pos=torch.from_numpy(pos),
                                kernel_backend=kernel_backend)
    np.testing.assert_allclose(
        tlm.logits_ref(arch, tp, th).numpy()[:2],
        np.asarray(jlm.logits_ref(jarch, jp, jh))[:2],
        atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_unported_families_raise():
    """The stub-frontend archs (inputs are embeddings, not token ids) serve
    through Engine.generate() — the prompts and each decode step's input
    are stub embeddings drawn on the Engine's device — while the request
    Scheduler, which feeds generated ids back, refuses them with the JAX
    package's message."""
    from repro_torch.api import Engine, Plan, ServeSpec
    from repro_torch.api.serving import Scheduler
    for name in ("chameleon-34b", "musicgen-medium"):
        arch = reduced(ARCHS[name])
        assert arch.frontend != "none"
        eng = Engine(Plan(arch=arch, serve=ServeSpec(prompt_len=4, gen=3,
                                                     max_batch=2)),
                     device="cpu")
        rep = eng.generate()
        assert rep.tokens.shape == (2, 3) and rep.decode_steps == 2
        assert ((rep.tokens >= 0) & (rep.tokens < arch.vocab_size)).all()
        # seeded: a second engine draws the same embeddings and tokens
        again = Engine(eng.plan, params=eng._params, device="cpu")
        np.testing.assert_array_equal(again.generate().tokens, rep.tokens)
        with pytest.raises(ValueError, match="stub-frontend architecture"):
            Scheduler(eng)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_act_and_fused_width_equal_jax(mlp_type):
    """layers.mlp_act over a fused [gate | up] width, and mlp_fused_width,
    against the JAX package's on the same numpy input (f32)."""
    ff = 24
    width = tlayers.mlp_fused_width(mlp_type, ff)
    assert width == jlayers.mlp_fused_width(mlp_type, ff)
    h = np.random.default_rng(5).standard_normal((3, 7, width)).astype(
        np.float32)
    got = tlayers.mlp_act(torch.from_numpy(h), mlp_type, ff).numpy()
    want = np.asarray(jlayers.mlp_act(jnp.asarray(h), mlp_type, ff))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        tlayers.mlp_act(torch.from_numpy(h), "tanh", ff)


def test_init_dense_draws_from_its_generator():
    """init_dense: scale x N(0, 1) from the explicit generator, cast to the
    dtype; the same seed gives the same draw (jax.random's differ, so the
    shape, dtype and spread are what is held to JAX's)."""
    a = tlayers.init_dense(torch.Generator().manual_seed(3), (64, 32))
    b = tlayers.init_dense(torch.Generator().manual_seed(3), (64, 32))
    c = tlayers.init_dense(torch.Generator().manual_seed(3), (64, 32),
                           scale=1.0, dtype=torch.bfloat16)
    want = jlayers.init_dense(jax.random.PRNGKey(3), (64, 32))
    assert torch.equal(a, b) and tuple(a.shape) == want.shape
    assert a.dtype == torch.float32 and c.dtype == torch.bfloat16
    torch.testing.assert_close(a, 0.02 * c.float(), atol=1e-4, rtol=1e-2)
    assert abs(float(a.std()) - float(np.std(np.asarray(want)))) < 3e-3
