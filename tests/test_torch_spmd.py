"""The spmd backend's training half on the CPU, in-process: the logical mesh
(launch/mesh.py), the spec tuples and shard views (lm.param_specs,
lm.shard_blocks), the tp layer (blocks.apply_layer_tp) and the pipelined
train step (core.wave.build_train_step) at mesh (2, 2, 2) of CPU slots,
against the JAX package's local wave step (the oracle of
tests/pipeline_equiv_main.py) and the port's own, from the same numpy
params. Traps Y1-Y5 are pinned here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.core import wave as jwave
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced
from repro_torch.core import wave
from repro_torch.core.tree import flatten_with_path, tree_map
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks, lm
from repro_torch.models.blocks import LayerCtx
from repro_torch.models.layers import rms_norm
from repro_torch.optim import make_optimizer

# tests/pipeline_equiv_main.py's cut: 2 stages x tp 2, 4 layers, Nm 2, remat
CUT = dict(stages=2, tp=2, num_layers=4, num_microbatches=2, remat=True)
B, S = 8, 32


def cfgs(arch, **over):
    kw = dict(CUT)
    if ARCHS[arch].num_experts:
        kw["capacity_factor"] = 8.0
    kw.update(over)
    return j_reduced(J_ARCHS[arch], **kw), reduced(ARCHS[arch], **kw)


def batch(cfg, seed=0):
    key = jax.random.PRNGKey(seed)
    inputs = jax.random.randint(key, (B, S), 0, cfg.vocab_size,
                                dtype=jnp.int32)
    labels = jax.random.randint(jax.random.fold_in(key, 1), (B, S), 0,
                                cfg.vocab_size, dtype=jnp.int32)
    return np.array(inputs), np.array(labels)


def port_step(cfg, mesh, params, inputs, labels, *, overlap=False,
              lr=0.1):
    run = RunConfig(arch=cfg, shape=ShapeConfig("tiny", S, B, "train"),
                    optimizer="sgd", lr=lr, compute_dtype="float32",
                    loss_chunk=16, overlap=overlap)
    step, specs = wave.build_train_step(run, mesh)
    opt = make_optimizer("sgd", lr)
    new, _, m = step(params, opt.init(params),
                     {"inputs": inputs, "labels": labels})
    return new, m


def max_diff(tree, ref):
    want = dict(ref)
    return max(float(np.abs(t.detach().numpy() - want[p]).max())
               for p, t in flatten_with_path(tree))


def mesh222():
    return mesh_lib.make_test_mesh(2, 2, 2, devices="cpu")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_mesh_slots_wrap_round_robin_in_jax_order():
    m = mesh_lib.make_mesh_auto((2, 2, 3), ("data", "stage", "tp"),
                                devices=["cpu", "meta"])
    assert m.shape == {"data": 2, "stage": 2, "tp": 3} and m.size == 12
    flat = m.devices.ravel().tolist()
    # row-major, tp innermost: slot i is device i mod 2 (trap Y1)
    assert [d.type for d in flat] == ["cpu", "meta"] * 6
    assert m.devices[0, 1, 0] == flat[3]
    assert m.physical() == [torch.device("cpu"), torch.device("meta")]
    one = mesh_lib.make_test_mesh(devices="cpu")
    assert one.axis_names == ("data", "stage", "tp")
    assert one.physical() == [torch.device("cpu")]
    prod = mesh_lib.make_production_mesh(devices="cpu")
    assert prod.shape == {"data": 16, "model": 16}
    pod = mesh_lib.make_production_mesh(multi_pod=True, devices="cpu")
    assert pod.axis_names == ("pod", "data", "model")
    tag = np.arange(256, dtype=object).reshape(16, 16)
    logical = mesh_lib.make_logical_mesh(mesh_lib.Mesh(tag, ("data",
                                                             "model")), 4, 4)
    assert logical.shape == {"data": 16, "stage": 4, "tp": 4}
    # the slot order is kept: tp slots are adjacent model slots
    assert logical.devices[3, 1, 2] == tag[3, 6]
    assert "data=16" in repr(logical)
    with pytest.raises(AssertionError):
        mesh_lib.make_logical_mesh(prod, 4, 2)


def test_mesh_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        m = mesh_lib.make_test_mesh(1, 2, 2)
        assert {d.type for d in m.physical()} == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        mesh_lib.make_test_mesh(1, 2, 2)


def test_dp_axes_and_n_dp():
    m = mesh222()
    assert wave.dp_axes(m) == ("data",) and wave.n_dp(m) == 2
    pod = mesh_lib.make_mesh_auto((2, 3, 1, 1),
                                  ("pod", "data", "stage", "tp"), "cpu")
    assert wave.dp_axes(pod) == ("pod", "data") and wave.n_dp(pod) == 6


# ---------------------------------------------------------------------------
# specs and shard views
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_param_specs_equal_the_reference(arch, tp):
    if tp > 1 and ARCHS[arch].num_heads % tp:
        tp = 1
    want = jlm.param_specs(dataclasses.replace(J_ARCHS[arch], tp=tp))
    got = lm.param_specs(dataclasses.replace(ARCHS[arch], tp=tp))
    assert got["blocks"] == {k: tuple(v) for k, v in want["blocks"].items()}
    assert {k: v for k, v in got.items() if k != "blocks"} == \
        {k: tuple(v) for k, v in want.items() if k != "blocks"}


def test_shard_views_share_storage_with_the_leaves():
    _, cfg = cfgs("qwen3-0.6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    m = mesh222()
    views = lm.shard_blocks(cfg, params["blocks"], m, data=1)
    specs = lm.param_specs(cfg)["blocks"]
    sl = cfg.layer_slots
    for name, leaf in params["blocks"].items():
        ptr = leaf.untyped_storage().data_ptr()
        tdim = specs[name].index("tp") if "tp" in specs[name] else None
        for s in range(2):
            for t in range(2):
                for j in range(sl):
                    v = views[s][t][j][name]
                    assert v.untyped_storage().data_ptr() == ptr
                    want = leaf[s * sl + j]
                    if tdim is not None:
                        want = want.chunk(2, dim=tdim - 1)[t]
                    assert torch.equal(v, want)
    # wk / wv are split where KV % tp == 0 and whole where not (Y3)
    assert views[0][1][0]["wk"].shape[-1] == cfg.num_kv_heads * \
        cfg.head_dim // 2
    _, mqa = cfgs("gemma3-1b", num_kv_heads=1)
    mp = lm.init_params(mqa, torch.Generator().manual_seed(0))
    mv = lm.shard_blocks(mqa, mp["blocks"], m)
    assert mv[1][1][0]["wk"].shape == mp["blocks"]["wk"].shape[1:]
    assert mv[1][1][0]["wq"].shape[-1] == mqa.num_heads * mqa.head_dim // 2


# ---------------------------------------------------------------------------
# the tp layer
# ---------------------------------------------------------------------------
def _layer_inputs(cfg, seed=1):
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed))
    # widen the residual updates so the comparison sees every term
    for k in ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo", "moe_w_in",
              "moe_w_out"):
        if k in params["blocks"]:
            params["blocks"][k] = params["blocks"][k] * 10.0
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1))
    shards = lm.shard_blocks(cfg, params["blocks"], mesh222())
    whole = {k: v[0] for k, v in params["blocks"].items()}
    return params, x, shards, whole


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "gemma3-1b", "hymba-1.5b"])
def test_tp_layer_equals_the_whole_layer(arch):
    """tp 2 over the spec's split (gemma3: KV 1, wk / wv whole; hymba: the
    SSD branch whole beside split attention) against apply_layer on the
    unsplit leaves; for MoE the aux is counted once (trap Y2)."""
    _, cfg = cfgs(arch, **({"num_kv_heads": 1} if arch == "gemma3-1b"
                           else {}))
    _, x, shards, whole = _layer_inputs(cfg)
    aux_tp, aux_whole = [], []
    got = blocks.apply_layer_tp(cfg, [shards[0][t][0] for t in range(2)], x,
                                LayerCtx(mode="train", aux=aux_tp))
    want, _ = blocks.apply_layer(cfg, whole, x,
                                 LayerCtx(mode="train", aux=aux_whole))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert len(aux_tp) == len(aux_whole) == (1 if cfg.num_experts else 0)
    if cfg.num_experts:
        assert float(aux_tp[0]) == pytest.approx(float(aux_whole[0]),
                                                 rel=1e-6)
    # one shard is apply_layer itself
    one = blocks.apply_layer_tp(cfg, [whole], x, LayerCtx(mode="train"))
    assert torch.equal(one, blocks.apply_layer(
        cfg, whole, x, LayerCtx(mode="train"))[0])
    # prefill, then a decode step, over the tp slots' caches: the whole
    # layer's outputs on the whole cache, and the same cache
    _tp_serve_equals_whole(cfg, [shards[0][t][0] for t in range(2)], whole,
                           x)


def _tp_serve_equals_whole(cfg, tp_layers, whole, x):
    from repro_torch.serve import cache as cache_lib
    kind = int(lm.layer_meta(cfg)["kind"][0, 0])
    B, S = x.shape[:2]
    whole_c = cache_lib.init_cache(cfg, B, S + 4, dtype=torch.float32)
    slots = cache_lib.shard_cache(
        cfg, cache_lib.init_cache(cfg, B, S + 4, dtype=torch.float32),
        mesh_lib.make_test_mesh(1, 2, 2, devices="cpu"),
        cache_lib.cache_struct(cfg, B, S + 4)[1])[0][0]
    for mode, xin, pos in (("prefill", x, None),
                           ("decode", x[:, -1:] * 0.5,
                            torch.full((B,), S, dtype=torch.int64))):
        ctx = LayerCtx(mode=mode, kind=kind, pos=pos)
        got = blocks.apply_layer_tp(cfg, tp_layers, xin, ctx, slots)
        want, _ = blocks.apply_layer(cfg, whole, xin, ctx, whole_c)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max()), mode
    split = cfg.num_kv_heads % 2 == 0
    for key, want in whole_c.items():
        for i, w in enumerate(want if isinstance(want, tuple) else (want,)):
            parts = [s[key][i] if isinstance(s[key], tuple) else s[key]
                     for s in slots]
            got = torch.cat(parts, dim=3) if split and key.startswith(
                "kv") else parts[0]
            w = w[:got.shape[0]]                          # stage 0's groups
            assert float((got - w).abs().max()) <= \
                1e-5 * max(float(w.abs().max()), 1e-30), key


def test_kv_whole_groups_as_the_jax_device_does():
    """Trap Y3: with KV % tp != 0 each shard holds all KV heads beside its
    H/tp query heads and groups them locally (q head i -> kv i // (H/tp /
    KV)), as the JAX device computes; for KV > 1 that is not the whole
    layer's grouping. Pinned: the port's tp layer equals the sum of the
    JAX package's per-shard attention partials (+ the whole MLP), and
    differs from the whole layer."""
    jcfg, cfg = cfgs("qwen3-0.6b", num_heads=6, num_kv_heads=3, head_dim=16,
                     d_model=96)
    assert cfg.num_kv_heads % cfg.tp
    params, x, shards, whole = _layer_inputs(cfg)
    got = blocks.apply_layer_tp(cfg, [shards[0][t][0] for t in range(2)], x,
                                LayerCtx(mode="train"))
    jx = jnp.asarray(x.numpy())
    jp = {k: jnp.asarray(v.numpy()) for k, v in whole.items()}
    xn = jlayers.rms_norm(jx, jp["ln1"], eps=cfg.norm_eps)
    att = 0.0
    for t in range(2):
        pt = {k: jnp.asarray(v.numpy()) for k, v in shards[0][t][0].items()}
        att = att + jblocks._attn_train(jcfg, pt, xn,
                                        jblocks.LayerCtx(mode="train"),
                                        None)[0]
    jx2 = jx + att
    jy = jx2 + jblocks._mlp_dense(
        jcfg, jp, jlayers.rms_norm(jx2, jp["ln2"], eps=cfg.norm_eps))
    jy = np.asarray(jy)
    assert float(np.abs(got.numpy() - jy).max()) <= 1e-5 * np.abs(jy).max()
    want, _ = blocks.apply_layer(cfg, whole, x, LayerCtx(mode="train"))
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())


# ---------------------------------------------------------------------------
# the pipelined train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_train_step_equals_the_local_wave_step(arch):
    """One sgd-0.1 step of build_train_step at mesh (2, 2, 2) against JAX's
    build_local_wave_step(cfg, 4, sgd) (Nm 4 = 2 data slots x 2) and the
    port's, from the same numpy params: params within 1e-4 (JAX's own
    bound for this comparison, the bf16 CE product's epsilon)."""
    jcfg, cfg = cfgs(arch)
    jp, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_p = jax.device_get(jp)
    inputs, labels = batch(cfg)
    jopt = j_make_optimizer("sgd", 0.1)
    deltas, _, jloss = jwave.build_local_wave_step(jcfg, 4, jopt)(
        jp, jopt.init(jp), inputs, labels)
    jnew = jax.device_get(jax.tree.map(jnp.add, jp, deltas))
    params = lm.params_from_numpy(np_p, device="cpu")
    new, m = port_step(cfg, mesh222(), params, inputs, labels)
    assert abs(float(m["loss"]) - float(jloss)) < 1e-5
    assert max_diff(new, flatten_with_path(jnew)) < 1e-4
    # the inputs stay as they were (new tensors come back)
    assert max_diff(params, flatten_with_path(np_p)) == 0.0
    opt = make_optimizer("sgd", 0.1)
    d, _, loss = wave.build_local_wave_step(cfg, 4, opt)(
        params, opt.init(params), inputs, labels)
    mine = flatten_with_path(tree_map(torch.add, params, d))
    assert abs(float(m["loss"]) - float(loss)) < 1e-5
    assert max_diff(new, [(p, t.numpy()) for p, t in mine]) < 1e-4
    if cfg.num_experts:
        assert float(m["aux"]) > 0


@pytest.mark.parametrize("arch,over", [
    ("hymba-1.5b", {}),                               # hybrid, mixed kinds
    ("gemma3-1b", {"num_layers": 6, "num_kv_heads": 1}),  # global + local
    ("qwen3-0.6b", {"num_layers": 3}),                # a padded slot
    ("qwen3-0.6b", {"tp": 1}),                        # mesh tp replicates
])
def test_train_step_families_equal_the_port_local_step(arch, over):
    _, cfg = cfgs(arch, **over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    inputs, labels = batch(cfg, seed=3)
    new, m = port_step(cfg, mesh222(), params, inputs, labels)
    opt = make_optimizer("sgd", 0.1)
    d, _, loss = wave.build_local_wave_step(cfg, 4, opt)(
        params, opt.init(params), inputs, labels)
    mine = flatten_with_path(tree_map(torch.add, params, d))
    assert abs(float(m["loss"]) - float(loss)) < 1e-5
    assert max_diff(new, [(p, t.numpy()) for p, t in mine]) < 1e-4


def test_overlap_schedule_is_bit_identical_in_loss():
    """The skewed schedule against the baseline: the same compute per
    microbatch, so the loss difference is exactly 0.0; params within 1e-6
    (autograd may add a shared leaf's grads in another order)."""
    _, cfg = cfgs("qwen3-0.6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    inputs, labels = batch(cfg)
    base, mb = port_step(cfg, mesh222(), params, inputs, labels)
    over, mo = port_step(cfg, mesh222(), params, inputs, labels,
                         overlap=True)
    assert abs(float(mo["loss"]) - float(mb["loss"])) == 0.0
    assert max_diff(over, [(p, t.numpy()) for p, t in
                           flatten_with_path(base)]) < 1e-6


@pytest.mark.parametrize("overlap", [False, True])
def test_pipeline_runs_each_microbatch_once_per_stage(overlap, monkeypatch):
    """pipeline_wave follows tick_schedule: stage s runs microbatch j at
    tick j + skew s, bubble ticks run nothing, and the last stage's
    outputs come back in microbatch order."""
    _, cfg = cfgs("qwen3-0.6b", num_microbatches=4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    m = mesh222()
    shards = lm.shard_blocks(cfg, params["blocks"], m)
    calls = []
    real = lm.stage_apply

    def spy(cfg_, stage_layers, x, meta, ctx, caches=None):
        s = next(i for i in range(cfg.stages)
                 if stage_layers[0] is shards[i][0])
        calls.append((s, float(x.sum())))
        return real(cfg_, stage_layers, x, meta, ctx, caches)

    monkeypatch.setattr(lm, "stage_apply", spy)
    x = torch.randn(8, 16, cfg.d_model)
    y, aux = wave.pipeline_wave(cfg, shards, x, wave._meta_tree(cfg),
                                mode="train", nm=4, overlap=overlap)
    sched, ticks = wave.tick_schedule(cfg.stages, 4, overlap=overlap)
    live = sorted((t, s) for s, t, mb in sched if mb >= 0)
    assert [s for s, _ in calls] == [s for _, s in live]
    assert len(calls) == 4 * cfg.stages and float(aux) == 0.0
    monkeypatch.setattr(lm, "stage_apply", real)
    for j in range(4):
        h = x[2 * j:2 * j + 2]
        for s in range(cfg.stages):
            h = real(cfg, [shards[s][0], shards[s][1]], h,
                     {k: v[s] for k, v in wave._meta_tree(cfg).items()},
                     LayerCtx(mode="train"))
        assert torch.equal(y[2 * j:2 * j + 2], h)
    # prefill runs the same schedule (its cache riding along) to the same
    # hidden states, and drops the aux
    from repro_torch.serve import cache as cache_lib
    caches = cache_lib.shard_cache(
        cfg, cache_lib.init_cache(cfg, 8, 16, dtype=torch.float32), m,
        cache_lib.cache_struct(cfg, 8, 16)[1])[0]
    calls.clear()
    monkeypatch.setattr(lm, "stage_apply", spy)
    yp, auxp = wave.pipeline_wave(cfg, shards, x, wave._meta_tree(cfg),
                                  mode="prefill", nm=4, cache=caches,
                                  overlap=overlap)
    assert [s for s, _ in calls] == [s for _, s in live]
    assert auxp is None and torch.equal(yp, y)


def test_aux_is_summed_over_stages_then_averaged_over_data_and_nm():
    """Trap Y4: aux = (sum over stages and ticks) -> mean over data slots
    -> / Nm, i.e. the mean microbatch's aux summed over layers; the same
    number the local wave step's microbatches average."""
    _, cfg = cfgs("granite-moe-1b-a400m")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    inputs, labels = batch(cfg)
    _, m = port_step(cfg, mesh222(), params, inputs, labels, lr=0.0)
    per_mb = []
    for j in range(4):
        aux = []
        with torch.no_grad():
            x = lm.embed_tokens(cfg, params,
                                torch.as_tensor(inputs[2 * j:2 * j + 2]))
            for l in range(cfg.num_layers):
                x, _ = blocks.apply_layer(
                    cfg, {k: v[l] for k, v in params["blocks"].items()}, x,
                    LayerCtx(mode="train", aux=aux))
        per_mb.append(float(torch.stack(aux).sum()))
    assert float(m["aux"]) == pytest.approx(np.mean(per_mb), rel=1e-5)


def test_spmd_loss_keeps_the_padded_vocab():
    """Trap Y5: the JAX package's spmd loss runs the CE over the padded
    vocab (no valid_vocab mask), where lm_loss masks the padding; with a
    vocab that is not a multiple of 16 the two differ, and the port's
    _loss_over_wave is JAX's _loss_over_wave."""
    jcfg, cfg = cfgs("qwen3-0.6b", vocab_size=250)
    jp, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm.params_from_numpy(jax.device_get(jp), device="cpu")
    hid = np.random.default_rng(0).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 250, (2, S))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", S, 2, "train"),
                    loss_chunk=16)
    jrun = dataclasses.replace(run, arch=jcfg)
    got = float(wave._loss_over_wave(cfg, run, params, torch.from_numpy(hid),
                                     torch.from_numpy(labels)))
    want = float(jwave._loss_over_wave(jcfg, jrun, jp, jnp.asarray(hid),
                                       jnp.asarray(labels, jnp.int32)))
    assert got == pytest.approx(want, rel=1e-6)
    masked = float(lm.lm_loss(cfg, params, torch.from_numpy(hid),
                              torch.from_numpy(labels), chunk=16))
    assert abs(masked - got) > 1e-4


def test_tp_layer_norms_the_replicated_x_once(monkeypatch):
    """The tp layer norms x once on the stage's device and hands the same
    normed tensor to every shard (no per-shard norm)."""
    _, cfg = cfgs("qwen3-0.6b")
    _, x, shards, whole = _layer_inputs(cfg)
    seen = []
    real = blocks._attn_train

    def spy(cfg_, p, xn, ctx, cache):
        seen.append(xn)
        return real(cfg_, p, xn, ctx, cache)

    monkeypatch.setattr(blocks, "_attn_train", spy)
    blocks.apply_layer_tp(cfg, [shards[0][t][0] for t in range(2)], x,
                          LayerCtx(mode="train"))
    assert len(seen) == 2 and seen[0] is seen[1]
    assert torch.equal(seen[0], rms_norm(x, whole["ln1"], eps=cfg.norm_eps))
