"""The spmd backend's serve half on the CPU, in-process: the cache's specs
and per-slot placement (serve.cache.cache_struct / paged_struct specs,
shard_cache, slice_mb / update_mb) against the JAX package's, the tp
layer's prefill and decode against the sum of JAX's per-shard partials
(KV split over tp, and KV whole, trap Y3), the sequence-sharded merge of
decode partials, and the serve surface: generate() on a 1x1x1 mesh against
JAX's threads Engine (tests/test_serve.py:149-162), the spmd Scheduler
against the threads one for the families the JAX parity streams do not
cover, the spmd Plan checks (tests/test_serve.py:79-88), the serve_spmd
preset and the serve CLI's --backend spmd. The pipelined steps on deeper
meshes are held to JAX's in tests/test_torch_spmd_serve_parity.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import Plan as JPlan
from repro.api import ServeSpec as JServeSpec
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.serve import cache as jcache
from repro_torch.api import (Engine, PartitionSpec, Plan, RunSpec,
                             ServeSpec, get_preset)
from repro_torch.api import engine as engine_mod
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as attn
from repro_torch.models import blocks, lm
from repro_torch.models.blocks import LayerCtx
from repro_torch.serve import cache as tcache
from test_torch_model import carried_params as dense_params
from test_torch_rwkv6 import carried_params as rwkv_params

LOGIT_TOL = 1e-4
SERVE_ARCHS = ("qwen3-0.6b", "h2o-danube-1.8b", "rwkv6-3b")


def _specs(tree):
    """JAX's PartitionSpecs as the port's plain tuples."""
    return {k: tuple(tuple(p) for p in v) if isinstance(v, tuple)
            else tuple(v) for k, v in tree.items()}


def _small(name, **over):
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_microbatches=2)
    if ARCHS[name].attn_type == "swa":
        base["window_size"] = 6            # < max_len: the ring wraps
    base.update(over)
    return reduced(ARCHS[name], **base), j_reduced(J_ARCHS[name], **base)


def _leaves(tree):
    """[(key, leaf)] of a cache dict, K/V pairs as key/0, key/1."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += [(f"{k}/{i}", x) for i, x in enumerate(v)] \
            if isinstance(v, tuple) else [(k, v)]
    return out


def _struct(cfg, paged):
    """(shapes, specs) of the random trees: 4 rows of 12 positions."""
    if paged:
        lo = tcache.make_layout(4, 12, page_size=4, max_pages=10)
        return tcache.paged_struct(cfg, lo, dtype=torch.float32)
    return tcache.cache_struct(cfg, 4, 12, dtype=torch.float32)


def _random_tree(cfg, paged, seed):
    """A cache tree with random contents as (numpy dict, port tree, JAX
    tree) of the same values; hymba's has every kind of leaf."""
    shapes, _ = _struct(cfg, paged)
    rng = np.random.default_rng(seed)

    def draw(struct):
        if isinstance(struct[1], torch.dtype):
            shp, dt = struct
            if dt == torch.int32:
                return rng.integers(-1, 10, shp).astype(np.int32)
            return rng.standard_normal(shp).astype(np.float32)
        return tuple(draw(s) for s in struct)

    host = {k: draw(s) for k, s in shapes.items()}
    to_t = lambda v: tuple(torch.from_numpy(x.copy()) for x in v) \
        if isinstance(v, tuple) else torch.from_numpy(v.copy())
    to_j = lambda v: tuple(jnp.asarray(x) for x in v) \
        if isinstance(v, tuple) else jnp.asarray(v)
    return host, {k: to_t(v) for k, v in host.items()}, \
        {k: to_j(v) for k, v in host.items()}


def _same(port_tree, jax_tree):
    got, want = _leaves(port_tree), _leaves(jax_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


# ---------------------------------------------------------------------------
# the cache's specs and placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_specs_equal_jax(name):
    """cache_struct / paged_struct's specs are JAX's, as plain tuples: the
    stage-major groups, KV heads over tp where KV % tp == 0, the batch over
    data from 16 rows on, the sequence over data with seq_shards > 1, the
    block table whole."""
    for tp in (1, 2):
        arch = reduced(ARCHS[name], tp=tp)
        jarch = j_reduced(J_ARCHS[name], tp=tp)
        for batch, shards in ((2, 1), (2, 16), (16, 1)):
            _, got = tcache.cache_struct(arch, batch, 16, seq_shards=shards)
            _, want = jcache.cache_struct(jarch, batch, 16,
                                          seq_shards=shards)
            assert got == _specs(want), (tp, batch, shards)
        lo = tcache.make_layout(2, 16, page_size=4)
        _, got = tcache.paged_struct(arch, lo)
        _, want = jcache.paged_struct(jarch, jcache.make_layout(
            2, 16, page_size=4))
        assert got == _specs(want), tp


@pytest.mark.parametrize("paged", [False, True])
def test_slice_and_update_mb_equal_jax(paged):
    """slice_mb gives JAX's microbatch views (per-slot rows at dim 1, the
    pool whole, the block table's rows); update_mb ends with JAX's tree
    whether the stage wrote the views in place or handed back new
    tensors, and keeps the rows on an invalid tick."""
    cfg, jcfg = _small("hymba-1.5b", num_layers=4, tp=2)
    host, tree, jtree = _random_tree(cfg, paged, 0)
    _same(tcache.slice_mb(tree, 1, 2), jcache.slice_mb(jtree, 1, 2))
    view = tcache.slice_mb(tree, 1, 2)
    _, new, jnew = _random_tree(cfg, paged, 1)
    new = tcache.slice_mb(new, 1, 2)
    jnew = jcache.slice_mb(jnew, 1, 2)
    want = jcache.update_mb(jtree, jnew, 1, 2, True)
    # (a) the stage wrote the views in place
    for (k, v), (_, n) in zip(_leaves(view), _leaves(new)):
        if k != "block_tab":                # read-only in a step
            v.copy_(n)
    tcache.update_mb(tree, view, 1, 2, True)
    _same(tree, want)
    # (b) new tensors handed back: copied in
    _, tree2, _ = _random_tree(cfg, paged, 0)
    tcache.update_mb(tree2, new, 1, 2, True)
    _same(tree2, want)
    # (c) an invalid tick keeps the rows (JAX still takes a pool whole:
    # its scatters routed dead rows to the trash page)
    _, tree3, jtree3 = _random_tree(cfg, paged, 0)
    tcache.update_mb(tree3, new, 1, 2, False)
    _same(tree3, jcache.update_mb(jtree3, jnew, 1, 2, False))


def test_shard_cache_gives_each_slot_a_contiguous_part():
    """Each (data, stage, tp) slot's leaves: its stage's groups, its
    KV-head chunk where KV splits over tp (a contiguous copy: a pool of its
    own), one shared tensor where the spec keeps a leaf whole (KV 1, trap
    Y3; the SSD state), the batch rows or sequence shard of its data slot,
    and one block table for the device."""
    mesh = mesh_lib.make_test_mesh(1, 2, 2, devices="cpu")
    cfg, _ = _small("hymba-1.5b", num_layers=4, tp=2, num_kv_heads=2)
    _, tree, _ = _random_tree(cfg, True, 0)
    glob = {k: v for k, v in _leaves(tree)}
    slots = tcache.shard_cache(cfg, tree, mesh, _struct(cfg, True)[1])
    m = glob["kv_full/0"].shape[0] // 2
    for s in range(2):
        for t in range(2):
            c = slots[0][s][t]
            pool = c["kv_full"][0]
            assert pool.is_contiguous() and pool.shape[3] == 1
            assert torch.equal(pool, glob["kv_full/0"][s * m:(s + 1) * m, :,
                                                       :, t:t + 1])
            assert c["ssm_state"] is slots[0][s][0]["ssm_state"]
            assert c["ssm_state"].is_contiguous()
            assert c["block_tab"] is slots[0][0][0]["block_tab"]
    # the KV-head chunk is strided in the global pool: the paged decode
    # kernel would refuse it (flash_decode_paged wants contiguous pools)
    assert not glob["kv_full/0"][:m, :, :, :1].is_contiguous()
    # KV 1 stays whole over tp: one tensor, the global stage view itself
    g1, _ = _small("gemma3-1b", num_layers=6, tp=2, num_kv_heads=1)
    _, gtree, _ = _random_tree(g1, True, 0)
    gs = tcache.shard_cache(g1, gtree, mesh, _struct(g1, True)[1])
    assert gs[0][1][0]["kv_win"][0] is gs[0][1][1]["kv_win"][0]
    assert gs[0][0][0]["kv_full"][0].data_ptr() == \
        gtree["kv_full"][0].data_ptr()
    # the batch over data (16 rows) and the sequence over data (merge)
    mesh2 = mesh_lib.make_test_mesh(2, 2, 2, devices="cpu")
    q, _ = _small("qwen3-0.6b", num_layers=4, tp=2)
    for batch, shards, dim in ((16, 1, 1), (8, 16, 2)):
        shapes, specs = tcache.cache_struct(q, batch, 12, seq_shards=shards,
                                            dtype=torch.float32)
        k = torch.randn(shapes["kv_full"][0][0])
        ds = tcache.shard_cache(q, {"kv_full": (k, k.clone())}, mesh2, specs)
        for d in range(2):
            part = ds[d][1][1]["kv_full"][0]
            n = k.shape[dim] // 2
            want = k[2:4].narrow(dim, d * n, n)[:, :, :, 1:2]
            assert part.is_contiguous() and torch.equal(part, want)


# ---------------------------------------------------------------------------
# the tp layer in prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", [3, 2])
def test_tp_serve_layer_equals_jax_shard_partials(kv):
    """H 6 over tp 2 with KV 3 (KV % tp != 0, trap Y3: each shard holds all
    KV heads, one cache copy) and KV 2 (one KV head a shard, its own cache
    chunk): a prefill, then a decode step, of apply_layer_tp over the
    slots' caches against the JAX package's layer on each tp device — the
    sum of its _attn_train / _attn_decode partials, each over that device's
    cache, then the MLP partials — outputs within 1e-5 of the scale, and
    every slot's cache equal to its JAX device's."""
    over = dict(stages=2, tp=2, num_layers=4, num_heads=6, num_kv_heads=kv,
                head_dim=16, d_model=96)
    cfg = reduced(ARCHS["qwen3-0.6b"], **over)
    jcfg = j_reduced(J_ARCHS["qwen3-0.6b"], **over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1))
    for k in ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo"):
        params["blocks"][k] = params["blocks"][k] * 10.0
    mesh = mesh_lib.make_test_mesh(1, 2, 2, devices="cpu")
    shards = [lm.shard_blocks(cfg, params["blocks"], mesh)[0][t][0]
              for t in range(2)]
    B, S = 2, 12
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    glob = tcache.init_cache(cfg, B, S + 2, dtype=torch.float32)
    slots = tcache.shard_cache(cfg, glob, mesh, tcache.cache_struct(
        cfg, B, S + 2)[1])[0][0]
    jglob = jcache.init_cache(jcfg, B, S + 2, dtype=jnp.float32)
    m = jglob["kv_full"][0].shape[0] // 2
    h = kv if kv % 2 else kv // 2          # each JAX device's KV heads
    lo = [0, 0] if kv % 2 else [0, h]
    jslots = [{"kv_full": tuple(a[:m, :, :, lo[t]:lo[t] + h]
                                for a in jglob["kv_full"])}
              for t in range(2)]
    jp = [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in shards]
    jx = jnp.asarray(x.numpy())
    pos = torch.full((B,), S, dtype=torch.int64)
    for mode, xin, jin in (("prefill", x, jx),
                           ("decode", x[:, -1:] * 0.5,
                            jx[:, -1:] * 0.5)):
        ctx = LayerCtx(mode=mode, pos=pos if mode == "decode" else None)
        got = blocks.apply_layer_tp(cfg, shards, xin, ctx, slots)
        jctx = jblocks.LayerCtx(mode=mode, pos=jnp.full((B,), S, jnp.int32)
                                if mode == "decode" else None)
        attn_fn = jblocks._attn_decode if mode == "decode" \
            else jblocks._attn_train
        xn = jlayers.rms_norm(jin, jp[0]["ln1"], eps=cfg.norm_eps)
        att = 0.0
        for t in range(2):
            a, jslots[t] = attn_fn(jcfg, jp[t], xn, jctx, jslots[t])
            att = att + a
        x2 = jin + att
        xn2 = jlayers.rms_norm(x2, jp[0]["ln2"], eps=cfg.norm_eps)
        want = np.asarray(x2 + sum(jblocks._mlp_dense(jcfg, jp[t], xn2)
                                   for t in range(2)))
        assert float(np.abs(got.numpy() - want).max()) <= \
            1e-5 * np.abs(want).max(), mode
        for t in range(2):
            for i in range(2):
                np.testing.assert_allclose(
                    slots[t]["kv_full"][i].numpy(),
                    np.asarray(jslots[t]["kv_full"][i]), rtol=1e-5,
                    atol=1e-5 * float(np.abs(jslots[t]["kv_full"][i]).max()))
    if kv % 2:                              # one copy, shard 0 wrote it
        assert slots[1]["kv_full"][0] is slots[0]["kv_full"][0]


def test_merge_decode_partials_equals_whole_sequence():
    """The logsumexp merge of three sequence shards' partials (one holding
    no live position for a row) equals decode_attend over the whole cache,
    the port's and the JAX package's; one part is decode_attend itself."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    pos = np.array([5, 17, 23])
    gpos = np.arange(24)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos, tg = torch.from_numpy(pos), torch.from_numpy(gpos)
    whole = attn.decode_attend(tq, tk, tv, tg, tpos)
    parts = [attn.decode_partial(tq, tk[:, a:a + 8], tv[:, a:a + 8],
                                 tg[a:a + 8], tpos) for a in (0, 8, 16)]
    merged = attn.merge_decode_partials(parts, tq)
    assert float((merged - whole).abs().max()) < 1e-6
    jw = jattn.decode_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(gpos), jnp.asarray(pos))
    assert float(np.abs(merged.numpy() - np.asarray(jw)).max()) < 1e-6
    one = attn.merge_decode_partials(parts[:1], tq)
    assert torch.equal(one, attn.decode_attend(tq, tk[:, :8], tv[:, :8],
                                               tg[:8], tpos))


# ---------------------------------------------------------------------------
# the serve surface
# ---------------------------------------------------------------------------
def _watch_margins(monkeypatch):
    """Every greedy pick's top-2 margin, of generate() and the Scheduler."""
    seen = []

    def margin(row):
        top = np.partition(np.asarray(row, np.float32), -2)[-2:]
        seen.append(float(top[1] - top[0]))

    pick = engine_mod._pick

    def watched(logits, temperature, seed):
        for row in logits:
            margin(row.numpy())
        return pick(logits, temperature, seed)

    monkeypatch.setattr(engine_mod, "_pick", watched)
    monkeypatch.setattr(Scheduler, "_pick_one", lambda self, row, rid, k: (
        margin(row), int(np.argmax(row)))[1])
    return seen


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_generate_spmd_matches_ref_backend(arch, monkeypatch):
    """tests/test_serve.py:149-162: the pipelined serve steps on a 1x1x1
    mesh give the greedy tokens of the JAX package's threads (forward_ref)
    Engine and of the port's, from the same weights; every pick's margin
    above the logits' tolerance (T3)."""
    cfg, jcfg = _small(arch, stages=1, tp=1)
    jp, tp = (rwkv_params(jcfg)[:2] if arch == "rwkv6-3b"
              else dense_params(jcfg))
    sv = dict(prompt_len=8, gen=4, max_batch=2)
    prompts = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(
        np.int32)
    want = JEngine(JPlan(arch=jcfg, serve=JServeSpec(**sv)),
                   params=jp).generate(jnp.asarray(prompts)).tokens
    seen = _watch_margins(monkeypatch)
    spmd = Engine(Plan(arch=cfg, serve=ServeSpec(**sv),
                       partition=PartitionSpec(stages=1, tp=1, data=1),
                       run=RunSpec(backend="spmd")),
                  params=tp, device="cpu").generate(prompts)
    ref = Engine(Plan(arch=cfg, serve=ServeSpec(**sv)), params=tp,
                 device="cpu").generate(prompts)
    assert min(seen) > LOGIT_TOL
    np.testing.assert_array_equal(spmd.tokens, np.asarray(want))
    np.testing.assert_array_equal(ref.tokens, spmd.tokens)
    assert spmd.backend == "spmd" and ref.backend == "threads"


@pytest.mark.parametrize("arch,over", [
    ("gemma3-1b", {"num_layers": 6, "num_kv_heads": 1}),  # Y3, rope global
    ("hymba-1.5b", {"num_layers": 4}),     # the SSD branch whole on a stage
    ("granite-moe-1b-a400m", {"num_layers": 4, "capacity_factor": 8.0}),
])
def test_spmd_scheduler_equals_threads(arch, over, monkeypatch):
    """The families the JAX parity streams leave out, on a (1, 2, 2) mesh:
    the spmd Engine's paged Scheduler streams (and generate()) equal the
    threads Engine's from the same port weights, margins above 1e-4."""
    cfg = reduced(ARCHS[arch], stages=2, tp=2, num_microbatches=2,
                  window_size=6 if ARCHS[arch].window_size else 0, **over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(5))
    for k in ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo"):
        if k in params["blocks"]:
            params["blocks"][k] = params["blocks"][k] * 20.0
    params["embed"] = params["embed"] * 20.0
    sv = ServeSpec(prompt_len=8, gen=5, max_batch=4, page_size=4)
    spmd = Plan(arch=cfg, serve=sv, run=RunSpec(backend="spmd"),
                partition=PartitionSpec(stages=2, tp=2, data=1))
    rng = np.random.default_rng(9)
    reqs = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9)),
                             dtype=np.int32), int(rng.integers(1, 6)))
            for i in range(6)]
    seen = _watch_margins(monkeypatch)
    outs = [Scheduler(Engine(p, params=params, device="cpu")).run(
        [Request(i, pr.copy(), n) for i, pr, n in reqs])
        for p in (spmd, spmd.replace(run=RunSpec(),
                                     partition=PartitionSpec()))]
    gens = [Engine(p.replace(serve=dataclasses.replace(sv, page_size=0)),
                   params=params, device="cpu").generate().tokens
            for p in (spmd, spmd.replace(run=RunSpec(),
                                         partition=PartitionSpec()))]
    assert min(seen) > LOGIT_TOL
    assert [r.tokens for r in outs[0].requests] == \
        [r.tokens for r in outs[1].requests]
    assert outs[0].peak_pages == outs[1].peak_pages
    np.testing.assert_array_equal(gens[0], gens[1])


def test_serve_plan_validation_spmd():
    """tests/test_serve.py:79-88's spmd cases: one replica on the mesh,
    serving shapes refused on a train Plan; the host-level topology knob
    refused on spmd serve as on spmd training."""
    cfg, _ = _small("qwen3-0.6b")
    sv = ServeSpec(prompt_len=8, gen=4, max_batch=2)
    with pytest.raises(ValueError, match="data-parallel serve"):
        Plan(arch=cfg, serve=sv, run=RunSpec(backend="spmd"),
             partition=PartitionSpec(stages=2, tp=1, data=2, devices=4))
    with pytest.raises(ValueError, match="serving\\s+shape"):
        Plan(arch=cfg, shape=ShapeConfig("x", 64, 8, "decode"),
             run=RunSpec(backend="spmd", batch=8, seq=64),
             partition=PartitionSpec(stages=2, tp=1, data=1, devices=2))
    from repro_torch.api import ClusterSpec
    with pytest.raises(ValueError, match="topology"):
        Plan(arch=cfg, serve=sv, run=RunSpec(backend="spmd"),
             cluster=ClusterSpec(topology="2node"))
    plan = Plan(arch=cfg, serve=sv, run=RunSpec(backend="spmd"),
                partition=PartitionSpec(stages=2, tp=1, data=1))
    assert "backend=spmd" in plan.describe()


def test_serve_spmd_preset_builds_and_runs():
    """tests/test_serve.py:296-297, run: the (1, 2, 1) mesh over 2 layers
    serves generate() and the Scheduler."""
    plan = get_preset("serve_spmd")
    assert plan.run.backend == "spmd" and plan.serve is not None
    assert (plan.partition.data, plan.stages, plan.tp) == (1, 2, 1)
    eng = Engine(plan, device="cpu")
    rep = eng.generate()
    assert rep.backend == "spmd" and rep.tokens.shape == (4, 8)
    out = Scheduler(eng).run([Request(i, np.arange(3 + i, dtype=np.int32),
                                      4) for i in range(6)])
    assert out.tokens_out == 24 and out.backend == "spmd"


def test_serve_cli_spmd_backend(capsys):
    """The serve CLI's --backend spmd --mesh on the CPU, generate() and
    the Scheduler; --replicas stays threads-only."""
    from repro_torch.launch import serve as cli
    cli.main(["--backend", "spmd", "--mesh", "1,2,2", "--device", "cpu",
              "--gen", "4", "--devices", "4"])
    cli.main(["--backend", "spmd", "--mesh", "1,2,2", "--device", "cpu",
              "--requests", "4", "--page-size", "4", "--gen", "4"])
    out = capsys.readouterr().out
    assert out.count("backend=spmd") == 2 and "changes nothing" in out
    with pytest.raises(SystemExit, match="threads-backend only"):
        cli.main(["--backend", "spmd", "--device", "cpu", "--requests", "4",
                  "--replicas", "2,2"])
