"""granite-4.0-h-small's port (Mamba-2 and NoPE attention layers, the
expert share, the shared expert, the cache of two kinds of state) against
the benchmark's plain reference, hetbench/reference/granite4h.py, at a
tiny size on the CPU: prefill, then decode through the cache, logits and
states compared; the expert shares against the uncut layer; the cache's
layout; ssd_chunked at state 128; the SSD cost; the parameter count."""
import ast
import dataclasses
import math

import numpy as np
import pytest
import torch

from hetbench import families, weights
from hetbench.reference import granite4h as ref
from hetbench.reference import prec
from repro_torch.api import Engine
from repro_torch.api.plan import Plan, RunSpec, ServeSpec
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import ref as kref
from repro_torch.kernels.mamba_ssd import _route, ssd_chunked
from repro_torch.models import blocks, lm
from repro_torch.models.blocks import LayerCtx
from repro_torch.obs import Tracer
from repro_torch.serve import cache as cache_lib

FAM = families.load("granite4h")
TYPES = ("mamba", "attention", "mamba", "mamba")
TINY = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=32, vocab_size=250, num_experts=8, top_k=3,
            shared_ff=48, ssm_state=8, ssm_heads=4, layer_types=TYPES)


def _cfg(**over):
    return dataclasses.replace(get_arch("granite-4.0-h-small"),
                               **dict(TINY, **over))


def _z(cfg):
    f = {k: getattr(cfg, k) for k in (
        "num_layers", "d_model", "d_ff", "vocab_size", "tie_embeddings",
        "norm_eps", "num_heads", "num_kv_heads", "head_dim", "num_experts",
        "experts_held", "expert_offset", "top_k", "capacity_factor",
        "shared_ff", "ssm_state", "ssm_heads", "ssm_expand")}
    f["layer_types"] = list(cfg.layer_types)
    f["experts_held"] = cfg.held_experts
    return weights.sizes({"family": "granite4h", "port": {"fields": f}}, FAM)


def _rel(a, b):
    b = b.float()
    return float((a.float() - b).square().mean().sqrt()
                 / b.square().mean().sqrt())


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("held", [(8, 0), (4, 4)])
def test_prefill_then_decode_match_the_reference(backend, held):
    """Engine.prefill_into then three Engine.decode steps over the paged
    pool and the per-slot Mamba state (f32 on the CPU) against the plain
    reference's prefill and decode from the same cache: logits, the
    attention layers' K/V and the Mamba layers' state."""
    cfg = _cfg(experts_held=held[0], expert_offset=held[1])
    z = _z(cfg)
    W = FAM.make(z, 7, dtype=torch.float32, device="cpu")
    B, P = 3, 12
    plan = Plan(arch=cfg, run=RunSpec(compute_dtype="float32"),
                serve=ServeSpec(prompt_len=P, gen=4, max_batch=B,
                                page_size=4, kernel_backend=backend))
    eng = Engine(plan, params=W, device="cpu")
    store = eng.serve_store()
    rng = np.random.default_rng(3)
    lens = np.array([5, 12, 9])
    toks = np.zeros((B, P), np.int32)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, cfg.vocab_size, n)
    slots = [2, 0, 1]
    for s, n in zip(slots, lens):
        store.alloc(s, int(n) + 4)
    logits = eng.prefill_into(store, toks, lens, slots)
    rows = [0, 1, 2]
    with prec.exact_f32():
        want, kv, st = ref.prefill(z, W, torch.as_tensor(toks),
                                   torch.as_tensor(lens), prec.Prec(), rows)
    assert _rel(logits, want) < 1e-4
    state = store.tree["ssm_state"][:, slots]
    assert _rel(state, torch.stack([st[l][0] for l in sorted(st)])) < 1e-4
    tab = store.tree["block_tab"]
    kp, vp = store.tree["kv_full"]
    (l_attn,) = kv
    for j, s in enumerate(slots):
        n = int(lens[j])
        got = kp[0][tab[s, :-(-n // 4)].long()].reshape(-1, 2, 16)[:n]
        assert _rel(got, kv[l_attn][0][j, :n]) < 1e-4
    # decode through the cache, the slots in store order
    order = np.argsort(slots)
    pos = torch.as_tensor(lens[order], dtype=torch.long)
    nxt = logits[order].argmax(-1)
    for _ in range(3):
        before = {k: store.tree[k].clone() for k in ("ssm_state",
                                                     "conv_tail")}
        tab = store.tree["block_tab"].clone()
        got, _ = eng.decode(nxt[:, None], store, pos)
        with prec.exact_f32():
            want, nk, nv, st = ref.decode(
                z, W, nxt, pos, tab, kp, vp, before["ssm_state"],
                before["conv_tail"], prec.Prec(), [0, 1, 2])
        assert _rel(got, want) < 1e-4
        assert _rel(store.tree["ssm_state"],
                    torch.stack([st[l][0] for l in sorted(st)])) < 1e-4
        page = tab[torch.arange(B), pos // 4].long()
        assert _rel(kp[0, page, pos % 4], nk[0]) < 1e-4
        assert _rel(vp[0, page, pos % 4], nv[0]) < 1e-4
        nxt, pos = got.argmax(-1), pos + 1


def test_expert_shares_sum_to_the_uncut_layer():
    """The FFN of the two cards' shares (experts 0-3 and 4-7 of 8, each
    routing over all 8 with the capacity of all 8), the shared expert
    counted once, adds up to the uncut layer's, the port's and the plain
    reference's."""
    whole = _cfg()
    W = FAM.make(_z(whole), 11, dtype=torch.float32, device="cpu")
    p = lm.layer_leaves(whole, {k: v.unbind(0) for k, v in
                                W["blocks"].items()}, 1)
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(1))
    ctx = LayerCtx(mode="prefill")
    full = blocks._mlp(whole, p, x, ctx)
    shared = blocks._mlp_dense(whole, {"mlp_wi": p["shared_wi"],
                                       "mlp_wo": p["shared_wo"]}, x)
    parts = []
    for lo in (0, 4):
        cut = _cfg(experts_held=4, expert_offset=lo)
        q = dict(p, moe_w_in=p["moe_w_in"][lo:lo + 4],
                 moe_w_out=p["moe_w_out"][lo:lo + 4])
        parts.append(blocks._mlp(cut, q, x, ctx))
    torch.testing.assert_close(parts[0] + parts[1] - shared, full,
                               rtol=1e-5, atol=1e-6)
    z = _z(whole)
    with prec.exact_f32():
        want = ref.moe_share(z, p, x.reshape(14, 64), prec.Prec()) + \
            ref.shared(z, p, x.reshape(14, 64), prec.Prec())
    torch.testing.assert_close(full.reshape(14, 64), want, rtol=1e-5,
                               atol=1e-6)


def test_cache_holds_each_kind_of_state_for_its_layers_only():
    """K/V groups and pages for the attention layers, Mamba state and conv
    tails for the Mamba layers, counted as the slots' fixed state; a
    one-kind model's SSM state still covers every layer."""
    cfg = _cfg()
    shapes, _ = cache_lib.cache_struct(cfg, 3, 16, dtype=torch.float32)
    assert shapes["kv_full"][0][0][0] == 1
    assert shapes["ssm_state"][0][:2] == (3, 3)
    assert shapes["conv_tail"] == ((3, 3, 3, 128 + 16), torch.float32)
    hymba = dataclasses.replace(ARCHS["hymba-1.5b"], num_layers=4, stages=2)
    assert cache_lib.cache_struct(hymba, 2, 8)[0]["ssm_state"][0][0] == 4
    store = cache_lib.CacheStore(cfg, cache_lib.make_layout(
        3, 16, page_size=4), dtype=torch.float32)
    st = store.stats()
    assert store.ssm_state_bytes == st["slot_state_bytes"] == \
        4 * 3 * 3 * (4 * 8 * 32) + 4 * 3 * 3 * 3 * 144
    assert st["page_bytes"] == 2 * 1 * 4 * 2 * 16 * 4    # K and V, 1 layer
    assert full_kv_groups(get_arch("granite-4.0-h-small")) == 4


def full_kv_groups(cfg):
    return cache_lib.cache_struct(cfg, 1, 16)[0]["kv_full"][0][0][0]


def test_admission_resets_a_slots_state():
    """A slot whose previous occupant left state behind holds exactly a
    fresh request's state after its admission, and the Scheduler counts
    the reset and the state's bytes."""
    cfg = _cfg()
    plan = Plan(arch=cfg, run=RunSpec(compute_dtype="float32"),
                serve=ServeSpec(prompt_len=8, gen=4, max_batch=2,
                                page_size=4, kernel_backend="ref"))
    eng = Engine(plan, device="cpu")
    prompt = np.arange(1, 7, dtype=np.int32)
    stores = []
    for dirty in (False, True):
        store = eng.serve_store()
        if dirty:
            store.tree["ssm_state"].normal_()
            store.tree["conv_tail"].normal_()
        store.alloc(1, 10)
        toks = np.zeros((2, 8), np.int32)
        toks[0, :6] = prompt
        eng.prefill_into(store, toks, np.array([6, 1]), [1])
        stores.append(store)
    for k in ("ssm_state", "conv_tail"):
        torch.testing.assert_close(stores[1].tree[k][:, 1],
                                   stores[0].tree[k][:, 1])
    assert stores[1].ssm_resets == 1
    tr = Tracer()
    rep = Scheduler(Engine(plan, params=eng._params, tracer=tr,
                           device="cpu")).run(
        [Request(rid=i, prompt=prompt[:3 + i], max_new_tokens=2)
         for i in range(3)])
    assert rep.ssm_resets == 3
    assert rep.ssm_state_bytes == stores[0].ssm_state_bytes
    snap = tr.metrics.snapshot()
    assert snap["counters"]["serve/ssm_resets"] == 3
    assert snap["gauges"]["serve/ssm_state_bytes"] == rep.ssm_state_bytes
    names = {e[2] for e in tr.events() if e[0] == "X" and e[1] == "engine"}
    assert {"ssd_prefill", "ssd_state_update"} <= names


@pytest.mark.parametrize("N,route", [(128, "tile"), (16, "tile")])
def test_ssd_chunked_takes_state_128_on_the_cpu(N, route):
    """The wrapper takes (P, N) = (64, 128) and runs ssd_ref on the CPU
    (the kernel has no CPU build: tests/test_torch_cuda.py and
    chip_smoke.py hold it at the cell's shapes on the card, where the
    model's views take the tile route at state 128 as at 16, with a tiling
    of its own: one row, 2 heads and all 64 state columns a block). Its output, y and the final state, equals SSD's quadratic
    form, computed here apart from the sequential scan: y_t = sum_{s <= t}
    exp(sum_{s < r <= t} dt_r a) (C_t . B_s) dt_s x_s, a row's tail past
    its length (dt = 0) leaving its state where it was."""
    B, H, S, P = 2, 3, 70, 64
    g = torch.Generator().manual_seed(N)
    conv = torch.randn(B, S, H * P + 2 * N, generator=g)
    x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = torch.rand(B, S, H, generator=g).transpose(1, 2) * 0.1
    dt[1, :, 40:] = 0.0
    a = -torch.linspace(1, 16, H)
    y, h = ssd_chunked(x, dt, Bm, Cm, a)
    yr, hr = kref.ssd_ref(x, dt, Bm, Cm, a)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    assert _route(x, Bm, Cm) == route
    c = torch.cumsum(dt * a[None, :, None], -1)                 # [B, H, S]
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    decay = (c[..., :, None] - c[..., None, :]).masked_fill(
        ~causal, float("-inf")).exp()                          # [B, H, t, s]
    cb = torch.einsum("btn,bsn->bts", Cm, Bm)
    yq = torch.einsum("bhts,bts,bhs,bhsp->bhtp", decay, cb, dt, x)
    hq = torch.einsum("bhs,bhs,bsn,bhsp->bhnp", (c[..., -1:] - c).exp(), dt,
                      Bm, x)
    torch.testing.assert_close(y, yq, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hq, atol=1e-4, rtol=1e-4)
    _, hcut = kref.ssd_ref(x[1:, :, :40], dt[1:, :, :40], Bm[1:, :40],
                              Cm[1:, :40], a)
    torch.testing.assert_close(h[1:], hcut, atol=1e-5, rtol=1e-5)


def test_ssd_cost_at_state_128():
    """The benchmark's ssd_chunked count at N 128: C B^T once per chunk
    for every head, each head's triangle, read-out and update; f32 bytes
    of x, dt, B, C in, y and the final state out. Bound by FLOPs."""
    z = _z(get_arch("granite-4.0-h-small"))
    H, N, P = 128, 128, 64
    flops, nbytes = FAM.ssd_chunked(z, [100])
    want = sum(2 * (n * (n + 1) // 2) * N + H * (
        2 * (n * (n + 1) // 2) * P + 4 * n * N * P) for n in (64, 36))
    assert flops == want
    assert nbytes == 4 * (2 * H * 100 * P + H * 100 + 2 * 100 * N
                          + H * N * P)
    assert flops / 67e12 > nbytes / 3.35e12
    assert FAM.ssd_bound_s(z, [100]) == pytest.approx(36 * flops / 67e12)


def test_param_count_by_layer_kind():
    """32.2 B parameters as published; this card's share 18.6 B; a tiny
    config's count equals its parameter tree (less the vocabulary pad)."""
    full = get_arch("granite-4.0-h-small")
    assert full.param_count() == 32_207_333_888
    share = dataclasses.replace(full, experts_held=36)
    assert round(share.param_count() / 1e9, 1) == 18.6
    cfg = _cfg(experts_held=4)
    tree = lm.init_params(cfg, torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in tree["blocks"].values())
    assert cfg.param_count() == n + cfg.vocab_size * cfg.d_model
    assert tree["blocks"]["wq"].shape[0] == 1
    assert tree["blocks"]["ssd_in_proj"].shape[0] == 3
    assert tree["blocks"]["moe_w_in"].shape[:2] == (4, 4)


def test_reference_imports_no_jax_and_no_port():
    from pathlib import Path
    src = Path(ref.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert math.isclose(_z(get_arch("granite-4.0-h-small"))["K"], 10.0)


def _tiny_root(tmp_path, cell):
    """A checkout-like root holding hetbench/ and a tiny stand-in of the
    serve cell (its configuration at toy widths, its mix at toy lengths)
    under the real cell's name, with BENCHMARK.json's metrics."""
    import json
    import shutil
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    root = tmp_path / "root"
    shutil.copytree(repo / "hetbench", root / "hetbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    h = root / "hetbench"
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_p = h / "configs" / f"{spec['config']}.json"
    mix_p = h / "traffic" / f"{spec['traffic']}.json"
    cfg, mix = json.loads(cfg_p.read_text()), json.loads(mix_p.read_text())
    fields = dict(TINY, layer_types=list(TYPES), experts_held=4)
    mix.update(max_batch=4, prompt_len=16, gen=12, requests=256,
               block=8, prompt_law={"law": "loguniform", "lo": 4, "hi": 16},
               output_law={"law": "loguniform", "lo": 3, "hi": 12},
               page_size=4, profile_steps=2)
    limits = {"gap_prefill": 0.05, "logits_prefill": 0.02,
              "kv_prefill": 0.02, "state_prefill": 0.02,
              "gap_window": 0.05, "logits_window": 0.02,
              "state_window": 0.02, "logits_decode": 0.02,
              "kv_decode": 0.02, "state_decode": 0.02}
    cfg["port"]["fields"].update(fields)
    cfg_p.write_text(json.dumps(cfg))
    mix_p.write_text(json.dumps(mix))
    (h / "cells" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["granite4h-serve-chat"])
def test_new_cell_runs_tiny_on_the_cpu(tmp_path, cell, trace):
    """The new cell, at toy sizes, through the harness as the benchmark
    runs it (drivers/scheduler_hybrid.py and the granite4h family):
    correct, and a traced run reads the cell's per-layer metrics."""
    import time
    from hetbench import harness
    root = _tiny_root(tmp_path, cell)
    out = harness.run_cell(root, cell, 2 ** 31 + 77, 3.0 if trace else 2.0,
                           trace, t_process=time.monotonic(), device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert "setup_s" in out["metrics"]
    else:
        assert {"prefill_share.serve", "pages_peak_share.serve",
                "mfu.serve", "tokens_per_s.chat"} <= set(out["metrics"])
