"""The port's pipelined serve steps against the JAX package's (the
counterpart of tests/test_system.py's decode case, tests/pipeline_equiv_main.py,
and of tests/test_serve.py::test_serve_parity_on_pipelined_mesh,
tests/serve_parity_main.py).

JAX's shard_map needs 8 host devices, fixed at the first jax import, so
this file runs itself once as a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8. The subprocess writes
to an .npz, from the same seeded weights (JAX's init, the block matrices
scaled so greedy streams do not repeat one token):

  decode   gemma3-1b (6 layers: a global layer beside the windowed ones,
           KV 1 kept whole over tp) on a (2, 2, 2) mesh, 16 rows (the
           batch split over data): a forward_ref prefill of 31 tokens, then
           JAX's build_decode_step in both schedules — the prefilled cache,
           the inputs and the logits;
  merge    qwen3-0.6b on (2, 2, 2) at 8 rows: the contiguous cache's
           sequence split over the two data slots, each slot's attention
           partial merged by logsumexp (JAX's pmax / psum over data);
  streams  qwen3-0.6b, h2o-danube-1.8b and rwkv6-3b on a (1, 2, 2) mesh
           through JAX's spmd Engine: generate(), the Scheduler over the
           contiguous-degenerate pool, over 4-token pages, and with shared
           prefixes — tokens, the memory counters and CacheStore.stats().

The port then runs the same on its meshes of CPU slots: decode logits
within 1e-4 of JAX's in f32 (JAX's own bound against its oracle is 1e-3;
the two f32 pipelines differ by rounding only, ~1e-6), the overlap schedule
bit-identical to the baseline's in both packages, greedy streams identical
after asserting every pick's top-2 margin exceeds that 1e-4 (trap T3), and
the counters and stats equal.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 PYTHONPATH=src \\
        python tests/test_torch_spmd_serve_parity.py OUT.npz
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(stages=2, tp=2, num_layers=4, num_microbatches=2)
DECODE = {"decode": ("gemma3-1b", {"num_layers": 6}, 32, 16),
          "merge": ("qwen3-0.6b", {}, 32, 8)}
STREAM_ARCHS = ("qwen3-0.6b", "h2o-danube-1.8b", "rwkv6-3b")
PROMPT, GEN, B = 8, 6, 4
SCALE = 20.0
DENSE_MATS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo")
RWKV_MATS = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")
LOGIT_TOL = 1e-4
COUNTERS = ("tokens_out", "prefill_calls", "decode_steps", "pages_total",
            "peak_pages", "prefix_hit_tokens", "pages_shared")
STATS = ("page_size", "pages_total", "pages_in_use", "page_bytes",
         "pool_bytes", "slot_state_bytes")


def _cfg(reduced, archs, name, **over):
    kw = dict(CUT)
    if archs[name].attn_type == "swa":
        kw["window_size"] = 6            # < max_len: the ring wraps
    kw.update(over)
    return reduced(archs[name], **kw)


def _scaled(host, rwkv, seed=0):
    """JAX's init (numpy) with the block matrices scaled (RWKV6: also a
    drawn decay LoRA, mixes and bonus, as tests/test_torch_rwkv6.py), and
    the embedding and head too, so the logits spread over units and a
    greedy pick's top-2 margin sits far above the 1e-4 logit tolerance."""
    rng = np.random.default_rng(seed)
    blocks = {}
    for name, a in host["blocks"].items():
        a = np.asarray(a, np.float32)
        if name in (RWKV_MATS if rwkv else DENSE_MATS):
            a = a * SCALE
        elif rwkv and name in ("wa", "wb"):
            a = 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        elif rwkv and (name.startswith(("mu_", "cm_mu_")) or name == "u"):
            a = rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        blocks[name] = a
    return dict({k: np.asarray(v, np.float32) * (
        SCALE if k in ("embed", "head") else 1.0)
        for k, v in host.items() if k != "blocks"}, blocks=blocks)


def _flat(tree, prefix=""):
    """{path: array} of nested dicts / K-V pairs, paths joined by '/'."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, (tuple, list)):
            out.update({f"{prefix}{k}/{i}": np.asarray(x)
                        for i, x in enumerate(v)})
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat, prefix):
    """The nested dicts of _flat under `prefix` (pairs come back as
    dicts keyed '0' / '1')."""
    out = {}
    for path, v in flat.items():
        if not path.startswith(prefix):
            continue
        *heads, leaf = path[len(prefix):].split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def _requests(vocab, seed):
    """serve_parity_main's mix: 2B requests of PROMPT tokens with budgets
    2..GEN, and the shared-prefix variant (every even rid repeats rid 0's
    prompt): [(rid, prompt, budget)] twice."""
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, vocab, PROMPT, dtype=np.int32),
             int(rng.integers(2, GEN + 1))) for i in range(2 * B)]
    shared = [(i, (reqs[0] if i % 2 == 0 else reqs[i])[1].copy(), m)
              for i, _, m in reqs]
    return reqs, shared


def _padded(requests):
    """[n, GEN] int32 tokens of a report's requests (-1 past each one's)."""
    out = np.full((len(requests), GEN), -1, np.int32)
    for i, r in enumerate(requests):
        out[i, :len(r.tokens)] = r.tokens
    return out


def jax_side(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.api import Engine, PartitionSpec, Plan, RunSpec, ServeSpec
    from repro.api.serving import Request, Scheduler
    from repro.compat import set_mesh
    from repro.configs import ARCHS, RunConfig, ShapeConfig, reduced
    from repro.core import wave
    from repro.launch.mesh import make_mesh_auto
    from repro.models import lm

    assert len(jax.devices()) >= 8, jax.devices()
    rec = {}
    mesh = make_mesh_auto((2, 2, 2), ("data", "stage", "tp"))
    key = jax.random.PRNGKey(0)
    for tag, (arch, over, S, Bd) in DECODE.items():
        cfg = _cfg(reduced, ARCHS, arch, **over)
        jp, pspecs = lm.init_params(cfg, key)
        host = _scaled(jax.device_get(jp), False)
        params = jax.tree.map(jnp.asarray, host)
        full = jax.random.randint(key, (Bd, S), 0, cfg.vocab_size,
                                  dtype=jnp.int32)
        cache = lm.init_cache(cfg, Bd, S, dtype=jnp.float32)
        _, cache, _ = lm.forward_ref(cfg, params, full[:, :S - 1],
                                     mode="prefill", cache=cache)
        rec.update({f"{tag}/params/{k}": v for k, v in _flat(host).items()})
        rec.update({f"{tag}/cache/{k}": v for k, v in _flat(
            jax.device_get(cache)).items()})
        rec[f"{tag}/inputs"] = np.asarray(full)
        with set_mesh(mesh):
            p_sh = jax.device_put(params, jax.tree.map(
                lambda s: NamedSharding(mesh, s), pspecs,
                is_leaf=lambda x: isinstance(x, P)))
        for overlap in (False, True):
            run = RunConfig(arch=cfg, shape=ShapeConfig(tag, S, Bd,
                                                         "decode"),
                            compute_dtype="float32", overlap=overlap)
            step, _, _ = wave.build_decode_step(run, mesh)
            with set_mesh(mesh):
                logits, _ = jax.jit(step)(p_sh, {
                    "inputs": full[:, S - 1:],
                    "cache": jax.tree.map(lambda a: a.copy(), cache),
                    "pos": jnp.int32(S - 1)})
            rec[f"{tag}/logits/{int(overlap)}"] = np.asarray(logits)

    for arch in STREAM_ARCHS:
        cfg = _cfg(reduced, ARCHS, arch)
        jp, _ = lm.init_params(cfg, key)
        host = _scaled(jax.device_get(jp), arch == "rwkv6-3b")
        rec.update({f"{arch}/params/{k}": v for k, v in _flat(host).items()})
        params = jax.tree.map(jnp.asarray, host)
        serve = ServeSpec(prompt_len=PROMPT, gen=GEN, max_batch=B)
        spmd = Plan(arch=cfg, serve=serve, run=RunSpec(backend="spmd"),
                    partition=PartitionSpec(stages=2, tp=2, data=1))
        prompts = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        rec[f"{arch}/prompts"] = prompts
        rec[f"{arch}/generate"] = np.asarray(Engine(spmd, params=params)
                                             .generate(prompts).tokens)
        reqs, shared = _requests(cfg.vocab_size, 11)
        for tag, sv, rq in (
                ("sched", serve, reqs),
                ("paged", dataclasses.replace(serve, page_size=4), reqs),
                ("shared", dataclasses.replace(serve, page_size=4,
                                               share_prefix=True), shared)):
            eng = Engine(spmd.replace(serve=sv), params=params)
            out = Scheduler(eng).run([Request(i, p.copy(), m)
                                      for i, p, m in rq])
            rec[f"{arch}/{tag}/tokens"] = _padded(out.requests)
            rec[f"{arch}/{tag}/rids"] = np.array([r.rid for r in
                                                  out.requests])
            for c in COUNTERS:
                rec[f"{arch}/{tag}/{c}"] = np.int64(getattr(out, c))
            stats = eng.serve_store().stats()
            for c in STATS:
                rec[f"{arch}/{tag}/stats/{c}"] = np.int64(stats[c])
    np.savez(out_path, **rec)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve") / "jax_serve.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out)], capture_output=True, text=True,
                       timeout=900, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with np.load(out) as z:
        return dict(z)


def _port_cache(flat):
    """The JAX cache (numpy, pairs keyed '0' / '1') as the port's tree."""
    import torch
    return {k: (tuple(torch.from_numpy(v[i].copy()) for i in ("0", "1"))
                if isinstance(v, dict) else torch.from_numpy(v.copy()))
            for k, v in flat.items()}


@pytest.mark.parametrize("tag", sorted(DECODE))
def test_pipelined_decode_equals_jax(rec, tag):
    """build_decode_step on a (2, 2, 2) mesh of CPU slots from JAX's
    prefilled cache: logits within 1e-4 of JAX's (decode: the batch split
    over data, gemma3's global and windowed layers, KV whole over tp;
    merge: each data slot's partial over its half of the sequence), and
    the overlap schedule bit-identical to the baseline in both packages."""
    import torch

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced
    from repro_torch.core import wave
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.serve import cache as cache_lib

    arch, over, S, Bd = DECODE[tag]
    cfg = _cfg(reduced, ARCHS, arch, **over)
    params = lm.params_from_numpy(_unflat(rec, f"{tag}/params/"),
                                  device="cpu")
    mesh = make_test_mesh(2, 2, 2, devices="cpu")
    inputs = torch.from_numpy(rec[f"{tag}/inputs"][:, S - 1:])
    got = {}
    for overlap in (False, True):
        run = RunConfig(arch=cfg, shape=ShapeConfig(tag, S, Bd, "decode"),
                        compute_dtype="float32", overlap=overlap)
        step, _, cspecs = wave.build_decode_step(run, mesh)
        caches = cache_lib.shard_cache(
            cfg, _port_cache(_unflat(rec, f"{tag}/cache/")), mesh, cspecs)
        with torch.inference_mode():
            got[overlap], _ = step(params, {"inputs": inputs,
                                            "cache": caches, "pos": S - 1})
        want = rec[f"{tag}/logits/{int(overlap)}"]
        d = float(np.abs(got[overlap].numpy() - want).max())
        assert d < LOGIT_TOL, (tag, overlap, d)
    if tag == "merge":
        assert cspecs["kv_full"][0][2] == "data"      # the sequence split
    assert torch.equal(got[True], got[False])
    assert np.array_equal(rec[f"{tag}/logits/1"], rec[f"{tag}/logits/0"])


class _Margins:
    """Records every greedy pick's top-2 logit margin (trap T3)."""

    def __init__(self):
        self.seen = []

    def row(self, row):
        top = np.partition(np.asarray(row, np.float32), -2)[-2:]
        self.seen.append(float(top[1] - top[0]))


@pytest.mark.parametrize("arch", STREAM_ARCHS)
def test_spmd_serve_streams_equal_jax(rec, arch, monkeypatch):
    """The port's spmd Engine on a (1, 2, 2) mesh of CPU slots, from JAX's
    weights: generate() and the Scheduler (contiguous-degenerate, paged,
    shared-prefix) give JAX's spmd Engine's greedy streams, with every
    pick's margin above LOGIT_TOL, and the same memory counters and
    CacheStore.stats()."""
    import torch

    from repro_torch.api import Engine, PartitionSpec, Plan, RunSpec, \
        ServeSpec
    from repro_torch.api import engine as engine_mod
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import lm

    cfg = _cfg(reduced, ARCHS, arch)
    params = lm.params_from_numpy(_unflat(rec, f"{arch}/params/"),
                                  device="cpu")
    margins = _Margins()
    pick = engine_mod._pick

    def watched(logits, temperature, seed):
        for row in logits:
            margins.row(row.numpy())
        return pick(logits, temperature, seed)

    monkeypatch.setattr(engine_mod, "_pick", watched)
    monkeypatch.setattr(Scheduler, "_pick_one", lambda self, row, rid, k: (
        margins.row(row), int(np.argmax(row)))[1])
    serve = ServeSpec(prompt_len=PROMPT, gen=GEN, max_batch=B)
    spmd = Plan(arch=cfg, serve=serve, run=RunSpec(backend="spmd"),
                partition=PartitionSpec(stages=2, tp=2, data=1))
    rep = Engine(spmd, params=params, device="cpu").generate(
        torch.from_numpy(rec[f"{arch}/prompts"]))
    assert rep.backend == "spmd"
    assert min(margins.seen) > LOGIT_TOL
    np.testing.assert_array_equal(rep.tokens, rec[f"{arch}/generate"])
    reqs, shared = _requests(cfg.vocab_size, 11)
    for tag, sv, rq in (
            ("sched", serve, reqs),
            ("paged", dataclasses.replace(serve, page_size=4), reqs),
            ("shared", dataclasses.replace(serve, page_size=4,
                                           share_prefix=True), shared)):
        margins.seen.clear()
        eng = Engine(spmd.replace(serve=sv), params=params, device="cpu")
        out = Scheduler(eng).run([Request(i, p.copy(), m)
                                  for i, p, m in rq])
        assert min(margins.seen) > LOGIT_TOL, (tag, min(margins.seen))
        assert [r.rid for r in out.requests] == \
            rec[f"{arch}/{tag}/rids"].tolist()
        np.testing.assert_array_equal(_padded(out.requests),
                                      rec[f"{arch}/{tag}/tokens"])
        for c in COUNTERS:
            assert getattr(out, c) == int(rec[f"{arch}/{tag}/{c}"]), (tag, c)
        stats = eng.serve_store().stats()
        for c in STATS:
            assert stats[c] == int(rec[f"{arch}/{tag}/stats/{c}"]), (tag, c)
    if cfg.attn_type == "full":
        assert int(rec[f"{arch}/shared/prefix_hit_tokens"]) > 0
        assert int(rec[f"{arch}/paged/pages_total"]) > B


if __name__ == "__main__":
    jax_side(sys.argv[1])
