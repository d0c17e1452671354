"""The port's dry run (repro_torch.launch.dryrun) against the JAX package's
and against the port itself.

- lm.param_shapes / lm.input_specs: the meta stand-ins match JAX's
  ShapeDtypeStructs leaf for leaf, for every arch and shape.
- A reduced cell per family (dense, RWKV6, SSD hybrid, MoE) at meshes
  (1, 2, 2) and (2, 2, 2), train / prefill / decode: the counts on meta
  (ops, FLOPs, bytes, collectives, memory) equal a CPU run of the same
  step under the same counter on backend "ref".
- A dense step's dot FLOPs equal an analytic count from the config;
  backend "cuda"'s kernel counts equal phase 25's launch formula (layers
  x tp x microbatches), all on their tensor-core route.
- The grid, the tags, the skip records and the arch fields equal JAX's.
- The symmetry shortcut (one data slot issued, the rest reckoned) equals
  the whole mesh's record on a reduced data-4 cell.
- Each kernel's cost() reproduces PERF.md §6's bound column.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import RunConfig as JRunConfig
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, SHAPES, RunConfig, ShapeConfig, reduced
from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import mamba_ssd, moe_gmm, rwkv6_scan
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import make_mesh_auto
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.serve import cache as cache_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("data", "stage", "tp")
FAMILIES = ("qwen3-0.6b", "rwkv6-3b", "hymba-1.5b", "granite-moe-1b-a400m")
KINDS = {"train": ShapeConfig("t", 16, 8, "train"),
         "prefill": ShapeConfig("p", 16, 8, "prefill"),
         "decode": ShapeConfig("d", 16, 8, "decode")}
FIELDS = ("ops", "flops", "dot_flops", "bytes_upper", "dot_bytes",
          "collectives", "link_bytes", "kernels", "slot_max", "slot0")


def _dt(x) -> str:
    return str(x.dtype).split(".")[-1]


def _tree(x):
    """A stand-in tree as {path: (shape, dtype name)}."""
    if isinstance(x, dict):
        return {f"{k}/{p}": v for k in x for p, v in _tree(x[k]).items()}
    if isinstance(x, (tuple, list)):
        return {f"{i}/{p}": v for i, y in enumerate(x)
                for p, v in _tree(y).items()}
    return {"": (tuple(x.shape), _dt(x))}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_shapes_equal_jax(arch):
    got = lm.param_shapes(ARCHS[arch])
    assert all(t.device.type == "meta" for t in dryrun._leaves(got))
    assert _tree(got) == _tree(jlm.param_shapes(J_ARCHS[arch]))
    bf = lm.param_shapes(ARCHS[arch], torch.bfloat16)
    assert _tree(bf) == _tree(jlm.param_shapes(J_ARCHS[arch], jnp.bfloat16))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_equal_jax(arch, shape):
    got = lm.input_specs(RunConfig(arch=ARCHS[arch], shape=SHAPES[shape]))
    want = jlm.input_specs(JRunConfig(arch=J_ARCHS[arch],
                                      shape=J_SHAPES[shape]))
    assert _tree(got) == _tree(want)
    assert all(t.device.type == "meta" for t in dryrun._leaves(got))


# ----------------------------------------------------------------------------
# reduced cells: meta against the CPU
# ----------------------------------------------------------------------------
def _cfg(name):
    return reduced(ARCHS[name], stages=2, tp=2, num_microbatches=2,
                   num_layers=2)


def _meta_cell(name, kind, mesh_shape, backend="ref", cfg=None):
    cfg = cfg or _cfg(name)
    run = RunConfig(arch=cfg, shape=KINDS[kind], kernel_backend=backend)
    mesh = make_mesh_auto(mesh_shape, NAMES, devices="meta")
    step, cspecs = dryrun.build_step(run, mesh)
    return step, dryrun.meta_args(run, mesh, cspecs), mesh, run


def _cpu_args(run, mesh, cspecs):
    """The step's arguments as real CPU tensors (seeded), shaped as
    meta_args's."""
    cfg = run.arch
    g = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, g)
    ins = lm.input_specs(run)

    def real(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                             dtype=t.dtype)

    if run.shape.kind == "train":
        opt = make_optimizer(run.optimizer, run.lr, run.weight_decay)
        return params, opt.init(params), {"inputs": real(ins["inputs"]),
                                          "labels": real(ins["labels"])}
    B, S = run.shape.global_batch, run.shape.seq_len
    shards = 16 if run.shape.kind == "decode" and B < 16 else 1
    _, kdt = cache_lib.serve_dtypes(run.compute_dtype, run.cache_dtype)
    cache = cache_lib.init_cache(cfg, B, S, seq_shards=shards, dtype=kdt)
    batch = {"inputs": real(ins["inputs"]),
             "cache": cache_lib.shard_cache(cfg, cache, mesh, cspecs)}
    if run.shape.kind == "decode":
        batch["pos"] = torch.tensor(S - 2, dtype=torch.int32)
    return params, batch


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (2, 2, 2)])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", FAMILIES)
def test_meta_counts_equal_a_cpu_run(name, kind, mesh_shape):
    step, args, mesh, run = _meta_cell(name, kind, mesh_shape)
    meta = dryrun.count_step(step, args, mesh, run)
    cmesh = make_mesh_auto(mesh_shape, NAMES, devices="cpu")
    cstep, cspecs = dryrun.build_step(run, cmesh)
    cpu = dryrun.count_step(cstep, _cpu_args(run, cmesh, cspecs), cmesh,
                            run)
    for f in FIELDS + ("memory",):
        assert meta[f] == cpu[f], f
    assert meta["ops"] > 0 and meta["memory"]["peak_bytes"] > 0


def _dense_dot_flops(cfg, shp, kind, remat):
    """The dense layer stack's and head's matmul FLOPs, from the config:
    the projections, the plain attention (every q x kv block computed, the
    causal mask applied after), the CE head (padded vocab); train: forward,
    the remat recompute, backward (2x: both operands' grads) and the CE
    chunks' recompute; prefill / decode: one forward and the last
    position's f32 logits."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    B, S = shp.global_batch, shp.seq_len
    Vp = lm.padded_vocab(cfg)
    T = B * (1 if kind == "decode" else S)
    proj = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d + \
        2 * T * d * 2 * ff + 2 * T * ff * d
    attn = 4 * B * H * hd * S * (1 if kind == "decode" else S)
    layers = cfg.num_layers * (proj + attn)
    if kind == "train":
        # torch.utils.checkpoint's recompute stops once it has remade every
        # tensor backward saved: a stage call's last matmul (its last tp
        # shard's mlp_wo, whose output nothing saved) is not recomputed
        last = cfg.stages * 2 * T * (ff // cfg.tp) * d
        return 3 * layers + int(remat) * (layers - last) + \
            4 * (2 * T * d * Vp)
    return layers + 2 * B * d * Vp


@pytest.mark.parametrize("kind", list(KINDS))
def test_dense_dot_flops_equal_the_analytic_count(kind):
    step, args, mesh, run = _meta_cell("qwen3-0.6b", kind, (2, 2, 2))
    rec = dryrun.count_step(step, args, mesh, run)
    assert rec["dot_flops"] == _dense_dot_flops(run.arch, run.shape, kind,
                                                run.arch.remat)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_kernel_counts_follow_the_launch_formula(kind):
    """Backend "cuda" on meta: one launch a (layer, tp shard,
    microbatch), on the tensor-core route; LAUNCHES untouched."""
    cfg = _cfg("qwen3-0.6b")
    reset_launches()
    step, args, mesh, run = _meta_cell("qwen3-0.6b", kind, (1, 2, 2),
                                       "cuda", cfg)
    rec = dryrun.count_step(step, args, mesh, run)
    name = "flash_attention_fwd" if kind == "prefill" else "flash_decode"
    nm = dryrun.wave._serve_nm(run, mesh)[0]
    n = cfg.num_layers * cfg.tp * nm
    assert rec["kernels"] == {name: {"tc": n, "flops": pytest.approx(
        rec["kernels"][name]["flops"]), "bytes": pytest.approx(
        rec["kernels"][name]["bytes"])}}
    assert rec["kernels"][name]["tc"] == n
    assert sum(LAUNCHES.values()) == 0
    assert all(v == 0 for r in ROUTES.values() for v in r.values())


@pytest.mark.parametrize("kind,batch", [("train", 16), ("prefill", 16),
                                        ("decode", 16), ("decode", 8)])
def test_symmetry_shortcut_equals_the_whole_mesh(kind, batch):
    """Data slot 0 issued, the other three reckoned: every count and each
    slot's maxima equal the whole mesh's; the modeled peak within 5%.
    Under 16 rows the decode's cache is sequence-sharded and data slot 0
    issues every slot's work: nothing is reckoned."""
    cfg = reduced(ARCHS["qwen3-0.6b"], stages=2, tp=2, num_microbatches=2,
                  num_layers=2)
    shp = dataclasses.replace(KINDS[kind], global_batch=batch)
    run = RunConfig(arch=cfg, shape=shp)
    mesh = make_mesh_auto((4, 2, 2), NAMES, devices="meta")
    recs = []
    for sym in (False, True):
        step, cspecs = dryrun.build_step(run, mesh)
        recs.append(dryrun.count_step(
            step, dryrun.meta_args(run, mesh, cspecs), mesh, run,
            symmetric=sym))
    whole, sym = recs
    reckoned = batch >= 16
    assert (whole["data_slots_issued"], sym["data_slots_issued"]) == \
        (4, 1 if reckoned else 4)
    for f in FIELDS:
        assert sym[f] == whole[f], f
    assert sym["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]
    assert sym["memory"]["peak_modeled"] == reckoned
    assert abs(sym["memory"]["peak_bytes"] - whole["memory"]["peak_bytes"]) \
        <= 0.05 * whole["memory"]["peak_bytes"]


# ----------------------------------------------------------------------------
# the grid, the tags, the skips and the arch fields against JAX's
# ----------------------------------------------------------------------------
_JAX_SKIPS = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from repro.configs import ARCHS, SHAPES, cell_is_runnable
from repro.launch import dryrun
out = [dryrun.run_cell(a, s, mp, save=False) for a in ARCHS for s in SHAPES
       for mp in (False, True) if not cell_is_runnable(ARCHS[a], s)]
print(json.dumps(out))
"""


def test_grid_tags_skips_and_fields_equal_jax(tmp_path, monkeypatch):
    want = [(a, s, mp) for a in J_ARCHS for s in J_SHAPES
            for mp in (False, True)]
    assert dryrun.grid(None, None, [False, True]) == want
    assert dryrun.grid("qwen3-0.6b", "train_4k", [False]) == [
        ("qwen3-0.6b", "train_4k", False)]
    for a, s, mp in want:
        assert dryrun.cell_tag(a, s, mp) == \
            f"{a}__{s}__{'pod2' if mp else 'pod1'}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SKIPS, os.path.join(ROOT, "src"), ROOT],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    jax_skips = json.loads(out.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    ours = [dryrun.run_cell(r["arch"], r["shape"], r["multi_pod"],
                            save=False) for r in jax_skips]
    assert len(ours) == 12
    for o, j in zip(ours, jax_skips):
        assert {k: v for k, v in o.items() if k != "kernel_backend"} == j
    for a, cfg in ARCHS.items():
        jc = J_ARCHS[a]
        assert dryrun.arch_fields(cfg) == dict(
            params=jc.param_count(), active_params=jc.active_param_count(),
            stages=jc.stages, tp=jc.tp, nm=jc.num_microbatches)


def test_cli_writes_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--both-meshes"]) == 0
    assert "[SKIP] qwen3-0.6b__long_500k__pod2" in capsys.readouterr().out
    with open(tmp_path / "qwen3-0.6b__long_500k__pod1.json") as f:
        rec = json.load(f)
    assert rec["skipped"] and rec["ok"] and rec["kernel_backend"] == "ref"
    with pytest.raises(SystemExit):
        dryrun.main(["--kernel-backend", "tpu", "--all"])


# ----------------------------------------------------------------------------
# the kernels' meta branch and cost()
# ----------------------------------------------------------------------------
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_branch_reports_and_launches_nothing():
    """Each wrapper on meta: the CUDA branch's checks, allocations and
    route, the launch reported to the counter, an empty output of the
    CUDA output's shape, strides and dtype; LAUNCHES / ROUTES untouched."""
    reset_launches()
    kv = _meta(2, 2, 64, 128)
    with costs.CostCounter() as c:
        o = fa.flash_attention_fwd(_meta(2, 64, 4, 128).transpose(1, 2),
                                   kv, kv)
        d = fd.flash_decode(_meta(2, 4, 128), kv, kv,
                            torch.full((2,), 9, dtype=torch.int32,
                                       device="meta"))
        pool = _meta(1, 9, 16, 2, 128)
        tab = torch.zeros(2, 4, dtype=torch.int32, device="meta")
        p = fd.flash_decode_paged(_meta(2, 4, 128), pool, pool, tab, 7)
        g = moe_gmm.grouped_matmul(_meta(4, 8, 64), _meta(4, 64, 32))
        f32 = torch.float32
        y, st = rwkv6_scan.rwkv6_chunked(*(_meta(1, 2, 32, 64, dtype=f32)
                                           for _ in range(4)),
                                         _meta(2, 64, dtype=f32))
        ys, ss = mamba_ssd.ssd_chunked(_meta(1, 2, 64, 64, dtype=f32),
                                       _meta(1, 2, 64, dtype=f32),
                                       _meta(1, 64, 16, dtype=f32),
                                       _meta(1, 64, 16, dtype=f32),
                                       _meta(2, dtype=f32))
    c.close()
    assert o.shape == (2, 4, 64, 128) and o.stride() == (32768, 128, 512, 1)
    assert d.shape == p.shape == (2, 4, 128) and g.shape == (4, 8, 32)
    assert y.shape == (1, 2, 32, 64) and y.stride()[1] == 64
    assert st.shape == (1, 2, 64, 64) and ss.shape == (1, 2, 16, 64)
    assert all(t.device.type == "meta" for t in (o, d, p, g, y, ys))
    k = c.total().kernels
    assert {n: {r: v for r, v in x.items() if r not in ("flops", "bytes")}
            for n, x in k.items()} == {
        "flash_attention_fwd": {"tc": 1}, "flash_decode": {"tc": 1},
        "flash_decode_paged": {"tc": 1}, "grouped_matmul": {"tc_decode": 1},
        "rwkv6_chunked": {"tile": 1}, "ssd_chunked": {"tile": 1}}
    # the meta length has no value: the decode reads every position
    assert k["flash_decode"]["flops"] == 4 * 4 * 128 * 2 * 64
    assert sum(LAUNCHES.values()) == 0
    assert all(v == 0 for r in ROUTES.values() for v in r.values())
    # an odd element offset moves a view off the 16-byte grid on meta too
    base = _meta(4, 8, 65)
    assert moe_gmm._route(base[:, :, 1:], _meta(4, 64, 32)) == "simt_bf16"


# PERF.md §6's bound column (ms, by): the serve shapes of its rows
_PAGED_LENS = np.random.default_rng(0).integers(17, 161, 8)


def _paged(H, KV, hd):
    pool = _meta(28, 49, 16, KV, hd)
    return fd.cost_paged(_meta(8, H, hd), pool, pool,
                         torch.zeros(8, 10, dtype=torch.int32),
                         torch.tensor(_PAGED_LENS, dtype=torch.int32))


def _attn(B, S, H, KV, hd, window=0):
    kv = _meta(B, KV, S, hd)
    return fa.cost(_meta(B, H, S, hd), kv, kv, window=window)


def _dec(B, S, lens, H, KV, hd):
    kv = _meta(B, KV, S, hd)
    return fd.cost(_meta(B, H, hd), kv, kv,
                   torch.tensor(lens, dtype=torch.int32))


def _gmm(E, C, d, f):
    return moe_gmm.cost(_meta(E, C, d), _meta(E, d, f))


BOUNDS = {
    "1 qwen3 paged": (lambda: _paged(16, 8, 128), 0.0007, "bytes"),
    "1 granite paged": (lambda: _paged(16, 8, 64), 0.0003, "bytes"),
    "1 hymba paged": (lambda: _paged(25, 5, 64), 0.0002, "bytes"),
    "1b gemma3 paged": (lambda: _paged(4, 1, 256), 0.0002, "bytes"),
    "2 qwen3 attention": (lambda: _attn(8, 128, 16, 8, 128), 0.0038,
                          "bytes"),
    "2 granite attention": (lambda: _attn(8, 128, 16, 8, 64), 0.0019,
                            "bytes"),
    "2 hymba attention": (lambda: _attn(8, 128, 25, 5, 64), 0.0023,
                          "bytes"),
    "2 hymba S1100": (lambda: _attn(4, 1100, 25, 5, 64), 0.0157,
                      "operations"),
    "2b gemma3 attention": (lambda: _attn(8, 128, 4, 1, 256), 0.0016,
                            "bytes"),
    "2b gemma3 window": (lambda: _attn(2, 600, 4, 1, 256, 512), 0.0018,
                         "bytes"),
    "3 qwen3 decode": (lambda: _dec(8, 160, [140] * 8, 16, 8, 128), 0.0014,
                       "bytes"),
    "3 hymba decode": (lambda: _dec(4, 1132, np.linspace(
        1101, 1132, 4).round().astype(int).tolist(), 25, 5, 64), 0.0017,
        "bytes"),
    "3b gemma3 decode": (lambda: _dec(8, 160, [140] * 8, 4, 1, 256),
                         0.0004, "bytes"),
    "4 rwkv6": (lambda: rwkv6_scan.cost(*(_meta(8, 40, 128, 64)
                                          for _ in range(4)),
                                        _meta(40, 64)), 0.0172, "bytes"),
    "5 ssd serve": (lambda: mamba_ssd.cost(
        _meta(8, 50, 128, 64), _meta(8, 50, 128), _meta(8, 128, 16),
        _meta(8, 128, 16), _meta(50)), 0.0084, "bytes"),
    "5 ssd generate": (lambda: mamba_ssd.cost(
        _meta(4, 50, 1100, 64), _meta(4, 50, 1100), _meta(4, 1100, 16),
        _meta(4, 1100, 16), _meta(50)), 0.0343, "bytes"),
    "6 decode w_in": (lambda: _gmm(32, 8, 1024, 1024), 0.0203, "bytes"),
    "6 decode w_out": (lambda: _gmm(32, 8, 512, 1024), 0.0103, "bytes"),
    "6 prefill w_in": (lambda: _gmm(32, 320, 1024, 1024), 0.0326, "bytes"),
    "6 prefill w_out": (lambda: _gmm(32, 320, 512, 1024), 0.0194, "bytes"),
}


@pytest.mark.parametrize("row", list(BOUNDS))
def test_kernel_cost_reproduces_the_bound_column(row):
    fn, ms, by = BOUNDS[row]
    flops, nbytes = fn()
    # the f32 scans against the f32 peak, the rest against bf16's
    dtype = torch.float32 if row[0] in "45" else torch.bfloat16
    got_ms, got_by = costs.bound_ms(flops, nbytes, dtype)
    assert (round(got_ms, 4), got_by) == (ms, by)
