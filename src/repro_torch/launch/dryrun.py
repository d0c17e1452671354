"""The dry run: every (architecture x input shape) cell of the production
mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod, split by
make_logical_mesh into (data, stage, tp)), built over meta slots and run
once under the cost counter (launch.costs): aten ops, FLOPs and bytes,
collective traffic, kernel launches by route and live bytes, with no
allocation and no card. The port's counterpart of repro.launch.dryrun,
which lowers and compiles each cell with ShapeDtypeStruct stand-ins.

The device is meta by nature: params (lm.param_shapes), the optimizer
state, the batch and the cache (lm.input_specs, then serve.cache's
shard_cache over the mesh) are meta tensors, and the step is the port's
own build_train_step / build_prefill_step / build_decode_step. On
kernel backend "cuda" the kernel wrappers take their meta branch: each
reports its launch, route and cost() to the counter.

A record keeps the JAX record's keys where they mean the same (ok,
error, traceback, flops, dot_flops, bytes_upper, dot_bytes, collectives,
link_bytes, memory, params, active_params, stages, tp, nm) and has, in
place of lower_s / compile_s / hlo_ops: run_s, ops (aten dispatches),
kernels ({name: {route: n, flops, bytes}}), per-slot maxima and slot 0's
values, and kernel_backend. The gradient psum over data is no call in
the port (autograd accumulates every data slot's shard views into the one
params tree), so the record reckons it from the grads' bytes and the
data axis size, marked "modeled": true.

Data slots issue the same work on same-shaped inputs, and a meta op
costs ~0.05-0.3 ms of host time (a production train_4k cell issues ~10^7
ops a data slot), so a cell issues data slot 0's pipeline alone and
reckons the others by symmetry: slot 0's extra work (the embed, the CE
over the global batch, the optimizer) stays as issued, the other slots'
outputs stand in as empty tensors of their shape, every count of data
slot 0's pipeline is added once more for each other slot, and so is its
live memory as its scope closed (at the end of forward every data slot's
saved activations are alive; the whole mesh's peak is modelled). The
record says so ("data_slots_issued": 1); tests/test_torch_dryrun.py holds
such a record to the whole mesh's on a reduced cell. A step whose data
slot 0 issues every slot's work (the sequence-sharded decode under 16
rows) reckons nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--kernel-backend cuda] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
Records land in artifacts/dryrun_torch/<arch>__<shape>__<pod1|pod2>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, RunConfig, cell_is_runnable
from repro_torch.core import wave
from repro_torch.launch import costs as costs_lib
from repro_torch.launch.mesh import make_logical_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.serve import cache as cache_lib

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "artifacts", "dryrun_torch")

SKIP_REASON = ("long_500k on full-attention arch (per assignment; see "
               "DESIGN.md §Arch-applicability)")


def cell_tag(arch_name: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch_name}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"


def build_step(run: RunConfig, mesh):
    """(step, cache specs or None): the port's step of the run's shape kind
    over `mesh`."""
    kind = run.shape.kind
    if kind == "train":
        return wave.build_train_step(run, mesh)[0], None
    build = wave.build_prefill_step if kind == "prefill" else \
        wave.build_decode_step
    step, _, cspecs = build(run, mesh)
    return step, cspecs


def build_cell(arch_name: str, shape_name: str, multi_pod: bool,
               run_overrides: dict | None = None, *, mesh=None,
               arch=None):
    """(step, args, mesh, run): the port's step of the cell over a meta
    mesh, and its meta arguments (params f32 as lm.param_shapes; train:
    the optimizer state and the batch; prefill / decode: the batch with
    shard_cache's per-slot cache). `mesh` / `arch` replace the production
    mesh and ARCHS[arch_name] (the tests pass reduced ones)."""
    cfg = arch or ARCHS[arch_name]
    run = RunConfig(arch=cfg, shape=SHAPES[shape_name], multi_pod=multi_pod)
    if run_overrides:
        run = dataclasses.replace(run, **run_overrides)
    if mesh is None:
        prod = make_production_mesh(multi_pod=multi_pod, devices="meta")
        mesh = make_logical_mesh(prod, cfg.stages, cfg.tp)
    step, cspecs = build_step(run, mesh)
    return step, meta_args(run, mesh, cspecs), mesh, run


def meta_args(run: RunConfig, mesh, cspecs):
    """The step's meta arguments: (params, optimizer state, batch) for
    train, (params, batch with shard_cache's cache) for prefill / decode."""
    params = lm.param_shapes(run.arch)
    ins = lm.input_specs(run)
    if run.shape.kind == "train":
        opt = make_optimizer(run.optimizer, run.lr, run.weight_decay)
        batch = {"inputs": ins["inputs"], "labels": ins["labels"]}
        return params, opt.init(params), batch
    batch = {"inputs": ins["inputs"],
             "cache": cache_lib.shard_cache(run.arch, ins["cache"], mesh,
                                            cspecs)}
    if run.shape.kind == "decode":
        batch["pos"] = ins["pos"]
    return params, batch


def grid(arch, shape, meshes) -> list:
    """The cells, in the JAX dry run's order: `arch` (None: every arch) x
    `shape` (None: every shape) x `meshes` (multi_pod values)."""
    return [(a, s, mp) for a in ([arch] if arch else list(ARCHS))
            for s in ([shape] if shape else list(SHAPES)) for mp in meshes]


def arch_fields(cfg) -> dict:
    return dict(params=cfg.param_count(),
                active_params=cfg.active_param_count(), stages=cfg.stages,
                tp=cfg.tp, nm=cfg.num_microbatches)


def _charge_args(counter, args, mesh):
    """The step's inputs where the port places them: params, optimizer
    state and batch on slot 0 (the shards are views of the params tree);
    each slot's cache on its slot."""
    for a in args:
        cache = a.get("cache") if isinstance(a, dict) else None
        if cache is None:
            counter.arguments(a)
            continue
        counter.arguments({k: v for k, v in a.items() if k != "cache"})
        for d, rows in enumerate(cache):
            for s, row in enumerate(rows):
                for t, slot_cache in enumerate(row):
                    counter.arguments(slot_cache, (d, s, t))


def count_step(step, args, mesh, run, *, symmetric: bool = False) -> dict:
    """Run `step(*args)` once under a CostCounter; returns the record's
    measured fields (see the module docstring). symmetric: issue data slot
    0's pipeline alone and reckon the other data slots."""
    ndp = wave.n_dp(mesh)
    symmetric = symmetric and ndp > 1
    counter = costs_lib.CostCounter()
    if symmetric:
        counter.data_slots = 1
    _charge_args(counter, args, mesh)
    t0 = time.time()
    try:
        with counter:
            out = step(*args)
            end_bytes = counter.live_bytes
            if run.shape.kind == "train":
                grads = sum(p.numel() * 4 for p in _leaves(args[0]))
                costs_lib.collective("psum", "data", ndp, grads,
                                     modeled=True)
        del out
        run_s = time.time() - t0
        # a step that issues every data slot's work from data slot 0 (the
        # sequence-sharded decode) reckons nothing
        return _summarise(counter, mesh, run, run_s, end_bytes,
                          counter.reckoned_from, args)
    finally:
        counter.close()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _reckon(counter, by_slot, peak_by_slot, sym_ndp, run, args):
    """Data slot 0's pipeline (its scopes' work) once more for each other
    data slot, slot for slot; and, in a train step, what the other slots
    add to the shared work: autograd sums the grads that reach one tensor
    from every data slot, so each block leaf (in the compute dtype) and the
    embedded batch take one add more per data slot (the rest rule), on
    data slots 0 .. n-2 (the last slot's grads arrive first). Returns the
    whole mesh's peak: the issued peak plus, for each other data slot,
    what data slot 0's scopes held as they closed."""
    pipe = [(k, c) for k, c in counter.by_slot.items()
            if k is not None and (k[0] or 0) == 0]
    for d in range(1, sym_ndp):
        for k, c in pipe:
            key = (d,) + tuple(0 if x is None else x for x in k[1:])
            by_slot.setdefault(key, costs_lib.Costs()).merge(c)
        for k, v in counter.peak_scoped.items():
            if k[0] == 0:
                peak_by_slot[(d,) + k[1:]] = v
    if run.shape.kind == "train":
        cfg = run.arch
        cdt = torch.bfloat16 if run.compute_dtype == "bfloat16" else \
            torch.float32
        sums = [(p.numel(), (cdt if p.dtype == torch.float32 else p.dtype)
                 .itemsize) for p in args[0]["blocks"].values()]
        if cfg.frontend == "none":
            B, S = args[2]["inputs"].shape[:2]
            sums.append((B * S * cfg.d_model, cdt.itemsize))
        for d in range(sym_ndp - 1):
            c = by_slot.setdefault((d, 0, 0), costs_lib.Costs())
            for n, size in sums:
                c.ops += 1
                c.flops += n
                c.bytes_upper += 3 * n * size
                c._by_op("add", 3 * n * size)
    return counter.peak_bytes + (sym_ndp - 1) * counter.saved_bytes_at_mark


def _summarise(counter, mesh, run, run_s, end_bytes, sym_ndp, args):
    by_slot = counter.slot_costs()
    peak_by_slot = dict(counter.peak_by_slot)
    arg_by_slot = dict(counter.arg_by_slot)
    peak = counter.peak_bytes
    if sym_ndp:
        peak = _reckon(counter, by_slot, peak_by_slot, sym_ndp, run, args)
    total = costs_lib.Costs()
    for c in by_slot.values():
        total.merge(c)
    # the issued collectives by kind, then the modeled gradient psum
    colls = {k: {"bytes": float(total.collective_bytes[k]),
                 "count": float(total.collective_counts[k])}
             for k in sorted(total.collective_bytes)}
    for m in counter.modeled:
        colls[f"{m['kind']}_grads"] = dict(m)
    link = total.link_bytes + sum(m["bytes"] for m in counter.modeled)
    slots = {}
    for k in set(by_slot) | set(peak_by_slot) | set(arg_by_slot):
        c = by_slot.get(k, costs_lib.Costs())
        slots[k] = {"ops": c.ops, "flops": c.flops,
                    "dot_flops": c.dot_flops, "bytes_upper": c.bytes_upper,
                    "peak_bytes": peak_by_slot.get(k, 0),
                    "arg_bytes": arg_by_slot.get(k, 0)}
    fields = ("ops", "flops", "dot_flops", "bytes_upper", "peak_bytes",
              "arg_bytes")
    return dict(
        run_s=round(run_s, 2),
        ops=int(total.ops), flops=float(total.flops),
        dot_flops=float(total.dot_flops),
        bytes_upper=float(total.bytes_upper),
        dot_bytes=float(total.dot_bytes),
        collectives=colls, link_bytes=float(link),
        kernels={k: dict(v) for k, v in sorted(total.kernels.items())},
        bytes_by_op={k: float(v) for k, v in sorted(
            total.bytes_by_op.items(), key=lambda kv: -kv[1])[:10]},
        memory={"argument_bytes": int(sum(arg_by_slot.values())),
                "peak_bytes": int(peak),
                "output_bytes": int(end_bytes),
                "peak_modeled": bool(sym_ndp)},
        slots=len(slots),
        slot_max={f: max(v[f] for v in slots.values()) for f in fields},
        slot0=slots.get((0, 0, 0)),
        data_slots_issued=1 if sym_ndp else wave.n_dp(mesh),
    )


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             force: bool = False, save: bool = True,
             kernel_backend: str = "ref") -> dict:
    tag = cell_tag(arch_name, shape_name, multi_pod)
    path = os.path.join(ART_DIR, tag + ".json")
    if save and os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("kernel_backend", kernel_backend) == kernel_backend:
            return rec
    rec = {"cell": tag, "arch": arch_name, "shape": shape_name,
           "multi_pod": multi_pod, "kernel_backend": kernel_backend,
           "ok": False}
    if not cell_is_runnable(ARCHS[arch_name], shape_name):
        rec.update(skipped=True, reason=SKIP_REASON, ok=True)
        _save(rec, path, save)
        return rec
    try:
        step, args, mesh, run = build_cell(
            arch_name, shape_name, multi_pod,
            {"kernel_backend": kernel_backend})
        rec.update(count_step(step, args, mesh, run, symmetric=True))
        rec.update(ok=True, **arch_fields(ARCHS[arch_name]),
                   mesh=dict(mesh.shape))
    except Exception as e:  # noqa: BLE001 -- record the failure verbatim
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _save(rec, path, save)
    return rec


def _save(rec, path, save):
    if save:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


def retrace_cell(arch_name: str, shape_name: str, multi_pod: bool,
                 kernel_backend: str = "ref"):
    """Count an existing record's cell again (after a change to the
    counter's rules) and rewrite it; None when there is no record."""
    path = os.path.join(ART_DIR, cell_tag(arch_name, shape_name, multi_pod)
                        + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if rec.get("skipped") or not rec.get("ok"):
        return rec
    return run_cell(arch_name, shape_name, multi_pod, force=True,
                    kernel_backend=rec.get("kernel_backend",
                                           kernel_backend))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--retrace", action="store_true")
    ap.add_argument("--kernel-backend", default="ref", choices=("ref",
                                                                "cuda"))
    a = ap.parse_args(argv)
    if not (a.all or a.arch or a.shape):
        ap.error("name a cell (--arch / --shape) or pass --all")
    cells = grid(a.arch, a.shape,
                 [False, True] if a.both_meshes else [a.multi_pod])
    if a.retrace:
        for arch, shape, mp in cells:
            r = retrace_cell(arch, shape, mp, a.kernel_backend)
            if r and not r.get("skipped"):
                print(f"[RETR] {r['cell']}")
                sys.stdout.flush()
        return 0
    n_fail = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, force=a.force,
                       kernel_backend=a.kernel_backend)
        status = ("SKIP" if rec.get("skipped")
                  else "OK" if rec["ok"] else "FAIL")
        print(f"[{status:4s}] {rec['cell']}"
              + (f" ops={rec['ops']} flops={rec['flops']:.3e}"
                 f" link={rec['link_bytes']:.3e}"
                 f" peak={rec['memory']['peak_bytes']:.3e}"
                 f" run={rec['run_s']}s"
                 if rec.get("ok") and not rec.get("skipped") else
                 f" {rec.get('error', '')[:200]}"))
        sys.stdout.flush()
        n_fail += 0 if rec["ok"] else 1
    print(f"dryrun complete, failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
