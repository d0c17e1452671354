"""One run of one cell: find the cell's files by name, run its entry
point, read its per-layer metrics, judge its outputs, print the result.

Everything a cell needs is found by name from BENCHMARK.json's entry for
it: configs/<config>.json (whose `family` names families/<family>.py),
traffic/<traffic>.json (whose `kind` names the generator
traffic/<kind>.py and whose `entry` names the driver drivers/<entry>.py),
cells/<cell>.json (the limits of its checks) and metrics/<metric>.py for
each per-layer metric. Modules are loaded from their files, so a new
cell, configuration, family, mix, kind or metric is a new file."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from hetbench import families

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (compared whole: repro_torch is not repro)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A workload of BENCHMARK.json with its files, under `root`."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.bench, self.spec = bench, cells[workload]
        self.name = workload
        here = self.root / "hetbench"
        self.dir = here
        self.cfg = json.loads(
            (here / "configs" / f"{self.spec['config']}.json").read_text())
        self.mix = json.loads(
            (here / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.limits = json.loads(
            (here / "cells" / f"{workload}.json").read_text())["limits"]
        self.family = families.load(self.cfg["family"], here / "families")
        self.kind = load_module(here / "traffic" / f"{self.mix['kind']}.py",
                                f"hetbench_kind_{self.mix['kind']}")
        self.driver = load_module(here / "drivers" / f"{self.mix['entry']}.py",
                                  f"hetbench_entry_{self.mix['entry']}")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def arch(self):
        """The port's ArchConfig for this configuration: the registry's
        entry with the configuration's sizes laid over it."""
        from repro_torch.configs import get_arch
        port = self.cfg["port"]
        a = dataclasses.replace(get_arch(port["arch"]), **port["fields"])
        if a.padded_layers != a.num_layers:
            raise ValueError(f"{a.name}: {a.num_layers} layers pad to "
                             f"{a.padded_layers}; the weight maker stacks "
                             f"exactly num_layers")
        return a


def context(cell: Cell, seed: int, seconds: float, trace: bool, *,
            t_process: float, device=None, hooks=None) -> SimpleNamespace:
    """What a driver is handed: the cell, its files and the run's
    arguments. `device` None is the card; the CPU tests pass "cpu"."""
    import torch
    return SimpleNamespace(cell=cell, cfg=cell.cfg, mix=cell.mix,
                           seed=int(seed), seconds=float(seconds),
                           trace=bool(trace),
                           device=torch.device(device or "cuda"),
                           t_process=t_process, hooks=hooks or {},
                           limits=cell.limits)


def judge(readings: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {value, limit}}): the
    numbers the limits name, in their order; one not read is infinite."""
    checks = {n: {"value": readings.get(n, float("inf")), "limit": lim}
              for n, lim in limits.items()}
    return (bool(checks) and all(c["value"] <= c["limit"]
                                 for c in checks.values())), checks


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             *, t_process: float, device=None, hooks=None) -> dict:
    """Runs the cell once and returns the result line's object (the result
    names the CPU where `device` is "cpu"). `hooks` lets the tests break
    the timed path underneath; hooks["control"], a reference precision,
    has the serve drivers read the control on the run's own inputs too,
    judged by the same limits (`control_correct`)."""
    import torch
    cell = Cell(root, workload)
    ctx = context(cell, seed, seconds, trace, t_process=t_process,
                  device=device, hooks=hooks)
    dev = ctx.device
    t0 = time.monotonic()
    run = cell.driver.run(ctx)
    values = run.e2e
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end() if values.get(m["name"]) is not None}
    if trace:
        metrics = {}
        for m in cell.per_layer():
            reader = load_module(cell.dir / "metrics" / f"{m['name']}.py",
                                 "hetbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": None, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.prof is not None:
        device_info["busy_s"] = run.prof["busy_s"]
        device_info["window_s"] = run.prof["window_s"]
        out["breakdown"] = {"device_ops": run.prof["device_ops"],
                            "idle_gaps": run.prof["idle_gaps"]}
    ok, checks = judge(run.checks, cell.limits)
    out["correct"] = ok and run.failed == 0
    if ctx.hooks.get("control"):
        out["control"] = run.control
        out["control_correct"], out["control_checks"] = judge(
            run.control, cell.limits)
        out["readings"] = run.checks
        out["notes"] = getattr(ctx, "notes", {})
    out["timings"] = {"setup_s": values.get("setup_s"),
                      "run_s": time.monotonic() - t0,
                      "check_s": getattr(run, "check_s", None)}
    out["checks"] = checks
    return out


def main(argv=None, t_process=None) -> int:
    import argparse
    t_process = t_process if t_process is not None else time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    import torch
    chips = Cell(root, a.workload).spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hetbench: {a.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace),
                   t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"hetbench: the run loaded {bad}; the port's benchmark may "
              f"load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    print("timings " + json.dumps(out.pop("timings", {})), file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
