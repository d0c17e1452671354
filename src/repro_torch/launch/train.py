"""The training CLI — a thin layer over repro_torch.api (the port of
repro.launch.train).

  --mode wsp     threaded multi-VW WSP runtime with the parameter server
                 (true async D>=0, stragglers, checkpoint/restart); each
                 worker trains on --device, the PS keeps w_global on the host
  --mode spmd    the pipelined wave step over a --mesh data,stage,tp of
                 slots (WSP D=0) on --device: one controller, the slots
                 wrapping over the visible cards (or the CPU)

Examples:
  python -m repro_torch.launch.train --mode wsp --device cpu --reduced \\
      --waves 6 --num-vw 2                              # reduced, on the CPU
  python -m repro_torch.launch.train --mode wsp --waves 6 --num-vw 2 \\
      --optimizer adamw --lr 1e-3 --batch 16 --seq 512  # full width, card
  python -m repro_torch.launch.train --mode wsp --device cpu --reduced \\
      --waves 6 --num-vw 3 --D 1 --chaos 5 --trace t.json  # a chaos fleet
  python -m repro_torch.obs.summary t.json   # its trace, audited against D
  python -m repro_torch.launch.train --mode spmd --device cpu --reduced \\
      --waves 3 --mesh 2,2,2 --batch 8 --seq 32      # pipelined, 8 slots

As in the JAX CLI, --reduced is a store_true flag: without it the arch
trains at its real widths.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--mode", choices=("spmd", "wsp"), default="wsp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each virtual worker trains")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--waves", type=int, default=50)
    ap.add_argument("--num-vw", type=int, default=4)
    ap.add_argument("--D", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", type=float, default=None)
    ap.add_argument("--codec", default=None,
                    help="gradient codec: topk:<ratio> | int8 | none")
    ap.add_argument("--topology", default=None,
                    help="network model spec, or 'list' to print every "
                         "accepted spec and exit (default: zero-latency)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="scale modeled network delays before sleeping")
    ap.add_argument("--overlap", action="store_true",
                    help="push wave deltas asynchronously (the next wave's "
                         "forward starts while the push is in flight)")
    ap.add_argument("--pull-every", type=int, default=1,
                    help="pull w_global every k waves (local delta updates "
                         "in between; k>1 lets async pushes overlap)")
    ap.add_argument("--speeds", default=None,
                    help="comma-separated per-VW slowdowns (s/wave)")
    ap.add_argument("--devices", type=int, default=0,
                    help="spmd mode: accepted for the JAX CLI's sake (its "
                         "fake host device count); the mesh's slots wrap "
                         "over the visible devices, so it changes nothing")
    ap.add_argument("--mesh", default="2,2,2",
                    help="spmd mode: data,stage,tp")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON (Perfetto-"
                         "loadable) of the run, with the metrics snapshot "
                         "embedded; inspect with python -m "
                         "repro_torch.obs.summary")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject the seeded random fault scenario "
                         "FaultPlan.sample_train(SEED) — a worker crash, a "
                         "link outage on a push path, a slowdown onset and a "
                         "PS stall — with eviction + rejoin recovery "
                         "enabled; prints the run's fault digest")
    ap.add_argument("--stall-grace-s", type=float, default=1.0,
                    help="with --chaos: seconds a worker may lag the fleet "
                         "by the eviction lag before it is evicted as "
                         "stalled (FaultPolicy.stall_grace_s; the JAX CLI's "
                         "1 s by default)")
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)

    if a.topology == "list":
        from repro_torch.dist.topology import topology_help
        print("accepted --topology specs:")
        print(topology_help())
        return
    if a.mode == "spmd" and a.chaos is not None:
        raise SystemExit("--chaos needs the threaded WSP runtime; "
                         "use --mode wsp")

    import numpy as np

    from repro_torch.api import (ClusterSpec, Engine, FaultPlan, FaultPolicy,
                                 Plan, RunSpec, WSP)
    from repro_torch.configs import ARCHS, reduced as make_reduced
    from repro_torch.obs import NULL_TRACER, Tracer

    tracer = Tracer() if a.trace else NULL_TRACER
    cfg = ARCHS[a.arch]
    if a.reduced:
        dm = a.d_model
        heads = max(1, min(cfg.num_heads, 4)) if cfg.num_heads else 0
        cfg = make_reduced(cfg, d_model=dm, d_ff=2 * dm, num_layers=a.layers,
                           vocab_size=256, stages=2, tp=1, num_heads=heads,
                           num_kv_heads=max(1, heads // 2) if heads else 0,
                           head_dim=dm // heads if heads else 0)
    print(f"arch={cfg.name} params={cfg.param_count():,} (analytic) "
          f"device={a.device}")
    if a.mode == "spmd":
        return _spmd(a, cfg, tracer)
    if a.overlap and a.pull_every == 1:
        print("note: --overlap with --pull-every 1 serializes every push "
              "behind the following pull; use --pull-every > 1 to actually "
              "hide push latency", file=sys.stderr)
    speeds = [float(s) for s in a.speeds.split(",")] if a.speeds else None
    fault_kwargs = {}
    if a.chaos is not None:
        faults = FaultPlan.sample_train(a.chaos, num_vw=a.num_vw,
                                        max_waves=a.waves)
        fault_kwargs = dict(faults=faults, fault_policy=FaultPolicy(
            evict_lag=1, rejoin_after_waves=1, allow_degraded=True,
            stall_grace_s=a.stall_grace_s))
        print(f"chaos: {faults.describe()}")
    plan = Plan(
        arch=cfg,
        cluster=ClusterSpec(num_vw=a.num_vw, topology=a.topology,
                            speeds=speeds, time_scale=a.time_scale),
        sync=WSP(D=a.D, pull_every=a.pull_every, async_push=a.overlap),
        run=RunSpec(max_waves=a.waves, batch=a.batch, seq=a.seq,
                    optimizer=a.optimizer, lr=a.lr,
                    compression_ratio=a.compression, codec=a.codec,
                    ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                    resume=a.resume),
        **fault_kwargs)
    eng = Engine(plan, tracer=tracer, device=a.device)
    rep = eng.fit()
    if a.chaos is not None:
        print(f"faults: {rep.fault_digest()}")
    if a.trace:
        print(f"trace: {tracer.export(a.trace)}")
    xs, ys = rep.loss_curve()
    print(f"waves={rep.waves} wall={rep.wall_s:.1f}s "
          f"first_loss={ys[0]:.4f} last_loss={np.mean(ys[-5:]):.4f}")
    if a.overlap:
        print(f"overlap: hidden={rep.overlap_seconds:.2f}s "
              f"blocked={rep.push_wait_seconds:.2f}s")
    waits = {k: round(v, 2) for k, v in rep.wait_seconds.items()}
    print(f"pushed={rep.bytes_pushed / 1e6:.1f}MB "
          f"wire={rep.bytes_wire / 1e6:.1f}MB waits={waits}")
    for wid, w in sorted(eng.workers.items()):
        m = w.metrics
        if not m.wave_times:
            print(f"{wid}: no wave finished")
            continue
        print(f"{wid}: wave_ms={1e3 * np.median(m.wave_times):.1f} "
              f"push_ms={1e3 * np.median(m.push_s):.1f} "
              f"pull_ms={1e3 * np.median(m.pull_s):.1f}")
    if eng.topology is not None:
        by_link = {k: f"{v / 1e6:.1f}MB"
                   for k, v in rep.comm.get("bytes_by_link", {}).items()}
        print(f"network: modeled={rep.comm_seconds:.2f}s "
              f"bytes_by_link={by_link}")


def _spmd(a, cfg, tracer):
    """--mode spmd: one Engine over the (data, stage, tp) mesh."""
    import torch

    from repro_torch.api import Engine, PartitionSpec, Plan, RunSpec, WSP

    if a.topology or a.codec or a.compression:
        print("warning: --topology/--codec/--compression only apply to "
              "--mode wsp; ignored in spmd mode", file=sys.stderr)
    if a.devices:
        print(f"note: --devices {a.devices} changes nothing here: the "
              f"mesh's slots wrap over the visible devices",
              file=sys.stderr)
    dsz, ssz, tsz = (int(x) for x in a.mesh.split(","))
    plan = Plan(
        arch=cfg,
        partition=PartitionSpec(data=dsz, stages=ssz, tp=tsz),
        sync=WSP(D=0),
        run=RunSpec(backend="spmd", max_waves=a.waves, batch=a.batch,
                    seq=a.seq, optimizer=a.optimizer, lr=a.lr,
                    overlap=a.overlap, resume=a.resume,
                    ckpt_dir=a.ckpt_dir,
                    ckpt_every=a.ckpt_every if a.ckpt_dir else 0))
    eng = Engine(plan, tracer=tracer, device=a.device)
    n_dev = torch.cuda.device_count() if eng.device.type == "cuda" else 1
    print(f"mesh=({dsz},{ssz},{tsz}) devices={n_dev}")

    def log(w, loss, dt):
        if w % 5 == 0 or w == a.waves - 1:
            print(f"wave {w:4d} loss={loss:.4f} ({dt:.2f}s)")

    eng.fit(callback=log)
    if a.trace:
        print(f"trace: {tracer.export(a.trace)}")


if __name__ == "__main__":
    main()
