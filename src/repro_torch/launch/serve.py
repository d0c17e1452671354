"""Serving driver — a thin CLI over the repro_torch.api serve surface.

  --backend threads   the non-pipelined forward_ref cache path
  --backend spmd      the pipelined prefill / decode steps over a
                      (1, stages, tp) --mesh of slots on the device (the
                      slots wrap over the visible devices, trap Y1; the
                      JAX CLI's --devices fake host count is accepted and
                      changes nothing)

By default one aligned batch runs through Engine.generate(); --requests N
instead pushes N requests through the continuous-batching Scheduler over
the paged KV pool and prints throughput, occupancy, pages and latency.

  python -m repro_torch.launch.serve --requests 8 --batch 4 \
      --page-size 16 --kernel-backend cuda            # reduced, on the card
  python -m repro_torch.launch.serve --no-reduced --compute-dtype bfloat16 \
      --requests 16 --batch 8 --prompt-len 128 --gen 32 --page-size 16 \
      --max-pages 48 --kernel-backend cuda            # qwen3-0.6b full width
  python -m repro_torch.launch.serve --arch rwkv6-3b --no-reduced \
      --compute-dtype bfloat16 --requests 16 --batch 8 --prompt-len 128 \
      --gen 32 --kernel-backend cuda                  # rwkv6-3b full width
  python -m repro_torch.launch.serve --arch hymba-1.5b --no-reduced \
      --compute-dtype bfloat16 --requests 16 --batch 8 --prompt-len 128 \
      --gen 32 --page-size 16 --max-pages 48 --kernel-backend cuda
                                                      # hymba-1.5b full width
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --no-reduced --compute-dtype bfloat16 --requests 16 --batch 8 \
      --prompt-len 128 --gen 32 --page-size 16 --max-pages 48 \
      --kernel-backend cuda                           # granite MoE full width
  python -m repro_torch.launch.serve --device cpu --requests 4
  python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu --requests 4
  python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu \
      --requests 4 --prompt-len 40        # reduced: prompts past window 32
  python -m repro_torch.launch.serve --arch h2o-danube-1.8b --device cpu \
      --requests 4 --prompt-len 40
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --device cpu --requests 4 --batch 2 --prompt-len 16 --gen 4 \
      --page-size 4 --max-pages 12
  python -m repro_torch.launch.serve --device cpu --requests 12 \
      --replicas 4,2,2 --topology hetero --share-prefix --page-size 4
                                                      # the Router, 3 replicas
  python -m repro_torch.launch.serve --backend spmd --mesh 1,2,2 \
      --device cpu [--requests 4 --page-size 4]       # pipelined, 4 slots
  python -m repro_torch.launch.serve --backend spmd --mesh 1,4,4 \
      --no-reduced --compute-dtype bfloat16 --requests 8 --batch 8 \
      --prompt-len 128 --gen 16 --page-size 16 --max-pages 48 \
      --kernel-backend cuda             # qwen3-0.6b full width, 16 slots

--replicas B0,B1,... routes the requests over a fleet of replicas with
those decode batch sizes (repro_torch.serve.router), priced by --topology
and dispatched by --route; --chaos SEED injects FaultPlan.sample_cluster
(a replica dies) with --replicas, FaultPlan.sample_serve (slot faults)
without.

--reduced (the default) serves the config cut down by configs.reduced();
--no-reduced serves the real widths. (The JAX CLI declares --reduced as a
store_true flag defaulting to True, so it can never serve full width.)
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-reduced: the real "
                         "widths)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; on cpu the kernel backend "
                         "runs the kernels' plain PyTorch versions")
    ap.add_argument("--backend", choices=("threads", "spmd"),
                    default="threads",
                    help="threads: the forward_ref cache path; spmd: the "
                         "pipelined steps over --mesh")
    ap.add_argument("--mesh", default="1,2,1",
                    help="spmd backend: data,stages,tp (data must be 1)")
    ap.add_argument("--devices", type=int, default=0,
                    help="spmd backend: accepted for the JAX CLI's sake (its "
                         "fake host device count); the mesh's slots wrap "
                         "over the visible devices, so it changes nothing")
    ap.add_argument("--kernel-backend", choices=("ref", "cuda"),
                    default="ref",
                    help="hot-path attention, WKV / SSD prefill and MoE "
                         "expert GEMMs (ServeSpec.kernel_backend): 'ref' = "
                         "plain torch, 'cuda' = the Hopper kernels")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="params and activations (RunSpec.compute_dtype)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch slots (ServeSpec.max_batch)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N requests through the continuous-batching "
                         "scheduler instead of one aligned batch")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page tokens (0 = one page per slot)")
    ap.add_argument("--max-pages", type=int, default=0,
                    help="KV page pool size (0 = worst case)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="map each request's longest indexed prompt prefix "
                         "onto shared pages; the synthetic requests draw "
                         "from a small prompt pool so prefixes repeat")
    ap.add_argument("--evict", action="store_true",
                    help="reclaim cold indexed pages LRU-first (needs "
                         "--share-prefix)")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt and replay an in-flight request instead of "
                         "refusing admission")
    ap.add_argument("--policy", choices=("fifo", "deadline"),
                    default="fifo", help="scheduler admission policy")
    ap.add_argument("--replicas", default=None, metavar="B0,B1,...",
                    help="scale-out serving: comma-separated per-replica "
                         "decode batch sizes (e.g. '4,2,2' = one big + two "
                         "whimpy); requests route through the Router "
                         "instead of one Scheduler; needs --requests")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="price the Router's dispatch with this cluster "
                         "topology's alpha-beta link costs (dist.topology "
                         "spec, e.g. 'hetero', '3node:eth1'); default: all "
                         "replicas equidistant")
    ap.add_argument("--route", choices=("least_loaded", "deadline"),
                    default="least_loaded",
                    help="Router dispatch policy: least_loaded books by "
                         "queue depth + page pressure + link cost; "
                         "deadline dispatches in slack order (and runs "
                         "each replica's scheduler in deadline mode)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a seeded random fault scenario: "
                         "FaultPlan.sample_cluster(SEED) (a replica dies, "
                         "its requests re-dispatch) with --replicas, else "
                         "FaultPlan.sample_serve(SEED) (decode-slot faults "
                         "recovered by quarantine + requeue); needs "
                         "--requests")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON of the run")
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)

    import numpy as np

    from repro_torch.api import (ClusterSpec, Engine, FaultPlan,
                                 PartitionSpec, Plan, ReplicaSpec, RunSpec,
                                 ServeSpec)
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS, reduced as make_reduced
    from repro_torch.obs import NULL_TRACER, Tracer

    cfg = ARCHS[a.arch]
    if a.reduced:
        cfg = make_reduced(cfg)
    if not a.requests and (a.page_size or a.max_pages or a.policy != "fifo"
                           or a.chaos is not None or a.share_prefix
                           or a.evict or a.preempt):
        raise SystemExit(
            "--page-size/--max-pages/--policy/--chaos/--share-prefix/"
            "--evict/--preempt drive the continuous-batching scheduler; the "
            "aligned generate() path would silently drop them — add "
            "--requests N")
    replica_batches = []
    if a.replicas:
        if not a.requests:
            raise SystemExit("--replicas routes requests over a replica "
                             "fleet; add --requests N")
        if a.backend != "threads":
            raise SystemExit("--replicas is threads-backend only (the "
                             "spmd mesh serves as a single replica)")
        replica_batches = [int(x) for x in a.replicas.split(",")]
    partition = PartitionSpec(data=max(1, len(replica_batches)))
    if a.backend == "spmd":
        dsz, ssz, tsz = (int(x) for x in a.mesh.split(","))
        partition = PartitionSpec(data=dsz, stages=ssz, tp=tsz)
        if a.devices:
            print(f"note: --devices {a.devices} changes nothing here: the "
                  f"mesh's slots wrap over the visible devices")
    faults = None
    if a.chaos is not None:
        if replica_batches:
            faults = FaultPlan.sample_cluster(a.chaos,
                                              replicas=len(replica_batches))
        else:
            faults = FaultPlan.sample_serve(a.chaos, max_batch=a.batch)
        print(f"chaos: {faults.describe()}")
    plan = Plan(arch=cfg, partition=partition,
                cluster=ClusterSpec(topology=a.topology),
                serve=ServeSpec(prompt_len=a.prompt_len, gen=a.gen,
                                max_batch=max(replica_batches + [a.batch]),
                                temperature=a.temperature,
                                page_size=a.page_size, max_pages=a.max_pages,
                                share_prefix=a.share_prefix, evict=a.evict,
                                preempt=a.preempt,
                                kernel_backend=a.kernel_backend,
                                replicas=tuple(ReplicaSpec(max_batch=b)
                                               for b in replica_batches)),
                run=RunSpec(backend=a.backend,
                            compute_dtype=a.compute_dtype), faults=faults)
    tracer = Tracer() if a.trace else NULL_TRACER

    if a.requests:
        rng = np.random.default_rng(1)
        policy = a.route if replica_batches else a.policy

        def deadline(i):
            return int(a.gen * (1 + (a.requests - i))) \
                if policy == "deadline" else 0
        if a.share_prefix:
            pool = [rng.integers(0, cfg.vocab_size, a.prompt_len,
                                 dtype=np.int32)
                    for _ in range(max(1, a.requests // 4))]
            prompt_of = lambda i: pool[i % len(pool)].copy()
        else:
            prompt_of = lambda i: rng.integers(0, cfg.vocab_size,
                                               a.prompt_len, dtype=np.int32)
        reqs = [Request(rid=i, prompt=prompt_of(i), deadline=deadline(i))
                for i in range(a.requests)]
    if replica_batches:
        from repro_torch.serve.router import Router
        rep = Router(plan, policy=a.route, tracer=tracer,
                     device=a.device).run(reqs)
        if a.trace:
            print(f"trace: {tracer.export(a.trace)}")
        occ = rep.occupancy()
        print(f"arch={cfg.name} device={a.device} "
              f"kernels={a.kernel_backend} replicas={a.replicas} "
              f"route={a.route} topology={a.topology or 'flat'} "
              f"requests={a.requests} tokens={rep.tokens_out} "
              f"throughput={rep.tokens_per_s():.1f} tok/s "
              f"occupancy={'n/a' if occ is None else f'{occ:.2f}'}")
        print(f"router: dispatches={rep.router['dispatches']} "
              f"affinity_hits={rep.router['affinity_hits']} "
              f"rebalances={rep.router['rebalances']} "
              f"rounds={rep.router['rounds']} "
              f"replica_downs={rep.router['replica_downs']} "
              f"queue_peak={rep.router['queue_depth_peak']}")
        if a.share_prefix:
            print(f"memory: prefix_hit={rep.prefix_hit_tokens} tok "
                  f"shared={rep.pages_shared} evictions={rep.evictions}")
        lat = sorted(r.latency_s for r in rep.requests)
        print(f"latency: p50={lat[len(lat) // 2] * 1e3:.1f}ms "
              f"max={lat[-1] * 1e3:.1f}ms failed={rep.failed_requests}")
        return

    eng = Engine(plan, tracer=tracer, device=a.device)
    if a.requests:
        rep = Scheduler(eng, policy=a.policy).run(reqs)
        if a.trace:
            print(f"trace: {tracer.export(a.trace)}")
        if a.chaos is not None:
            retries = sum(r.retries for r in rep.requests)
            print(f"faults: slot_faults={rep.slot_faults} "
                  f"requeues={rep.requeues} reprefills={rep.reprefills} "
                  f"quarantined={rep.quarantined} retries={retries} "
                  f"shed={rep.shed} failed={rep.failed_requests}")
        occ, pu = rep.occupancy(), rep.page_utilization()
        print(f"arch={cfg.name} backend={a.backend} device={a.device} "
              f"kernels={a.kernel_backend} requests={a.requests} "
              f"slots={a.batch} tokens={rep.tokens_out} "
              f"decode={rep.ms_per_token():.1f}ms/step "
              f"throughput={rep.tokens_per_s():.1f} tok/s "
              f"occupancy={'n/a' if occ is None else f'{occ:.2f}'} "
              f"pages={rep.peak_pages}/{rep.pages_total}"
              f"(x{rep.page_size} tok) "
              f"util={'n/a' if pu is None else f'{pu:.2f}'}")
        if a.share_prefix or a.evict or a.preempt:
            print(f"memory: prefix_hit={rep.prefix_hit_tokens} tok "
                  f"shared={rep.pages_shared} cow={rep.cow_copies} "
                  f"evictions={rep.evictions} "
                  f"readmits={rep.readmit_recomputes} "
                  f"preemptions={rep.preemptions}")
        lat = sorted(r.latency_s for r in rep.requests)
        print(f"latency: p50={lat[len(lat) // 2] * 1e3:.1f}ms "
              f"max={lat[-1] * 1e3:.1f}ms "
              f"ttft={rep.mean_ttft() * 1e3:.1f}ms "
              f"({rep.prefill_calls} prefill groups)")
        print("generated ids[rid=0]:", rep.requests[0].tokens)
        return

    rep = eng.generate()
    if a.trace:
        print(f"trace: {tracer.export(a.trace)}")
    print(f"arch={cfg.name} backend={a.backend} device={a.device} "
          f"kernels={a.kernel_backend} batch={a.batch} prefill({a.prompt_len} tok)="
          f"{rep.prefill_s * 1e3:.1f}ms decode {rep.decode_steps} steps="
          f"{rep.decode_s * 1e3:.1f}ms ({rep.ms_per_token():.1f} ms/tok)")
    print("generated ids[0]:", np.asarray(rep.tokens)[0].tolist())


if __name__ == "__main__":
    main()
