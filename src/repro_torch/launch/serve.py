"""Serving driver — a thin CLI over the repro_torch.api serve surface
(threads backend only).

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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON of the run")
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)

    import numpy as np

    from repro_torch.api import Engine, Plan, RunSpec, ServeSpec
    from repro_torch.api.serving import Request, Scheduler
    from repro_torch.configs import ARCHS, reduced as make_reduced
    from repro_torch.obs import NULL_TRACER, Tracer

    cfg = ARCHS[a.arch]
    if a.reduced:
        cfg = make_reduced(cfg)
    if not a.requests and (a.page_size or a.max_pages or a.policy != "fifo"
                           or a.share_prefix or a.evict or a.preempt):
        raise SystemExit(
            "--page-size/--max-pages/--policy/--share-prefix/--evict/"
            "--preempt drive the continuous-batching scheduler; the aligned "
            "generate() path would silently drop them — add --requests N")
    plan = Plan(arch=cfg,
                serve=ServeSpec(prompt_len=a.prompt_len, gen=a.gen,
                                max_batch=a.batch, temperature=a.temperature,
                                page_size=a.page_size, max_pages=a.max_pages,
                                share_prefix=a.share_prefix, evict=a.evict,
                                preempt=a.preempt,
                                kernel_backend=a.kernel_backend),
                run=RunSpec(compute_dtype=a.compute_dtype))
    tracer = Tracer() if a.trace else NULL_TRACER
    eng = Engine(plan, tracer=tracer, device=a.device)

    if a.requests:
        rng = np.random.default_rng(1)

        def deadline(i):
            return int(a.gen * (1 + (a.requests - i))) \
                if a.policy == "deadline" else 0
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
        rep = Scheduler(eng, policy=a.policy).run(reqs)
        if a.trace:
            print(f"trace: {tracer.export(a.trace)}")
        occ, pu = rep.occupancy(), rep.page_utilization()
        print(f"arch={cfg.name} device={a.device} "
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
    print(f"arch={cfg.name} device={a.device} kernels={a.kernel_backend} "
          f"batch={a.batch} prefill({a.prompt_len} tok)="
          f"{rep.prefill_s * 1e3:.1f}ms decode {rep.decode_steps} steps="
          f"{rep.decode_s * 1e3:.1f}ms ({rep.ms_per_token():.1f} ms/tok)")
    print("generated ids[0]:", np.asarray(rep.tokens)[0].tolist())


if __name__ == "__main__":
    main()
