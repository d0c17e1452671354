"""Named experiment presets: one-line access to the canonical train and
serve scenarios (the presets of repro.api.presets, over the same tiny
config).

    from repro_torch.api import Engine, get_preset
    report = Engine(get_preset("single_node")).fit()
    report = Engine(get_preset("serve_tiny")).generate()

get_preset forwards keyword overrides through Plan.replace (double
underscores reach nested specs: get_preset("paper_hetero",
run__max_waves=50, sync__D=4)).

    python -m repro_torch.api.presets                  # list presets
    python -m repro_torch.api.presets --run NAME [--device cpu]
                                                       # run one end to end
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.plan import (ClusterSpec, PartitionSpec, Plan,
                                  ReplicaSpec, RunSpec, ServeSpec)
from repro_torch.api.sync import BSP, WSP

PRESETS: dict[str, Callable[[], Plan]] = {}


def preset(name: str):
    def deco(fn: Callable[[], Plan]):
        PRESETS[name] = fn
        return fn
    return deco


def list_presets() -> dict[str, str]:
    """name -> first docstring line."""
    return {n: (fn.__doc__ or "").strip().splitlines()[0]
            for n, fn in PRESETS.items()}


def get_preset(name: str, **overrides) -> Plan:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    plan = PRESETS[name]()
    return plan.replace(**overrides) if overrides else plan


def _tiny_arch(name: str = "qwen3-0.6b", **over):
    """qwen3-0.6b cut down to 2 layers and width 32 (repro's _tiny_arch)."""
    from repro_torch.configs import ARCHS, reduced
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_heads=2, num_kv_heads=2, head_dim=16,
                num_microbatches=2)
    base.update(over)
    return reduced(ARCHS[name], **base)


@preset("single_node")
def single_node() -> Plan:
    """Two virtual workers on one NVLink node, WSP D=1 — the quickstart."""
    return Plan(arch=_tiny_arch(),
                cluster=ClusterSpec(num_vw=2, topology="single"),
                sync=WSP(D=1),
                run=RunSpec(max_waves=15, batch=8, seq=32))


@preset("paper_hetero")
def paper_hetero() -> Plan:
    """The paper's 4-node V/R/G/Q fleet: 4 VWs, WSP D=2, async push."""
    return Plan(arch=_tiny_arch(),
                cluster=ClusterSpec(num_vw=4, topology="paper"),
                sync=WSP(D=2, pull_every=2, async_push=True),
                run=RunSpec(max_waves=12, batch=8, seq=32))


@preset("whimpy_1gbe")
def whimpy_1gbe() -> Plan:
    """A whimpy heterogeneous pair: NVLink + PCIe nodes over 1 GbE,
    compressed pushes overlapping the next wave's compute."""
    from repro_torch.dist.topology import (ClusterTopology, ETH_1G, NVLINK,
                                           PCIE, Pod)
    topo = ClusterTopology([Pod("node0", ("vw0",), NVLINK),
                            Pod("node1", ("vw1",), PCIE)], inter=ETH_1G)
    return Plan(arch=_tiny_arch(),
                cluster=ClusterSpec(num_vw=2, topology=topo,
                                    time_scale=1e-3),
                sync=WSP(D=2, pull_every=4, async_push=True),
                run=RunSpec(max_waves=12, batch=8, seq=32,
                            codec="topk:0.25"))


@preset("bsp_baseline")
def bsp_baseline() -> Plan:
    """The AllReduce-BSP baseline ("Horovod" analogue) on a 2-node ring."""
    return Plan(arch=_tiny_arch(),
                cluster=ClusterSpec(num_vw=2, topology="2node"),
                sync=BSP(),
                run=RunSpec(max_waves=12, batch=8, seq=32))


@preset("spmd_tiny")
def spmd_tiny() -> Plan:
    """The pipelined spmd wave path on a 1x1x1 mesh (one slot; grow
    data/stages/tp, the slots wrapping over the card)."""
    return Plan(arch=_tiny_arch(stages=1, tp=1),
                partition=PartitionSpec(stages=1, tp=1, data=1),
                sync=WSP(D=0),
                run=RunSpec(backend="spmd", max_waves=8, batch=8, seq=32))


@preset("serve_tiny")
def serve_tiny() -> Plan:
    """Batched greedy serving on the plain path (prefill + decode through
    Engine.generate(), or continuous batching via repro_torch.api.serving)."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4))


@preset("serve_spmd")
def serve_spmd() -> Plan:
    """The pipelined serve steps on a (1, 2, 1) mesh (its slots wrap over
    the Engine's device)."""
    return Plan(arch=_tiny_arch(num_layers=2),
                partition=PartitionSpec(stages=2, tp=1, data=1),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4),
                run=RunSpec(backend="spmd"))


@preset("serve_paged")
def serve_paged() -> Plan:
    """Paged-KV continuous batching: 4-token pages from a pool sized below
    the worst case."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, max_pages=12))


@preset("serve_kernels")
def serve_kernels() -> Plan:
    """Paged continuous batching on the Hopper kernels: decode walks the KV
    pool through the block table inside flash_decode_paged, prefill runs
    flash_attention_fwd (their plain versions on CPU tensors)."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, max_pages=12,
                                kernel_backend="cuda"))


@preset("serve_shared")
def serve_shared() -> Plan:
    """Prefix-shared paged serving under memory pressure: identical
    prompts map onto refcounted shared pages (repro_torch.serve.memory),
    cold indexed pages are reclaimed LRU-first, and in-flight requests are
    preempted + replayed instead of refusing admission — the pool is
    sized below what unshared admission would need."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, max_pages=10,
                                share_prefix=True, evict=True,
                                preempt=True))


@preset("serve_cluster")
def serve_cluster() -> Plan:
    """Scale-out serving, HetPipe-style: one big + two whimpy replicas
    behind the topology-priced Router (repro_torch.serve.router). Requests
    sharing a page-aligned prefix stick to one replica's prefix index;
    everything else spreads by load priced with the 'hetero' topology's
    alpha-beta link costs."""
    return Plan(arch=_tiny_arch(),
                partition=PartitionSpec(data=3),
                cluster=ClusterSpec(topology="hetero"),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, share_prefix=True,
                                replicas=(ReplicaSpec(max_batch=4),
                                          ReplicaSpec(max_batch=2),
                                          ReplicaSpec(max_batch=2))))


def _demo_requests(plan: Plan, rng, n: int, *, shared: int = 0):
    """`shared` requests repeating one full prompt at half the budget, then
    n - shared of random lengths and budgets (the demos' traffic)."""
    import numpy as np

    from repro_torch.api.serving import Request
    sv, vocab = plan.serve, plan.arch.vocab_size
    common = rng.integers(0, vocab, sv.prompt_len, dtype=np.int32) \
        if shared else None
    reqs = [Request(rid=i, prompt=common.copy(),
                    max_new_tokens=max(1, sv.gen // 2))
            for i in range(shared)]
    reqs += [Request(rid=i,
                     prompt=rng.integers(0, vocab,
                                         int(rng.integers(2,
                                                          sv.prompt_len + 1)),
                                         dtype=np.int32),
                     max_new_tokens=int(rng.integers(1, sv.gen + 1)))
             for i in range(shared, n)]
    return reqs


def main(argv=None):
    import argparse

    import numpy as np

    from repro_torch.api.engine import Engine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default=None, metavar="NAME",
                    help="build the named preset and run it end to end")
    ap.add_argument("--waves", type=int, default=0,
                    help="override the preset's max_waves")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the preset runs; on cpu the kernel backend "
                         "runs the kernels' plain PyTorch versions")
    a = ap.parse_args(argv)
    if a.run is None:
        width = max(len(n) for n in PRESETS)
        for n, doc in list_presets().items():
            print(f"  {n:<{width}}  {doc}")
        return 0
    plan = get_preset(a.run, **({"run__max_waves": a.waves} if a.waves
                                else {}))
    print(plan.describe())
    rng = np.random.default_rng(0)
    if plan.serve is not None and plan.partition.data > 1:
        # cluster presets demo the Router: shared-prefix traffic sticks
        # to one replica's prefix index, the rest spreads by load
        from repro_torch.serve.router import Router
        reqs = _demo_requests(plan, rng, 12, shared=4)
        rep = Router(plan, device=a.device).run(reqs)
        assert rep.tokens_out == sum(r.max_new_tokens for r in reqs)
        assert rep.failed_requests == 0, rep.failed_requests
        assert rep.router["affinity_hits"] > 0, rep.router
        assert rep.prefix_hit_tokens > 0, rep.prefix_hit_tokens
        print(f"replicas={rep.router['replicas']} requests={len(reqs)} "
              f"tokens={rep.tokens_out} "
              f"dispatches={rep.router['dispatches']} "
              f"affinity_hits={rep.router['affinity_hits']} "
              f"prefix_hit={rep.prefix_hit_tokens} tok "
              f"throughput={rep.tokens_per_s():.1f} tok/s")
        print("OK")
        return 0
    if plan.serve is not None:
        sv = plan.serve
        if sv.page_size:
            # paged presets demo the continuous-batching Scheduler with
            # mixed prompt lengths and budgets (the paged pool's point);
            # the shared preset instead repeats one full prompt so the
            # prefix index has something to hit
            from repro_torch.api.serving import Scheduler
            n = 2 * sv.max_batch
            reqs = _demo_requests(plan, rng, n,
                                  shared=n if sv.share_prefix else 0)
            rep = Scheduler(Engine(plan, device=a.device)).run(reqs)
            assert rep.tokens_out == sum(r.max_new_tokens for r in reqs)
            pu = rep.page_utilization()
            print(f"requests={len(reqs)} tokens={rep.tokens_out} "
                  f"pages={rep.peak_pages}/{rep.pages_total}"
                  f"(x{rep.page_size} tok) "
                  f"util={0.0 if pu is None else pu:.2f} "
                  f"throughput={rep.tokens_per_s():.1f} tok/s")
            if sv.share_prefix:
                assert rep.prefix_hit_tokens > 0
                assert rep.admit_blocked == 0, rep.admit_blocked
                print(f"memory: prefix_hit={rep.prefix_hit_tokens} tok "
                      f"shared={rep.pages_shared} cow={rep.cow_copies} "
                      f"evictions={rep.evictions} "
                      f"preemptions={rep.preemptions}")
            print("OK")
            return 0
        rep = Engine(plan, device=a.device).generate()
        assert rep.tokens.shape == (sv.max_batch, sv.gen), rep.tokens.shape
        print(f"batch={sv.max_batch} prefill({sv.prompt_len} tok)="
              f"{rep.prefill_s*1e3:.1f}ms decode={rep.ms_per_token():.1f}"
              f"ms/tok throughput={rep.tokens_per_s():.1f} tok/s")
        print("generated ids[0]:", rep.tokens[0].tolist())
        print("OK")
        return 0
    report = Engine(plan, device=a.device).fit()
    _, loss = report.loss_curve()
    print(f"waves={report.waves} wall={report.wall_s:.1f}s "
          f"loss {loss[0]:.3f} -> {np.mean(loss[-4:]):.3f}")
    assert np.mean(loss[-4:]) < loss[0], "did not learn"
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
