"""Named experiment presets: one-line access to the canonical train and
serve scenarios (the threads-backend presets of repro.api.presets, over the
same tiny config).

    from repro_torch.api import Engine, get_preset
    report = Engine(get_preset("single_node")).fit()
    report = Engine(get_preset("serve_tiny")).generate()

get_preset forwards keyword overrides through Plan.replace (double
underscores reach nested specs: get_preset("paper_hetero",
run__max_waves=50, sync__D=4)).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.plan import ClusterSpec, Plan, RunSpec, ServeSpec
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


@preset("serve_tiny")
def serve_tiny() -> Plan:
    """Batched greedy serving on the plain path (prefill + decode through
    Engine.generate(), or continuous batching via repro_torch.api.serving)."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4))


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
