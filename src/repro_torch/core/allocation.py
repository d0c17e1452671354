"""Resource allocation policies (paper Section 8.1; a copy of
repro.core.allocation): map a heterogeneous
device fleet onto virtual workers.

  NP (Node Partition)     — one node per VW (homogeneous VW, straggler-prone)
  ED (Equal Distribution) — every VW gets one device of each type
  HD (Hybrid Distribution)— pair strong+weak types so VW aggregate
                            compute/memory is balanced

The allocator returns per-VW ordered device lists (pipeline stage order) plus
an analytic straggler report; the partitioner (core.partition) then cuts the
model per VW. On a homogeneous TPU pod every policy degenerates to equal
slices — heterogeneity enters via device profiles (mixed fleets, degraded
nodes), which the threaded runtime can also simulate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition import (DeviceProfile, layer_costs,
                                  partition_minmax, pipeline_throughput)


@dataclass(frozen=True)
class Node:
    gpu: DeviceProfile
    count: int


def allocate(nodes: list[Node], policy: str, num_vw: int | None = None):
    """Returns list of VWs, each an ordered list of DeviceProfile."""
    if num_vw is None:
        num_vw = len(nodes)
    if policy == "NP":
        assert num_vw == len(nodes)
        return [[n.gpu] * n.count for n in nodes]
    per_vw = sum(n.count for n in nodes) // num_vw
    if policy == "ED":
        pool = [n.gpu for n in nodes for _ in range(n.count)]
        vws = [[] for _ in range(num_vw)]
        for i, g in enumerate(pool):
            vws[i % num_vw].append(g)
        return [sorted(vw, key=lambda g: -g.tflops) for vw in vws]
    if policy == "HD":
        # paper Table 3: pair the i-th strongest type with the i-th weakest
        # (VVQQ / RRGG) so per-VW aggregate compute+memory is balanced
        order = sorted(nodes, key=lambda n: -n.gpu.tflops)
        vws = []
        half = per_vw // 2
        for j in range(len(order) // 2):
            a, b = order[j], order[len(order) - 1 - j]
            pool_a = [a.gpu] * a.count
            pool_b = [b.gpu] * b.count
            while pool_a or pool_b:
                vw = [pool_a.pop() for _ in range(min(half, len(pool_a)))]
                vw += [pool_b.pop() for _ in
                       range(min(per_vw - len(vw), len(pool_b)))]
                while len(vw) < per_vw and pool_a:
                    vw.append(pool_a.pop())
                vws.append(vw)
        assert len(vws) == num_vw, (len(vws), num_vw)
        return vws
    raise ValueError(policy)


def vw_throughputs(cfg, vws, seq_len: int, mb_tokens: int, nm: int,
                   schedule: str = "1f1b", *, inter=None,
                   overlap: bool = False):
    """Analytic per-VW minibatch throughput under the min-max partition.

    `inter` (a repro.dist.topology.LinkSpec) prices each stage boundary with
    real links via stage_links — consecutive same-profile devices share a
    node, a profile change crosses `inter`. `overlap` gates each stage at
    max(compute, comm) instead of the sum (the skewed pipeline schedule)."""
    if inter is not None:
        from repro_torch.dist.topology import stage_links
    out = []
    fl, pb, ab = layer_costs(cfg, seq_len, mb_tokens)
    for vw in vws:
        links = stage_links(vw, inter) if inter is not None else None
        res = partition_minmax(fl, ab, pb, vw, nm, links=links,
                               overlap=overlap)
        if not res[2]:
            out.append(0.0)
            continue
        _, times, _ = res
        out.append(pipeline_throughput(times, nm, schedule))
    return np.array(out)


def straggler_report(throughputs: np.ndarray) -> dict:
    t = throughputs[throughputs > 0]
    if len(t) == 0:
        return {"feasible": False}
    return {
        "feasible": True,
        "min": float(t.min()), "max": float(t.max()),
        "imbalance": float(t.max() / t.min()),
        # BSP DP rate is gated by the slowest VW; WSP(D>0) approaches the mean
        "bsp_rate": float(len(t) * t.min()),
        "wsp_rate": float(t.sum()),
    }


def straggler_report_comm(throughputs: np.ndarray, topology,
                          bytes_per_wave: float) -> dict:
    """Comm-aware straggler report: each VW's wave time gains the modeled
    cost of pushing its wave delta to the parameter server over its link
    (repro.dist.topology). A VW on a slow inter-node link can become the
    straggler even when compute is balanced — the paper's motivation for
    folding the profiled network into placement (Section 7)."""
    th = np.asarray(throughputs, np.float64)
    comm = np.array([topology.p2p_cost(f"vw{i}", "ps", bytes_per_wave)
                     for i in range(len(th))])
    eff = np.where(th > 0, 1.0 / (1.0 / np.where(th > 0, th, 1.0) + comm),
                   0.0)
    rep = straggler_report(eff)
    rep["comm_seconds"] = [float(c) for c in comm]
    rep["compute_only"] = straggler_report(th)
    return rep
