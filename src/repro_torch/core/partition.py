"""Heterogeneity-aware model partitioner (paper Section 7; a copy of
repro.core.partition).

The paper solves min-max stage time with CPLEX; because HetPipe partitions are
*contiguous layer ranges* assigned to a fixed device order, exact dynamic
programming is sufficient: O(L^2 k) over (first l layers, s stages), taking the
paper's position-dependent memory model as a feasibility constraint.

Memory model (paper Section 4): the number of in-flight activation sets at
stage s (1-indexed, k stages) under 1F1B continuous injection is
min(Nm, 2*(k - s) + 1) — stage 1 retains activations across the whole pipeline
round trip, the last stage retires each minibatch immediately.

Costs come from an analytic per-layer performance model (flops / device flops
+ activation bytes / link bandwidth), the TPU analogue of the paper's profiling
+ linear-regression communication model.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    tflops: float            # peak bf16 TFLOP/s
    mem_gb: float            # HBM per device
    link_gbps: float = 50.0  # inter-stage link bandwidth (GB/s)
    mfu: float = 0.45        # achievable fraction of peak in steady state

    @property
    def eff_flops(self) -> float:
        return self.tflops * 1e12 * self.mfu


# TPU production profile + the paper's heterogeneous GPU fleet (Table 1),
# expressed in the same units so the allocation benchmarks can reproduce the
# paper's setting analytically.
TPU_V5E = DeviceProfile("tpu_v5e", 197.0, 16.0, 50.0)
PAPER_GPUS = {
    "V": DeviceProfile("TITAN V", 29.8, 12.0, 15.75),       # fp16 TFLOPs
    "R": DeviceProfile("TITAN RTX", 32.6, 24.0, 15.75),
    "G": DeviceProfile("RTX 2060", 12.9, 6.0, 15.75),
    "Q": DeviceProfile("Quadro P4000", 5.3, 8.0, 15.75),
}


def layer_costs(cfg: ArchConfig, seq_len: int, mb_tokens: int):
    """Per-layer (flops, param_bytes, act_bytes) for one microbatch.

    flops: forward+backward (3x fwd matmul flops, the standard estimate).
    act_bytes: the inter-layer activation (what crosses a stage boundary and
    what 1F1B keeps resident), bf16.
    """
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
    T = mb_tokens
    fl = []
    kinds = cfg.layer_kinds()[: cfg.num_layers]
    for kind in kinds:
        f = 0.0
        if cfg.attn_type != "none" and kind != 2:
            f += 2 * T * d * (H + 2 * KV) * hd          # qkv proj
            f += 2 * T * H * hd * d                     # out proj
            ctx = seq_len if kind == 0 else min(cfg.window_size, seq_len)
            f += 2 * 2 * T * ctx * H * hd               # qk + pv
        if cfg.ssm_type == "rwkv6":
            f += 2 * T * d * d * 5                      # r,k,v,g,o projections
            f += 2 * T * cfg.n_ssm_heads * (d // cfg.n_ssm_heads) ** 2 * 2
        if cfg.ssm_type == "ssd":
            di, N = cfg.d_inner, cfg.ssm_state
            f += 2 * T * d * (2 * di + 2 * N + cfg.n_ssm_heads)
            f += 2 * T * di * d
            f += 2 * T * di * N * 2                     # state in/out
        if cfg.num_experts:
            f += 2 * T * d * cfg.num_experts            # router
            f += 2 * T * cfg.top_k * (d * ff * G + ff * d)
        elif cfg.attn_type != "none":
            f += 2 * T * (d * ff * G + ff * d)
        else:                                           # rwkv channel mix
            f += 2 * T * (d * ff + ff * d + d * d)
        fl.append(3.0 * f)                              # fwd + bwd
    param_b = np.full(cfg.num_layers,
                      (cfg.param_count() - cfg.vocab_size * cfg.d_model *
                       (1 if cfg.tie_embeddings or cfg.frontend != "none"
                        else 2)) / max(cfg.num_layers, 1) * 4.0)
    act_b = np.full(cfg.num_layers, T * d * 2.0)
    return np.array(fl), param_b, act_b


def inflight(stage: int, k: int, nm: int) -> int:
    """In-flight activation sets at `stage` (0-indexed) under 1F1B."""
    return min(nm, 2 * (k - 1 - stage) + 1)


def partition_minmax(flops: np.ndarray, act_bytes: np.ndarray,
                     param_bytes: np.ndarray,
                     devices: list[DeviceProfile], nm: int,
                     *, opt_bytes_per_param: float = 3.0,
                     links: list | None = None, overlap: bool = False):
    """Exact DP min-max contiguous partition of L layers over k ordered devices.

    Returns (boundaries, stage_times, feasible). boundaries[i] = first layer of
    stage i+1; stage i covers layers [boundaries[i-1], boundaries[i]).

    `links` prices each stage boundary with a real link (any object with a
    LinkSpec-style transfer_time(nbytes), e.g. from repro_torch.dist.topology's
    stage_links / ClusterTopology.path_links): links[s] joins stage s to
    s+1, so alpha (per-message latency) and heterogeneous inter-stage
    bandwidth both enter the cut. Without it, the legacy per-device
    link_gbps (pure bandwidth) is used.

    `overlap` makes the stage cost comm/compute-overlap-aware: a stage that
    sends its boundary activation while computing the next microbatch (the
    skewed pipeline schedule) is gated by max(compute, comm) instead of
    their sum — the DP then picks different cuts on overlap-capable
    clusters (it can afford comm-heavy boundaries next to compute-heavy
    stages).
    """
    L, k = len(flops), len(devices)
    if links is not None and len(links) != k - 1:
        raise ValueError(f"links has {len(links)} entries for {k} stages "
                         f"(expected k-1 boundary links)")
    pre_f = np.concatenate([[0.0], np.cumsum(flops)])
    pre_p = np.concatenate([[0.0], np.cumsum(param_bytes)])

    def boundary_comm(b: int, s: int) -> float:
        if b >= L:                                   # last stage sends nothing
            return 0.0
        if links:
            # clamp only for the DP's dead intermediate states (last stage
            # with b < L, never part of the final traceback)
            return links[min(s, len(links) - 1)].transfer_time(
                float(act_bytes[b - 1]))
        return act_bytes[b - 1] / (devices[s].link_gbps * 1e9)

    def stage_time(a: int, b: int, s: int) -> float:
        comp = (pre_f[b] - pre_f[a]) / devices[s].eff_flops
        comm = boundary_comm(b, s)                   # send boundary activation
        return max(comp, comm) if overlap else comp + comm

    def stage_mem(a: int, b: int, s: int) -> float:
        m = (pre_p[b] - pre_p[a]) * (1.0 + opt_bytes_per_param)
        m += float(np.sum(act_bytes[a:b])) * inflight(s, k, nm)
        return m

    INF = float("inf")
    f = np.full((L + 1, k + 1), INF)
    arg = np.full((L + 1, k + 1), -1, np.int64)
    f[0, 0] = 0.0
    for s in range(1, k + 1):
        budget = devices[s - 1].mem_gb * 1e9
        for b in range(s, L - (k - s) + 1):
            best, bj = INF, -1
            for a in range(s - 1, b):
                if f[a, s - 1] == INF:
                    continue
                if stage_mem(a, b, s - 1) > budget:
                    continue
                c = max(f[a, s - 1], stage_time(a, b, s - 1))
                if c < best:
                    best, bj = c, a
            f[b, s], arg[b, s] = best, bj
    feasible = f[L, k] < INF
    if not feasible:
        return None, None, False
    bounds = [L]
    b = L
    for s in range(k, 0, -1):
        b = int(arg[b, s])
        bounds.append(b)
    bounds = bounds[::-1]                            # [0, ..., L]
    times = [stage_time(bounds[i], bounds[i + 1], i) for i in range(k)]
    return bounds, times, True


def max_concurrent_minibatches(cfg: ArchConfig, devices: list[DeviceProfile],
                               seq_len: int, mb_tokens: int,
                               nm_cap: int = 32, **part_kw) -> int:
    """Paper's Max_m: the largest Nm for which a feasible partition exists."""
    fl, pb, ab = layer_costs(cfg, seq_len, mb_tokens)
    best = 0
    for nm in range(1, nm_cap + 1):
        _, _, ok = partition_minmax(fl, ab, pb, devices, nm, **part_kw)
        if ok:
            best = nm
        else:
            break
    return best


def pipeline_throughput(times: list[float], nm: int, schedule: str = "1f1b",
                        *, comm_times: list[float] | None = None,
                        overlap: bool = False):
    """Minibatches/sec of the steady-state pipeline given stage times.

    gpipe: wave of Nm drains per wave -> wave time = (Nm-1)*t_max + sum(t).
    1f1b : continuous injection with Nm in-flight slots -> the pipe saturates
           at 1/t_max once Nm covers the round trip (Nm jobs circulating a
           ring of latency ~sum(t) fwd + bwd).

    When `comm_times` (per-stage boundary-send seconds) is given, the
    effective per-stage time is compute+comm, or max(compute, comm) under the
    overlapped schedule — partition_minmax(..., overlap=...) already folds
    this in, so pass comm_times only for times that are compute-only. A
    k-stage pipeline has k-1 boundaries, so a length-(k-1) vector (e.g. from
    stage_links / path_links) is padded with a free last boundary.
    """
    if comm_times is not None:
        if len(comm_times) == len(times) - 1:
            comm_times = list(comm_times) + [0.0]
        if len(comm_times) != len(times):
            raise ValueError(f"comm_times has {len(comm_times)} entries for "
                             f"{len(times)} stages (expected k or k-1)")
        times = [max(t, c) if overlap else t + c
                 for t, c in zip(times, comm_times)]
    t_max, t_sum = max(times), sum(times)
    if schedule == "gpipe":
        return nm / ((nm - 1) * t_max + t_sum)
    return min(1.0 / t_max, nm / (2.0 * t_sum))
