"""Heterogeneous network topology cost model (paper Sections 5, 7; a copy
of repro.dist.topology).

HetPipe's partitioner profiles the network and folds link costs into stage
placement; its experiments run on nodes with fast intra-node interconnect
(NVLink/PCIe) joined by slower Ethernet or InfiniBand. This module models
exactly that two-tier structure with an alpha-beta (latency + bytes/bandwidth)
cost per link, and prices point-to-point transfers and collectives over a
worker fleet.

Workers are string ids ("vw0", ...). The special endpoint "ps" is the
parameter server, hosted on a configurable worker's pod (HetPipe co-locates
PS shards with nodes; `ps_host` models the 'local' placement).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition import DeviceProfile


@dataclass(frozen=True)
class LinkSpec:
    """alpha-beta link: transfer_time(b) = latency + b / bandwidth."""
    name: str
    gbps: float               # payload bandwidth, GB/s
    latency_s: float = 0.0    # per-message latency (alpha)

    def transfer_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.latency_s + nbytes / (self.gbps * 1e9)


# Canonical link classes (order-of-magnitude realistic, not vendor-exact).
NVLINK = LinkSpec("nvlink", 150.0, 2e-6)
PCIE = LinkSpec("pcie", 12.0, 5e-6)
IB_100G = LinkSpec("ib100", 12.5, 2e-5)
ETH_10G = LinkSpec("eth10", 1.25, 1e-4)      # the paper's 10 Gbps Ethernet
ETH_1G = LinkSpec("eth1", 0.125, 1e-4)       # whimpy-cluster 1 GbE
ZERO_LINK = LinkSpec("zero", math.inf, 0.0)


@dataclass(frozen=True)
class Pod:
    """One physical node: a set of workers joined by an intra-node link."""
    name: str
    workers: tuple[str, ...]
    intra: LinkSpec = NVLINK


class ClusterTopology:
    def __init__(self, pods: list[Pod], inter: LinkSpec = ETH_10G,
                 ps_host: str | None = None):
        assert pods, "topology needs at least one pod"
        self.pods = list(pods)
        self.inter = inter
        self.pod_of: dict[str, Pod] = {}
        for p in self.pods:
            for w in p.workers:
                assert w not in self.pod_of, f"duplicate worker {w}"
                self.pod_of[w] = p
        self.ps_host = ps_host or self.pods[0].workers[0]
        assert self.ps_host in self.pod_of, self.ps_host
        self._aliases: dict[str, str] = {}

    def add_alias(self, wid: str, host_wid: str):
        """Map an extra endpoint (e.g. an elastically re-joined worker) onto
        an existing worker's pod."""
        assert host_wid in self.pod_of, host_wid
        self._aliases[wid] = host_wid

    # -- structure --------------------------------------------------------
    def worker_names(self) -> list[str]:
        return [w for p in self.pods for w in p.workers]

    def _resolve(self, endpoint: str) -> Pod:
        if endpoint == "ps":
            endpoint = self.ps_host
        endpoint = self._aliases.get(endpoint, endpoint)
        pod = self.pod_of.get(endpoint)
        if pod is None:
            raise KeyError(f"unknown endpoint {endpoint!r}; "
                           f"workers={self.worker_names()}")
        return pod

    def link(self, a: str, b: str) -> LinkSpec:
        pa, pb = self._resolve(a), self._resolve(b)
        return pa.intra if pa is pb else self.inter

    def path_links(self, names: list[str]) -> list[LinkSpec]:
        """Links between consecutive endpoints — e.g. the boundary links of
        a pipeline whose stage devices are the named workers, in stage
        order. Feed to core.partition.partition_minmax(links=...)."""
        return [self.link(a, b) for a, b in zip(names, names[1:])]

    # -- point-to-point ---------------------------------------------------
    def p2p_cost(self, a: str, b: str, nbytes: float) -> float:
        """Seconds to move nbytes from a to b ('ps' = the parameter server).
        A worker talking to a PS shard hosted on itself costs nothing."""
        if a == b or {a, b} == {"ps", self.ps_host}:
            return 0.0
        return self.link(a, b).transfer_time(nbytes)

    # -- collectives (alpha-beta ring model) ------------------------------
    def _ring_links(self, workers: list[str]) -> list[LinkSpec]:
        W = len(workers)
        return [self.link(workers[i], workers[(i + 1) % W])
                for i in range(W)]

    def _ring_steps_cost(self, workers: list[str], nbytes: float,
                         steps: int) -> float:
        """`steps` ring steps each moving nbytes/W over the slowest hop."""
        W = len(workers)
        if W <= 1 or nbytes <= 0:
            return 0.0
        links = self._ring_links(workers)
        alpha = max(l.latency_s for l in links)
        beta = min(l.gbps for l in links) * 1e9
        chunk = nbytes / W
        return steps * (alpha + chunk / beta)

    def reduce_scatter_cost(self, workers: list[str], nbytes: float) -> float:
        return self._ring_steps_cost(workers, nbytes, len(workers) - 1)

    def all_gather_cost(self, workers: list[str], nbytes: float) -> float:
        return self._ring_steps_cost(workers, nbytes, len(workers) - 1)

    def ring_allreduce_cost(self, workers: list[str], nbytes: float) -> float:
        """Bandwidth-optimal ring: 2(W-1) steps of nbytes/W, gated by the
        slowest hop — on a pod-spanning ring that is the inter-pod link."""
        return self._ring_steps_cost(workers, nbytes, 2 * (len(workers) - 1))

    def hierarchical_allreduce_cost(self, workers: list[str],
                                    nbytes: float) -> float:
        """Pod-local ring reduce + cross-pod leader ring + pod-local
        broadcast: the full vector crosses the slow tier only 2(P-1)/P times
        instead of 2(W-1)/W."""
        by_pod: dict[str, list[str]] = {}
        for w in workers:
            by_pod.setdefault(self._resolve(w).name, []).append(w)
        local = max((self.ring_allreduce_cost(ws, nbytes)
                     for ws in by_pod.values()), default=0.0)
        leaders = [ws[0] for ws in by_pod.values()]
        cross = self.ring_allreduce_cost(leaders, nbytes)
        bcast = max((self.all_gather_cost(ws, nbytes)
                     for ws in by_pod.values() if len(ws) > 1), default=0.0)
        return local + cross + bcast

    def allreduce_cost(self, workers: list[str], nbytes: float,
                       algo: str = "ring") -> float:
        if algo == "ring":
            return self.ring_allreduce_cost(workers, nbytes)
        if algo == "hierarchical":
            return self.hierarchical_allreduce_cost(workers, nbytes)
        raise ValueError(algo)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_fleet(cls, nodes, num_vw: int | None = None,
                   inter: LinkSpec = ETH_10G,
                   node_latency_s: float = 1e-5) -> "ClusterTopology":
        """Build a topology from allocation-style nodes (objects with .gpu
        DeviceProfile and .count). Intra-node bandwidth comes from the
        device profile's link_gbps; virtual worker i is hosted on node
        i % len(nodes) (each VW's PS traffic egresses from one node)."""
        num_vw = len(nodes) if num_vw is None else num_vw
        hosted: list[list[str]] = [[] for _ in nodes]
        for i in range(num_vw):
            hosted[i % len(nodes)].append(f"vw{i}")
        pods = []
        for j, (n, ws) in enumerate(zip(nodes, hosted)):
            gpu: DeviceProfile = n.gpu
            intra = LinkSpec(f"{gpu.name.lower().replace(' ', '-')}-link",
                             gpu.link_gbps, node_latency_s)
            pods.append(Pod(f"node{j}", tuple(ws), intra))
        return cls([p for p in pods if p.workers] or pods[:1], inter=inter)


def stage_links(devices: list[DeviceProfile], inter: LinkSpec = ETH_10G,
                node_latency_s: float = 1e-5) -> list[LinkSpec]:
    """Boundary links for a pipeline over `devices` (stage order), for the
    partitioner's link-aware stage_time.

    Allocation policies hand a VW an *ordered* device list in which
    consecutive devices of the same profile share a node (NP keeps whole
    nodes; ED/HD sort by type), so a profile change at a stage boundary
    means the activation crosses the cluster's inter-node link — the
    paper's profiled-network input to placement (Section 7)."""
    links = []
    for a, b in zip(devices, devices[1:]):
        if a.name == b.name:
            links.append(LinkSpec(
                f"{a.name.lower().replace(' ', '-')}-intra",
                a.link_gbps, node_latency_s))
        else:
            links.append(inter)
    return links


def _split_contiguous(num_vw: int, parts: int) -> list[tuple[str, ...]]:
    return [tuple(f"vw{int(i)}" for i in chunk)
            for chunk in np.array_split(np.arange(num_vw), parts)]


# spec -> one-line description; the parseable grammar for make_topology and
# the source of truth for `--topology list` in the CLI.
TOPOLOGY_SPECS: dict[str, str] = {
    "none":            "no network model (zero-latency default; "
                       "aliases: '', 'zero', 'off')",
    "single":          "one NVLink pod holding every virtual worker",
    "<k>node[:LINK]":  "k NVLink pods joined by LINK: 'eth' (10 GbE, "
                       "default), 'eth1' (whimpy 1 GbE) or 'ib' (100G IB) "
                       "— e.g. '2node', '4node:ib', '2node:eth1'",
    "hetero[-2node]":  "an NVLink pod + a PCIe pod over 10 GbE",
    "paper":           "the paper's 4-node V/R/G/Q fleet (Table 1), intra "
                       "links from the device profiles",
}

_INTER_LINKS = {"": ETH_10G, "eth": ETH_10G, "eth10": ETH_10G,
                "eth1": ETH_1G, "ib": IB_100G}


def topology_help() -> str:
    """Human-readable listing of every accepted --topology spec."""
    width = max(len(k) for k in TOPOLOGY_SPECS)
    return "\n".join(f"  {k:<{width}}  {v}"
                     for k, v in TOPOLOGY_SPECS.items())


def make_topology(spec: str | None, num_vw: int) -> ClusterTopology | None:
    """Parse a CLI/topology spec into a ClusterTopology over vw0..vw{N-1}.

    See TOPOLOGY_SPECS / topology_help() for the grammar. Unknown or
    malformed specs raise ValueError with the full listing rather than
    failing deep inside parsing.
    """
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "none", "zero", "off"):
        return None
    if s == "single":
        return ClusterTopology(
            [Pod("node0", tuple(f"vw{i}" for i in range(num_vw)), NVLINK)])
    if s in ("hetero", "hetero-2node"):
        a, b = _split_contiguous(num_vw, 2)
        return ClusterTopology([Pod("node0", a, NVLINK),
                                Pod("node1", b, PCIE)], inter=ETH_10G)
    if s == "paper":
        from repro_torch.core.allocation import Node
        from repro_torch.core.partition import PAPER_GPUS
        return ClusterTopology.from_fleet(
            [Node(PAPER_GPUS[c], 4) for c in "VRGQ"], num_vw=num_vw)
    if s.endswith("node") or ":" in s:
        base, _, linkname = s.partition(":")
        if linkname not in _INTER_LINKS:
            raise ValueError(
                f"unknown inter-node link {linkname!r} in topology spec "
                f"{spec!r}; expected one of "
                f"{sorted(k for k in _INTER_LINKS if k)}")
        inter = _INTER_LINKS[linkname]
        try:
            k = int(base.removesuffix("node"))
        except ValueError:
            raise ValueError(
                f"malformed topology spec {spec!r}: expected '<k>node' with "
                f"integer k, got {base!r}. Known specs:\n"
                + topology_help()) from None
        if k < 1:
            raise ValueError(
                f"topology spec {spec!r} needs at least one node (k >= 1)")
        groups = _split_contiguous(num_vw, min(k, num_vw))
        pods = [Pod(f"node{j}", g, NVLINK)
                for j, g in enumerate(groups) if g]
        return ClusterTopology(pods, inter=inter)
    raise ValueError(f"unknown topology spec {spec!r}. Known specs:\n"
                     + topology_help())
