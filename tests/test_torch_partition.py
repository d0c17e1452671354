"""The partitioner's remainder: every case of tests/test_partition.py against
the port's core.partition, each beside the JAX package's result on the same
inputs (cuts equal, stage times and throughputs equal floats); the
allocation half of tests/test_data_optim.py; the paper models' cost tables
(models/cnn.py, configs/paper_models.py) and the tiny conv net against
the JAX package's."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.paper_models import PAPER_MODEL_COSTS as J_COSTS
from repro.core import allocation as jalloc
from repro.core import partition as jpart
from repro.dist import topology as jtopo
from repro.models import cnn as jcnn
from repro_torch.configs import ARCHS
from repro_torch.configs.paper_models import PAPER_MODEL_COSTS
from repro_torch.core.allocation import (Node, allocate, straggler_report,
                                         vw_throughputs)
from repro_torch.core.partition import (DeviceProfile, PAPER_GPUS,
                                        inflight, layer_costs,
                                        max_concurrent_minibatches,
                                        partition_minmax,
                                        pipeline_throughput)
from repro_torch.dist.topology import ETH_1G, LinkSpec, make_topology
from repro_torch.models import cnn


def _jdevs(devs):
    return [jpart.DeviceProfile(d.name, d.tflops, d.mem_gb,
                                mfu=d.mfu, link_gbps=d.link_gbps)
            for d in devs]


def _jlinks(links):
    return None if links is None else [
        jtopo.LinkSpec(l.name, l.gbps, l.latency_s) for l in links]


def both(flops, act, par, devs, nm, links=None, overlap=False):
    """partition_minmax of the port and of the JAX package on the same
    inputs, asserted equal (cuts, stage times, feasibility); returns the
    port's."""
    got = partition_minmax(flops, act, par, devs, nm=nm, links=links,
                           overlap=overlap)
    want = jpart.partition_minmax(flops, act, par, _jdevs(devs), nm=nm,
                                  links=_jlinks(links), overlap=overlap)
    assert list(got[0]) == list(want[0])
    assert list(got[1]) == list(want[1])
    assert got[2] == want[2]
    return got


def brute_force(flops, act, par, devices, nm):
    L, k = len(flops), len(devices)
    best, best_bounds = np.inf, None
    pre_f = np.concatenate([[0.0], np.cumsum(flops)])
    pre_p = np.concatenate([[0.0], np.cumsum(par)])

    def stage_time(a, b, s):
        d = devices[s]
        t = (pre_f[b] - pre_f[a]) / d.eff_flops
        if b < L:
            t += act[b - 1] / (d.link_gbps * 1e9)
        return t

    def stage_mem(a, b, s):
        return (pre_p[b] - pre_p[a]) * 4.0 + float(np.sum(act[a:b])) * \
            inflight(s, k, nm)

    for cuts in itertools.combinations(range(1, L), k - 1):
        bounds = [0, *cuts, L]
        ok = all(stage_mem(bounds[i], bounds[i + 1], i)
                 <= devices[i].mem_gb * 1e9 for i in range(k))
        if not ok:
            continue
        t = max(stage_time(bounds[i], bounds[i + 1], i) for i in range(k))
        if t < best:
            best, best_bounds = t, bounds
    return best, best_bounds


# the seeded cases of tests/test_partition.py, drawn the same way
_DP_CASES = [(int(r.integers(4, 10)), int(r.integers(2, 5)),
              int(r.integers(0, 10_000)))
             for r in [np.random.default_rng(7)] for _ in range(60)]


@pytest.mark.parametrize("L,k,seed", _DP_CASES)
def test_dp_matches_brute_force(L, k, seed):
    if k > L:
        return
    rng = np.random.default_rng(seed)
    flops = rng.uniform(1e9, 1e12, L)
    act = rng.uniform(1e5, 1e7, L)
    par = rng.uniform(1e6, 1e8, L)
    devices = [DeviceProfile(f"d{i}", rng.uniform(5, 200), rng.uniform(4, 24))
               for i in range(k)]
    bf_t, bf_bounds = brute_force(flops, act, par, devices, nm=2)
    bounds, times, ok = both(flops, act, par, devices, nm=2)
    if bf_bounds is None:
        assert not ok
    else:
        assert ok
        assert np.isclose(max(times), bf_t, rtol=1e-9)


def test_layer_costs_equal_the_reference():
    for name in ("qwen3-0.6b", "granite-moe-1b-a400m", "hymba-1.5b",
                 "rwkv6-3b"):
        got = layer_costs(ARCHS[name], 4096, 4 * 4096)
        want = jpart.layer_costs(J_ARCHS[name], 4096, 4 * 4096)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_memory_constraints_respected():
    fl, pb, ab = layer_costs(ARCHS["qwen3-0.6b"], 4096, 4 * 4096)
    devs = [PAPER_GPUS[c] for c in "VRGQ"]
    bounds, _, ok = both(fl, ab, pb, devs, nm=4)
    assert ok
    k = len(devs)
    for s in range(k):
        a, b = bounds[s], bounds[s + 1]
        mem = np.sum(pb[a:b]) * 4.0 + np.sum(ab[a:b]) * inflight(s, k, 4)
        assert mem <= devs[s].mem_gb * 1e9


def test_hetero_gives_fast_devices_more_layers():
    L = 16
    flops = np.full(L, 1e12)
    act = np.full(L, 1.0)          # negligible comm
    par = np.full(L, 1e6)
    fast = DeviceProfile("fast", 100.0, 64.0)
    slow = DeviceProfile("slow", 10.0, 64.0)
    bounds, times, ok = both(flops, act, par, [fast, slow], nm=2)
    assert ok
    assert bounds[1] - bounds[0] > bounds[2] - bounds[1]


def test_position_dependent_memory_model():
    assert inflight(0, 4, 8) > inflight(3, 4, 8)
    assert inflight(3, 4, 8) == 1
    for k, nm in ((4, 8), (3, 2), (8, 16)):
        assert [inflight(s, k, nm) for s in range(k)] == \
            [jpart.inflight(s, k, nm) for s in range(k)]


def test_link_aware_stage_time_prices_alpha_beta():
    L = 8
    flops = np.full(L, 1e12)
    act = np.full(L, 1e6)
    par = np.full(L, 1e6)
    devs = [DeviceProfile("d", 100.0, 64.0, link_gbps=50.0)] * 2
    slow = [LinkSpec("slow", 0.001, 0.5)]          # 1 MB/s + 0.5 s alpha
    _, t_fast, ok1 = both(flops, act, par, devs, nm=2)
    _, t_slow, ok2 = both(flops, act, par, devs, nm=2, links=slow)
    assert ok1 and ok2
    assert max(t_slow) > max(t_fast) + 0.4


def test_overlap_stage_time_is_max_of_compute_and_comm():
    L, k = 4, 2
    flops = np.full(L, 1e12)
    act = np.full(L, 1e6)
    par = np.full(L, 1e6)
    devs = [DeviceProfile("d", 100.0, 64.0)] * k
    link = [LinkSpec("wan", 0.01, 0.0)]            # 0.1 s per boundary send
    _, t_serial, _ = both(flops, act, par, devs, nm=2, links=link)
    b_o, t_over, _ = both(flops, act, par, devs, nm=2, links=link,
                          overlap=True)
    comm = link[0].transfer_time(act[0])
    comp0 = sum(flops[b_o[0]:b_o[1]]) / devs[0].eff_flops
    assert max(t_over) <= max(t_serial)
    assert t_over[0] == pytest.approx(max(comp0, comm))
    assert b_o[0] == 0 and b_o[-1] == L


def test_overlap_aware_dp_moves_cuts():
    L = 12
    flops = np.full(L, 1e12)
    act = np.full(L, 1e6)
    par = np.full(L, 1e6)
    devs = [DeviceProfile("d", 100.0, 64.0)] * 2
    link = [LinkSpec("wan", act[0] / (flops[0] / devs[0].eff_flops) / 1e9,
                     0.0)]
    b_s, t_s, _ = both(flops, act, par, devs, nm=2, links=link)
    b_o, t_o, _ = both(flops, act, par, devs, nm=2, links=link, overlap=True)
    assert max(t_o) < max(t_s)
    assert b_s != b_o


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pipeline_throughput_comm_times_and_path_links(schedule):
    comp, comm = [1.0, 1.0], [0.5, 0.0]
    serial = pipeline_throughput(comp, 4, schedule, comm_times=comm)
    over = pipeline_throughput(comp, 4, schedule, comm_times=comm,
                               overlap=True)
    assert serial == jpart.pipeline_throughput(comp, 4, schedule,
                                               comm_times=comm)
    assert over == jpart.pipeline_throughput(comp, 4, schedule,
                                             comm_times=comm, overlap=True)
    if schedule == "1f1b":
        assert serial == pytest.approx(min(1 / 1.5, 4 / (2 * 2.5)))
        assert over == pytest.approx(min(1 / 1.0, 4 / (2 * 2.0)))
    assert over > serial
    links = make_topology("hetero", 4).path_links(
        ["vw0", "vw1", "vw2", "vw3"])
    assert [l.name for l in links] == ["nvlink", "eth10", "pcie"]
    assert [l.name for l in jtopo.make_topology("hetero", 4).path_links(
        ["vw0", "vw1", "vw2", "vw3"])] == ["nvlink", "eth10", "pcie"]
    L = 6
    bounds, times, ok = both(np.full(L, 1e12), np.full(L, 1e6),
                             np.full(L, 1e6),
                             [DeviceProfile("d", 100.0, 64.0)] * 3, nm=2,
                             links=links[:2])
    assert ok and len(times) == 3


def test_vw_throughputs_overlap_and_links():
    cfg, jcfg = ARCHS["qwen3-0.6b"], J_ARCHS["qwen3-0.6b"]
    vws = [[PAPER_GPUS["V"]] * 2 + [PAPER_GPUS["Q"]] * 2]
    jvws = [[jpart.PAPER_GPUS["V"]] * 2 + [jpart.PAPER_GPUS["Q"]] * 2]
    jeth = jtopo.ETH_1G
    runs = {}
    for tag, kw, jkw in (("base", {}, {}),
                         ("linked", dict(inter=ETH_1G), dict(inter=jeth)),
                         ("over", dict(inter=ETH_1G, overlap=True),
                          dict(inter=jeth, overlap=True))):
        runs[tag] = vw_throughputs(cfg, vws, 4096, 4 * 4096, nm=4, **kw)
        np.testing.assert_array_equal(
            runs[tag], jalloc.vw_throughputs(jcfg, jvws, 4096, 4 * 4096,
                                             nm=4, **jkw))
    assert runs["base"][0] > 0
    assert runs["linked"][0] < runs["base"][0]
    assert runs["over"][0] >= runs["linked"][0]


def test_max_m_shrinks_with_memory():
    cfg, jcfg = ARCHS["qwen3-0.6b"], J_ARCHS["qwen3-0.6b"]
    got = {}
    for name, mem in (("big", 24.0), ("tiny", 0.05)):
        devs = [DeviceProfile(name, 100, mem)] * 4
        got[name] = max_concurrent_minibatches(cfg, devs, 4096, 4 * 4096,
                                               nm_cap=8)
        assert got[name] == jpart.max_concurrent_minibatches(
            jcfg, _jdevs(devs), 4096, 4 * 4096, nm_cap=8)
    assert got["big"] >= got["tiny"]


# -- allocation (the allocation half of tests/test_data_optim.py) ---------
def _alloc_both(policy):
    nodes = [Node(PAPER_GPUS[c], 4) for c in "VRGQ"]
    jnodes = [jalloc.Node(jpart.PAPER_GPUS[c], 4) for c in "VRGQ"]
    vws = allocate(nodes, policy)
    jvws = jalloc.allocate(jnodes, policy)
    assert [[g.name for g in vw] for vw in vws] == \
        [[g.name for g in vw] for vw in jvws]
    return vws, jvws


def test_allocation_policies_paper_table3():
    cfg, jcfg = ARCHS["h2o-danube-1.8b"], J_ARCHS["h2o-danube-1.8b"]
    rep, ths = {}, {}
    for pol in ("NP", "ED", "HD"):
        vws, jvws = _alloc_both(pol)
        assert len(vws) == 4 and all(len(v) == 4 for v in vws)
        th = vw_throughputs(cfg, vws, 4096, 4 * 4096, nm=4)
        jth = jalloc.vw_throughputs(jcfg, jvws, 4096, 4 * 4096, nm=4)
        np.testing.assert_array_equal(th, jth)
        rep[pol], ths[pol] = straggler_report(th), th
        assert rep[pol] == jalloc.straggler_report(jth)
    assert (ths["NP"] == 0).sum() >= 1
    assert rep["ED"]["imbalance"] < 1.01
    assert (ths["HD"] > 0).all() and rep["HD"]["imbalance"] < 1.15
    assert rep["NP"]["wsp_rate"] > rep["NP"]["bsp_rate"]
    assert rep["HD"]["wsp_rate"] >= rep["HD"]["bsp_rate"]


def test_allocation_ed_same_multiset():
    vws, _ = _alloc_both("ED")
    names = [tuple(sorted(g.name for g in vw)) for vw in vws]
    assert len(set(names)) == 1                  # identical VW composition


# -- the paper's models ----------------------------------------------------
@pytest.mark.parametrize("name", ["vgg19", "resnet152"])
@pytest.mark.parametrize("batch", [32, 8])
def test_paper_model_cost_tables_equal_the_reference(name, batch):
    assert sorted(PAPER_MODEL_COSTS) == sorted(J_COSTS) == \
        sorted(cnn.PAPER_MODELS)
    got = PAPER_MODEL_COSTS[name](batch)
    want = J_COSTS[name](batch)
    assert cnn.PAPER_MODELS[name] is PAPER_MODEL_COSTS[name]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert cnn.VGG19_CFG == jcnn.VGG19_CFG


def test_paper_models_partition_as_the_reference():
    """The partitioner on the paper's own models over the paper's GPUs:
    the port's cuts and stage times equal the JAX package's."""
    for name in ("vgg19", "resnet152"):
        fl, pb, ab = PAPER_MODEL_COSTS[name](32)
        both(fl, ab, pb, [PAPER_GPUS[c] for c in "VRGQ"], nm=4)


@pytest.mark.parametrize("width,classes", [(8, 10), (4, 3)])
def test_tiny_cnn_logits_equal_the_reference(width, classes):
    jp = jcnn.init_tiny_cnn(jax.random.PRNGKey(width), classes, width)
    x = np.random.default_rng(width).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jcnn.tiny_cnn_apply(jp, x))
    p = cnn.cnn_params_from_numpy(jax.device_get(jp), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    got = cnn.tiny_cnn_apply(p, torch.from_numpy(x)).numpy()
    assert got.shape == (5, classes)
    # within 1e-6 of the logits' scale: the two frameworks sum the convs
    # and the 1024-long head product in other orders, and each lands ~1e-6
    # (absolute, at |logits| ~3) from the float64 result
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-6 * scale
    # the port's own init: the JAX package's leaves, shapes and scale
    own = cnn.init_tiny_cnn(torch.Generator().manual_seed(0), classes, width)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert float(own["b"].abs().max()) == 0.0
    assert 0.05 < float(own["c2"].std()) < 0.15
