"""The port's WSP clock, parameter server, codecs, collectives, topology and
transport against the JAX package's (numpy on both sides, so results are
compared exactly unless stated)."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import wsp as jwsp
from repro.core.param_server import ParameterServer as JParameterServer
from repro.dist import collectives as jcoll
from repro.dist import compression as jcomp
from repro.dist.topology import make_topology as j_make_topology
from repro.dist.transport import SimulatedTransport as JSimulatedTransport
from repro_torch.core import tree as tree_lib
from repro_torch.core.allocation import Node, straggler_report_comm
from repro_torch.core.param_server import ParameterServer
from repro_torch.core.partition import PAPER_GPUS
from repro_torch.core.wsp import (StalenessViolation, WSPClockServer,
                                  WSPClockState)
from repro_torch.dist import collectives
from repro_torch.dist.compression import (ErrorFeedbackCompressor,
                                          Int8StochasticQuantizer,
                                          make_codec, topk_compress,
                                          topk_decompress)
from repro_torch.dist.topology import (ClusterTopology, ETH_1G, ETH_10G,
                                       IB_100G, LinkSpec, NVLINK, PCIE,
                                       make_topology)
from repro_torch.dist.transport import NullTransport, SimulatedTransport

# -- tree order ------------------------------------------------------------


def test_flatten_order_and_paths_match_jax():
    """Sorted dict keys at every level, sequences in order, None empty —
    jax.tree's order and jax.tree_util's key paths."""
    t = {"zeta": {"b": 1, "a": [2, {"y": 3, "x": 4}]}, "alpha": (5, None),
         "mid": 6, "blocks": {"wq": 7, "ln1": 8, "mlp_wi": 9}}
    assert tree_lib.leaves(t) == jax.tree.leaves(t)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert [p for p, _ in tree_lib.flatten_with_path(t)] == jpaths
    doubled = tree_lib.tree_map(lambda v: 2 * v, t)
    assert jax.tree.leaves(doubled) == [2 * v for v in jax.tree.leaves(t)]
    assert list(doubled) == list(t)            # the caller's key order kept
    with pytest.raises(ValueError):
        tree_lib.tree_map(lambda a, b: a, t, {"one": 1})


# -- WSP clock (the cases of test_wsp.py, each also run by the JAX copy) ---

_R = np.random.default_rng(11)
_SCHED_CASES = [(int(_R.integers(2, 7)), int(_R.integers(0, 5)),
                 [int(x) for x in _R.integers(0, 6, int(_R.integers(1, 201)))])
                for _ in range(200)]
_ND_CASES = sorted({(int(_R.integers(2, 6)), int(_R.integers(0, 4)))
                    for _ in range(50)})


@pytest.mark.parametrize("n,D,schedule", _SCHED_CASES)
def test_staleness_bound_never_violated(n, D, schedule):
    """Under any admissible schedule the distance stays <= D + 1, a blocked
    worker is more than D ahead, and the JAX clock takes the same
    decisions."""
    s, j = WSPClockState(D), jwsp.WSPClockState(D)
    for i in range(n):
        s.add_worker(f"w{i}")
        j.add_worker(f"w{i}")
    for pick in schedule:
        wid = f"w{pick % n}"
        assert s.can_proceed(wid) == j.can_proceed(wid)
        if s.can_proceed(wid):
            s.complete_wave(wid)
            j.complete_wave(wid)
            assert s.max_distance() <= D + 1
        else:
            assert s.clocks[wid] - s.global_clock() > D
            with pytest.raises(StalenessViolation):
                s.complete_wave(wid)
    assert s.clocks == j.clocks


@pytest.mark.parametrize("n,D", _ND_CASES)
def test_fastest_worker_gets_blocked(n, D):
    s = WSPClockState(D)
    for i in range(n):
        s.add_worker(f"w{i}")
    done = 0
    while s.can_proceed("w0") and done < D + 5:
        s.complete_wave("w0")
        done += 1
    assert done == D + 1


@pytest.mark.parametrize("n,D", _ND_CASES)
def test_elastic_remove_unblocks(n, D):
    s = WSPClockState(D)
    for i in range(n):
        s.add_worker(f"w{i}")
    for _ in range(D + 1):
        s.complete_wave("w0")
    assert not s.can_proceed("w0")
    for i in range(1, n):
        s.remove_worker(f"w{i}")
    assert s.can_proceed("w0")


def test_rejoin_starts_at_global_clock_and_at_clock_gate():
    s = WSPClockState(1)
    s.add_worker("a")
    s.add_worker("b")
    for _ in range(2):
        s.complete_wave("a")
        s.complete_wave("b")
    s.remove_worker("b")
    s.complete_wave("a")
    s.add_worker("b2")
    assert s.clocks["b2"] == s.global_clock()
    assert s.can_proceed("b2")
    # the logical-clock gate of an async pusher: at D 1 a wave-c start
    # needs the global clock (3) at c - 1 or more
    assert s.can_proceed("a", at_clock=4)
    assert not s.can_proceed("a", at_clock=5)


def test_blocking_server_threads_lock_step():
    srv = WSPClockServer(D=0)
    srv.register("a")
    srv.register("b")
    log, lock = [], threading.Lock()

    def worker(wid):
        for _ in range(5):
            assert srv.wait_until_allowed(wid, timeout=10)
            with lock:
                log.append(wid)
            srv.complete_wave(wid)

    ts = [threading.Thread(target=worker, args=(w,)) for w in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert len(log) == 10
    ca = cb = 0
    for wid in log:
        ca += wid == "a"
        cb += wid == "b"
        assert abs(ca - cb) <= 1
    assert srv.wait_reason("a", timeout=0.01) == "timeout" or \
        srv.state.can_proceed("a")
    srv.deregister("b")
    assert srv.wait_reason("b", timeout=0.01) == "evicted"


# -- parameter server against the JAX package's -------------------------------

def _ps_tree(rng):
    """Nested, unsorted keys: the shard split and the codec keys follow the
    sorted-key order."""
    return {"z": rng.normal(size=(6, 5)).astype(np.float32),
            "blocks": {"wq": rng.normal(size=(2, 4, 4)).astype(np.float32),
                       "ln1": rng.normal(size=(2, 4)).astype(np.float32)},
            "a": rng.normal(size=(7,)).astype(np.float32),
            "embed": rng.normal(size=(3, 3)).astype(np.float32)}


@pytest.mark.parametrize("codec", [None, "topk:0.25", "int8"])
def test_ps_state_matches_jax_after_the_same_pushes(codec):
    """Two workers push three waves each (tensors into the port, numpy into
    the JAX server): w_global, the pulls, the byte counts and the clocks
    are equal — exactly, since both sides run the same numpy."""
    rng = np.random.default_rng(0)
    params = _ps_tree(rng)
    jps = JParameterServer(params, D=3, codec=codec)
    tps = ParameterServer(tree_lib.tree_map(torch.from_numpy, params), D=3,
                          codec=codec)
    for wid in ("vw0", "vw1"):
        jps.register(wid)
        tps.register(wid)
    for _ in range(3):
        for wid in ("vw0", "vw1"):
            d = tree_lib.tree_map(
                lambda a: rng.normal(size=a.shape).astype(np.float32),
                params)
            assert tps.push_wave(wid, tree_lib.tree_map(torch.from_numpy,
                                                        d)) == \
                jps.push_wave(wid, d)
    assert len(tps.flat) == len(jps.flat) == 5
    for a, b in zip(tps.flat, jps.flat):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_lib.leaves(tps.pull()), jax.tree.leaves(jps.pull())):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (tps.bytes_pushed, tps.bytes_wire, tps.push_count) == \
        (jps.bytes_pushed, jps.bytes_wire, jps.push_count)
    assert tps.clock.state.clocks == jps.clock.state.clocks
    assert tps.shard_of_leaf == jps.shard_of_leaf


def _params():
    return {"a": np.ones((8, 8), np.float32), "b": np.zeros(16, np.float32)}


def test_ps_wire_byte_accounting():
    deltas = {"a": np.ones((8, 8), np.float32), "b": np.ones(16, np.float32)}
    dense = 64 * 4 + 16 * 4
    ps = ParameterServer(_params(), D=0)
    ps.register("w0")
    ps.push_wave("w0", deltas)
    assert ps.bytes_pushed == dense and ps.bytes_wire == dense
    psc = ParameterServer(_params(), D=0, codec="topk:0.25")
    psc.register("w0")
    psc.push_wave("w0", deltas)
    assert psc.bytes_pushed == dense
    assert 0 < psc.bytes_wire < psc.bytes_pushed


def test_ps_pull_caches_unchanged_shards():
    ps = ParameterServer(_params(), D=0, num_shards=2)
    ps.register("w0")
    a = ps.pull()
    assert ps.pull_cache_hits == 0
    b = ps.pull()
    assert ps.pull_cache_hits == len(ps.flat)
    assert all(x is y for x, y in zip(tree_lib.leaves(a),
                                      tree_lib.leaves(b)))
    with pytest.raises(ValueError):
        b["a"][0, 0] = 5.0                    # snapshots are read-only
    ps.push_wave("w0", {"a": np.ones((8, 8), np.float32),
                        "b": np.ones(16, np.float32)})
    c = ps.pull()
    assert not any(x is y for x, y in zip(tree_lib.leaves(b),
                                          tree_lib.leaves(c)))
    np.testing.assert_allclose(c["a"], b["a"] + 1.0)


def test_ps_begin_finish_push_split():
    ps = ParameterServer(_params(), D=0)
    ps.register("w0")
    before = [f.copy() for f in ps.flat]
    pending = ps.begin_push("w0", {"a": np.ones((8, 8), np.float32),
                                   "b": np.ones(16, np.float32)})
    assert ps.bytes_pushed > 0
    for f, b in zip(ps.flat, before):
        np.testing.assert_array_equal(f, b)
    assert ps.clock.state.clocks["w0"] == 0
    assert ps.finish_push(pending) == 1
    assert float(ps.flat[0][0]) == pytest.approx(2.0)
    with pytest.raises(AssertionError):
        ps.finish_push(pending)


def test_ps_late_push_keeps_delta_not_clock():
    ps = ParameterServer(_params(), D=0)
    ps.register("w0")
    pending = ps.begin_push("w0", {"a": np.ones((8, 8), np.float32),
                                   "b": np.ones(16, np.float32)})
    ps.deregister("w0")
    assert ps.finish_push(pending) == -1
    assert ps.late_pushes == 1 and "w0" not in ps.clock.state.clocks
    assert float(ps.flat[0][0]) == pytest.approx(2.0)


def test_ps_snapshot_atomic_with_concurrent_pushes():
    """checkpoint_state() captures weights holding exactly the pushes its
    meta counts (unit deltas: weights == push_count, always)."""
    from repro_torch.api.sync import UNBOUNDED_D
    ps = ParameterServer({"w": np.zeros(64, np.float32)}, D=UNBOUNDED_D)
    delta = {"w": np.ones(64, np.float32)}
    for wid in ("vw0", "vw1"):
        ps.register(wid)

    def pusher(wid):
        for _ in range(40):
            ps.push_wave(wid, delta)

    threads = [threading.Thread(target=pusher, args=(w,))
               for w in ("vw0", "vw1")]
    for t in threads:
        t.start()
    violations = []
    while any(t.is_alive() for t in threads):
        snap, meta = ps.checkpoint_state()
        if not np.all(snap["w"] == float(meta["push_count"])):
            violations.append(meta["push_count"])
    for t in threads:
        t.join()
    assert not violations, violations[:5]
    assert ps.clock.state.clocks == {"vw0": 40, "vw1": 40}


def test_ps_gate_times_out_typed():
    from repro_torch.faults.errors import GateTimeout
    ps = ParameterServer(_params(), D=0)
    ps.register("w0")
    ps.register("w1")
    ps.push_wave("w0", {"a": np.zeros((8, 8), np.float32),
                        "b": np.zeros(16, np.float32)})
    with pytest.raises(GateTimeout):
        ps.gate("w0", timeout=0.05)
    assert ps.gate("w1", timeout=0.05)


# -- codecs ------------------------------------------------------------------

def test_topk_roundtrip_and_wire_bytes():
    g = np.arange(-8, 8, dtype=np.float32)
    idx, vals = topk_compress(g, 0.25)
    assert idx.size == 4
    dense = topk_decompress(idx, vals, g.size)
    assert set(np.flatnonzero(dense)) == set(idx.tolist())
    assert ErrorFeedbackCompressor(0.25).wire_bytes(idx, vals) == 32


@pytest.mark.parametrize("seed", range(5))
def test_error_feedback_mass_conservation_and_jax_parity(seed):
    rng = np.random.default_rng(seed)
    comp, jc = ErrorFeedbackCompressor(0.1), jcomp.ErrorFeedbackCompressor(0.1)
    sent = np.zeros(128, np.float32)
    true = np.zeros(128, np.float32)
    for _ in range(12):
        g = rng.normal(size=128).astype(np.float32)
        true += g
        idx, vals = comp.compress("k", g)
        jidx, jvals = jc.compress("k", g)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(vals, jvals)
        sent += topk_decompress(idx, vals, 128)
    np.testing.assert_allclose(sent + comp._residual["k"], true, atol=1e-4)


def test_int8_stochastic_rounding_unbiased_and_jax_draws():
    q8, j8 = Int8StochasticQuantizer(seed=0), jcomp.Int8StochasticQuantizer(0)
    x = np.full(20_000, 0.3337, np.float32)
    qv, scale = q8.quantize(x)
    jqv, jscale = j8.quantize(x)
    np.testing.assert_array_equal(qv, jqv)
    assert scale == jscale
    assert abs(float(np.mean(q8.dequantize(qv, scale))) - 0.3337) < 1e-3
    assert float(np.max(np.abs(q8.dequantize(qv, scale) - x))) <= scale + 1e-6
    idx, vals = q8.compress("k", x)
    assert q8.wire_bytes(idx, vals) == x.size + 4


def test_make_codec_specs():
    assert make_codec(None) is None
    assert make_codec("none") is None
    assert isinstance(make_codec("topk:0.5"), ErrorFeedbackCompressor)
    assert isinstance(make_codec(0.5), ErrorFeedbackCompressor)
    assert isinstance(make_codec("int8"), Int8StochasticQuantizer)
    with pytest.raises(ValueError):
        make_codec("gzip")


# -- collectives -------------------------------------------------------------

def _trees(n, seed=0, shapes=((3, 4), (7,), ())):
    rng = np.random.default_rng(seed)
    return [{f"p{j}": rng.normal(size=s).astype(np.float32)
             for j, s in enumerate(shapes)} for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("average", [False, True])
def test_ring_allreduce_matches_jax_and_numpy(n, average):
    trees = _trees(n)
    out, cost = collectives.ring_allreduce(trees, average=average)
    jout, jcost = jcoll.ring_allreduce(trees, average=average)
    for a, b in zip(tree_lib.leaves(out), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ref = {k: np.sum([t[k] for t in trees], 0) / (n if average else 1)
           for k in trees[0]}
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5)
    assert cost == jcost == 0.0


def test_ring_allreduce_takes_tensor_trees():
    trees = _trees(3, seed=4)
    out, _ = collectives.ring_allreduce(
        [tree_lib.tree_map(torch.from_numpy, t) for t in trees])
    jout, _ = jcoll.ring_allreduce(trees)
    for a, b in zip(tree_lib.leaves(out), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reduce_scatter_all_gather_roundtrip():
    vecs = [np.random.default_rng(s).normal(size=64).astype(np.float32)
            for s in range(4)]
    full = collectives.ring_all_gather(collectives.ring_reduce_scatter(vecs))
    np.testing.assert_allclose(full, np.sum(vecs, 0), atol=1e-5)


@pytest.mark.parametrize("spec", ["2node", "hetero", "4node:ib"])
def test_hierarchical_allreduce_matches_jax(spec):
    topo, jtopo = make_topology(spec, 8), j_make_topology(spec, 8)
    trees = _trees(8, seed=2)
    ring, c_ring = collectives.ring_allreduce(trees, topology=topo)
    hier, c_hier = collectives.hierarchical_allreduce(trees, topology=topo)
    jhier, jc_hier = jcoll.hierarchical_allreduce(trees, topology=jtopo)
    _, jc_ring = jcoll.ring_allreduce(trees, topology=jtopo)
    for a, b in zip(tree_lib.leaves(hier), jax.tree.leaves(jhier)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree_lib.leaves(ring), tree_lib.leaves(hier)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert (c_ring, c_hier) == (jc_ring, jc_hier)
    if spec == "2node":
        assert 0 < c_hier < c_ring


# -- topology and transport -----------------------------------------------

@pytest.mark.parametrize("spec", ["single", "2node", "2node:ib",
                                  "2node:eth1", "hetero", "paper",
                                  "4node"])
def test_topology_costs_match_jax(spec):
    topo, jtopo = make_topology(spec, 4), j_make_topology(spec, 4)
    ws = topo.worker_names()
    assert ws == jtopo.worker_names()
    for a in ws + ["ps"]:
        for b in ws + ["ps"]:
            assert topo.p2p_cost(a, b, 1e6) == jtopo.p2p_cost(a, b, 1e6)
    for nbytes in (1e3, 1e7):
        assert topo.ring_allreduce_cost(ws, nbytes) == \
            jtopo.ring_allreduce_cost(ws, nbytes)
        assert topo.hierarchical_allreduce_cost(ws, nbytes) == \
            jtopo.hierarchical_allreduce_cost(ws, nbytes)
        assert topo.reduce_scatter_cost(ws, nbytes) == \
            jtopo.reduce_scatter_cost(ws, nbytes)


def test_topology_monotonicity_presets_and_errors():
    topo = make_topology("2node", 4)
    assert topo.p2p_cost("vw0", "vw2", 2e6) > topo.p2p_cost("vw0", "vw2", 1e6)
    assert topo.p2p_cost("vw0", "vw1", 1e6) < topo.p2p_cost("vw0", "vw2", 1e6)
    assert topo.p2p_cost("vw0", "ps", 1e6) == 0.0
    assert topo.ring_allreduce_cost(["vw0"], 1e7) == 0.0
    nodes = [Node(PAPER_GPUS[c], 4) for c in "VRGQ"]
    fleet = ClusterTopology.from_fleet(nodes, num_vw=4)
    assert fleet.link("vw0", "vw1") is fleet.inter
    assert make_topology(None, 4) is None and make_topology("none", 4) is None
    hetero = make_topology("hetero-2node", 4)
    assert hetero.link("vw0", "vw1").name == NVLINK.name
    assert hetero.link("vw2", "vw3").name == PCIE.name
    assert make_topology("2node:eth1", 4).inter is ETH_1G
    assert make_topology("2node:ib", 4).inter is IB_100G
    for bad, msg in (("bogus", "Known specs"), ("xnode", "integer k"),
                     ("2node:foo", "unknown inter-node link"),
                     ("0node", "at least one node")):
        with pytest.raises(ValueError, match=msg):
            make_topology(bad, 2)


def test_comm_aware_straggler_report():
    topo = make_topology("2node", 4)
    rep = straggler_report_comm(np.full(4, 10.0), topo, bytes_per_wave=50e6)
    assert rep["compute_only"]["imbalance"] == pytest.approx(1.0)
    assert rep["imbalance"] > 1.0
    assert rep["comm_seconds"][0] == 0.0 and rep["comm_seconds"][3] > 0.0


def test_simulated_transport_accounts_like_jax():
    topo, jtopo = make_topology("2node", 4), j_make_topology("2node", 4)
    tr = SimulatedTransport(topo, time_scale=0.0)
    jtr = JSimulatedTransport(jtopo, time_scale=0.0)
    for src, dst, n in (("vw1", "ps", 10**6), ("vw3", "ps", 5 * 10**5),
                        ("vw0", "ps", 10**6), ("ps", "vw2", 10**6)):
        assert tr.send(src, dst, n) == jtr.send(src, dst, n)
    st, jst = tr.stats(), jtr.stats()
    for k in ("bytes_by_link", "seconds_by_link", "modeled_seconds"):
        assert st[k] == jst[k], k
    assert tr.bytes_by_link[ETH_10G.name] > 0
    assert NullTransport().send("a", "b", 100) == 0.0


def test_send_async_defers_delay_but_accounts_immediately():
    import time
    tr = SimulatedTransport(make_topology("2node", 2), time_scale=1.0)
    t0 = time.monotonic()
    h = tr.send_async("vw1", "ps", int(1e8))         # ~80ms on 10G Ethernet
    assert time.monotonic() - t0 < 0.5 * h.seconds
    assert h.seconds == pytest.approx(ETH_10G.transfer_time(1e8))
    assert not h.done()
    t1 = time.monotonic()
    assert h.wait() == h.seconds
    assert time.monotonic() - t1 >= 0.5 * h.seconds
    assert h.done()
    assert tr.send_async("vw0", "ps", 100).done()
    slow = LinkSpec("slow", 1.0, 1e-6)
    assert slow.transfer_time(1e6) > LinkSpec("f", 100.0, 1e-6).transfer_time(
        1e6)
