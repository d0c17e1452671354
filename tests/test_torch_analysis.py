"""The port's cost counter (repro_torch.launch.costs) against the JAX
package's jaxpr walker (benchmarks/jaxpr_analysis.py): the six cases of
tests/test_analysis.py, each run through both on the same function.

The port has no scans: a loop is counted as it runs, so a looped matmul
counts every trip as JAX's walker multiplies the scan length. A branch
counts what ran, where the walker takes the mean over a cond's branches:
test_cond_counts_the_branch_that_ran pins that difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.jaxpr_analysis import analyze_jaxpr
from repro_torch.launch import costs, mesh as mesh_lib

DEVICES = ["cpu", "meta"]


def _jax(fn, *args, mesh_shape=None, total_devices=1):
    jaxpr = jax.make_jaxpr(fn)(*args)
    return analyze_jaxpr(jaxpr.jaxpr, mesh_shape or {},
                         total_devices=total_devices)


def _port(fn, *args):
    with costs.CostCounter() as c:
        fn(*args)
    c.close()
    return c.total()


@pytest.mark.parametrize("device", DEVICES)
def test_loop_counts_every_trip(device):
    def f(x):
        for _ in range(8):
            x = x @ x
        return x

    want = _jax(lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                                       length=8)[0], jnp.ones((64, 64)))
    got = _port(f, torch.ones(64, 64, device=device))
    assert np.isclose(want.dot_flops, 8 * 2 * 64 ** 3)
    assert got.dot_flops == want.dot_flops
    assert got.ops == 8


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loops_multiply(device):
    def jf(x):
        def outer(c, _):
            return jax.lax.scan(lambda ci, _: (ci @ ci, None), c, None,
                                length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    want = _jax(jf, jnp.ones((32, 32)))
    got = _port(f, torch.ones(32, 32, device=device))
    assert np.isclose(want.dot_flops, 5 * 3 * 2 * 32 ** 3)
    assert got.dot_flops == want.dot_flops


@pytest.mark.parametrize("device", DEVICES)
def test_batched_einsum_flops(device):
    want = _jax(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                jnp.ones((4, 8, 16)), jnp.ones((4, 16, 32)))
    got = _port(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                torch.ones(4, 8, 16, device=device),
                torch.ones(4, 16, 32, device=device))
    assert np.isclose(want.dot_flops, 2 * 4 * 8 * 16 * 32)
    assert got.dot_flops == want.dot_flops
    # both count the bmm's operands and output once
    assert got.dot_bytes == want.dot_bytes


@pytest.mark.parametrize("device", DEVICES)
def test_psum_ring_factor(device):
    from repro.compat import shard_map
    from repro.launch.mesh import make_mesh_auto
    jmesh = make_mesh_auto((1,), ("x",))

    def jf(x):
        return shard_map(lambda a: jax.lax.psum(a, "x"), mesh=jmesh,
                         in_specs=jax.sharding.PartitionSpec(None),
                         out_specs=jax.sharding.PartitionSpec(None),
                         check_vma=False)(x)

    want = _jax(jf, jnp.ones((128,), jnp.float32), mesh_shape={"x": 4},
                total_devices=4)
    parts = [torch.ones(128, device=device) for _ in range(4)]
    got = _port(lambda ps: mesh_lib.psum(ps, torch.device(device),
                                         axis="x"), parts)
    # ring all-reduce: 2 (n - 1) / n of the payload = 1.5 x 512 B
    assert np.isclose(want.collective_bytes["psum"], 1.5 * 512)
    assert got.collective_bytes["psum"] == want.collective_bytes["psum"]
    assert got.collective_counts["psum"] == 1


@pytest.mark.parametrize("device", DEVICES)
def test_slice_write_counts_the_update(device):
    want = _jax(lambda big, small: jax.lax.dynamic_update_slice(
        big, small, (0, 0)), jnp.ones((1024, 1024)), jnp.ones((2, 2)))
    big = torch.ones(1024, 1024, device=device)
    got = _port(lambda b, s: b[0:2, 0:2].copy_(s), big,
                torch.ones(2, 2, device=device))
    assert want.bytes_upper <= 2 * 2 * 2 * 4 + 1
    assert got.bytes_upper == want.bytes_upper == 2 * 2 * 2 * 4


@pytest.mark.parametrize("device", DEVICES)
def test_cond_counts_the_branch_that_ran(device):
    """JAX's walker: the mean over the cond's two branches (0.5 x the
    matmul); the port: the branch that ran (1.0 x, or 0 when the other
    ran)."""
    want = _jax(lambda x, p: jax.lax.cond(p, lambda y: y @ y, lambda y: y,
                                          x),
                jnp.ones((32, 32)), jnp.bool_(True))

    def f(x, p):
        return x @ x if p else x

    x = torch.ones(32, 32, device=device)
    ran, skipped = _port(f, x, True), _port(f, x, False)
    assert np.isclose(want.dot_flops, 0.5 * 2 * 32 ** 3)
    assert ran.dot_flops == 2 * want.dot_flops == 2 * 32 ** 3
    assert skipped.dot_flops == 0 and skipped.ops == 0


@pytest.mark.parametrize("device", DEVICES)
def test_views_free_casts_and_gathers_by_output(device):
    """The port's rules beside the walker's: layout ops cost nothing,
    casts and gathers their output bytes, the rest 1 FLOP an output
    element and the unfused sum of input and output bytes."""
    x = torch.ones(8, 16, device=device)
    idx = torch.zeros(4, dtype=torch.int64, device=device)
    got = _port(lambda t: t.t().reshape(16, 8).unsqueeze(0), x)
    assert (got.flops, got.bytes_upper) == (0, 0) and got.ops == 3
    got = _port(lambda t: t.to(torch.bfloat16), x)
    assert got.bytes_upper == 8 * 16 * 2 and got.flops == 0
    got = _port(lambda t: t[idx], x)
    assert got.bytes_upper == 4 * 16 * 4
    got = _port(lambda t: t + t, x)
    assert got.flops == 8 * 16 and got.bytes_upper == 3 * 8 * 16 * 4


def test_memory_peak_and_slots():
    """Live storages: charged to the slot that made them until freed, the
    peak at the most alive at once, rounded to the allocator's 512 B."""
    x = torch.ones(256, device="meta")            # 1 KiB, an argument
    with costs.CostCounter() as c:
        c.arguments({"x": x})
        with costs.slot(data=1, stage=0, tp=1):
            a = x * 2                              # 1 KiB on (1, 0, 1)
            b = a + 1                              # 1 KiB
            del a
        y = torch.ones(3, device="meta")          # 12 B -> 512 on slot 0
    c.close()
    assert c.arg_bytes == 1024
    assert c.peak_by_slot[(1, 0, 1)] == 2048
    assert c.peak_by_slot[(0, 0, 0)] == 512
    assert c.peak_bytes == 2048
    assert c.live_bytes == 1024 + 512
    del b, y
