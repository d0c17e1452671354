"""moe_mlp_ep, the port's expert-parallel exchange, against the JAX
package's moe_mlp(..., ep_axis=) under shard_map.

JAX's shard_map needs n host devices, and XLA fixes its host device count
at the first jax import, so this file runs itself as a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=4: over n = 2 and 4
devices (each device its tokens, the router whole) it runs JAX's moe_mlp
with ep_axis (each device its E/n experts) and without (every expert on
every device), and jax.lax.all_to_all on seeded buffers, on inputs made
with numpy from a seed, and writes every per-device result to an .npz.

JAX's ep_axis path scrambles rows: jax.lax.all_to_all (tiled=False)
inserts the source axis at concat_axis, so the exchanged group is laid out
[E/n, cap, n, d] and its reshape to [E/n, n cap, d] orders rows slot-major,
while the return path reshapes the FFN's output as [E/n, n, cap, d], shard
-major: a token reads another token's expert output once n > 1 (no caller
in the JAX package passes ep_axis). The port keeps the order the return
path assumes (rows by source shard, then slot) on both legs. So the port
is held to what the exchange must compute, JAX's moe_mlp without ep_axis
on each shard's tokens with every expert: outputs within 1e-5 (f32), at a
capacity factor that keeps every choice and at one that drops some; the
per-shard aux (computed before the exchange) to JAX's ep_axis aux; the
exchange itself (launch.mesh.all_to_all) to jax.lax.all_to_all, rows put
in the same order; and JAX's scramble is pinned.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
        python tests/test_torch_moe_ep.py OUT.npz
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, K, D, FF, B, S = 8, 2, 16, 32, 2, 16
CASES = [(n, cf) for n in (2, 4) for cf in (1.25, 0.5)]


def _inputs(n):
    rng = np.random.default_rng(10 + n)
    return dict(
        x=rng.standard_normal((n * B, S, D)).astype(np.float32),
        router=rng.standard_normal((D, E)).astype(np.float32),
        w_in=(0.3 * rng.standard_normal((E, D, 2, FF))).astype(np.float32),
        w_out=(0.3 * rng.standard_normal((E, FF, D))).astype(np.float32))


def _a2a_buffers(n, cap):
    """Each device's [n, E/n, cap, d] dispatch buffer, seeded."""
    rng = np.random.default_rng(20 + n)
    return rng.standard_normal((n, n, E // n, cap, D)).astype(np.float32)


def jax_side(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.launch.mesh import make_mesh_auto
    from repro.models.moe import moe_mlp

    assert len(jax.devices()) >= 4, jax.devices()
    rec = {}
    for n, cf in CASES:
        inp = _inputs(n)
        mesh = make_mesh_auto((n,), ("x",))
        args = [jnp.asarray(inp[k]) for k in ("x", "router", "w_in",
                                                "w_out")]
        for tag, ep, wspec in (("ep", "x", P("x")), ("plain", None, P())):
            def body(x, router, w_in, w_out, ep=ep):
                y, aux = moe_mlp({"router": router, "w_in": w_in,
                                  "w_out": w_out}, x, num_experts=E,
                                 top_k=K, mlp_type="swiglu",
                                 capacity_factor=cf, ep_axis=ep)
                return y, aux[None]

            fn = shard_map(body, mesh=mesh,
                           in_specs=(P("x"), P(), wspec, wspec),
                           out_specs=(P("x"), P("x")), check_vma=False)
            y, aux = jax.jit(fn)(*args)
            rec[f"y_{tag}/{n}/{cf}"] = np.asarray(y)
            rec[f"aux_{tag}/{n}/{cf}"] = np.asarray(aux)
    for n in (2, 4):
        buf = _a2a_buffers(n, 4)
        fn = shard_map(lambda a: jax.lax.all_to_all(
            a[0], "x", split_axis=0, concat_axis=2)[None], mesh=make_mesh_auto(
                (n,), ("x",)), in_specs=P("x"), out_specs=P("x"),
            check_vma=False)
        rec[f"a2a/{n}"] = np.asarray(jax.jit(fn)(jnp.asarray(buf)))
    np.savez(out_path, **rec)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep") / "jax_moe_ep.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with np.load(out) as z:
        return dict(z)


def _port_shards(n):
    import torch
    inp = _inputs(n)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ps = [{"router": t["router"],
           "w_in": t["w_in"][i * E // n:(i + 1) * E // n],
           "w_out": t["w_out"][i * E // n:(i + 1) * E // n]}
          for i in range(n)]
    xs = list(t["x"].split(B))
    return t, ps, xs


@pytest.mark.parametrize("n,cf", CASES)
def test_moe_mlp_ep_equals_jax(jax_out, n, cf):
    from repro_torch.launch import costs
    from repro_torch.models.moe import capacity, moe_mlp, moe_mlp_ep

    t, ps, xs = _port_shards(n)
    with costs.CostCounter() as c:
        ys, auxs = moe_mlp_ep(ps, xs, num_experts=E, top_k=K,
                              mlp_type="swiglu", capacity_factor=cf)
    c.close()
    y = np.concatenate([v.numpy() for v in ys])
    np.testing.assert_allclose(y, jax_out[f"y_plain/{n}/{cf}"], atol=1e-5,
                               rtol=1e-5)
    for tag in ("ep", "plain"):
        np.testing.assert_allclose(np.array([float(a) for a in auxs]),
                                   jax_out[f"aux_{tag}/{n}/{cf}"],
                                   atol=1e-5, rtol=1e-5)
    # two all_to_alls of one shard's [n, E/n, cap, d] group each
    cap = capacity(B * S, E, K, cf)
    tot = c.total()
    assert tot.collective_counts == {"all_to_all": 2}
    assert tot.collective_bytes["all_to_all"] == \
        2 * (n - 1) / n * E * cap * D * 4
    # shard i alone through the port's plain moe_mlp with every expert
    full = {"router": t["router"], "w_in": t["w_in"], "w_out": t["w_out"]}
    for x, yi, ai in zip(xs, ys, auxs):
        want, aux = moe_mlp(full, x, num_experts=E, top_k=K,
                            mlp_type="swiglu", capacity_factor=cf)
        np.testing.assert_allclose(yi.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert float(ai) == float(aux)


@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_equals_jax(jax_out, n):
    """launch.mesh.all_to_all (split 0, concat 2) against
    jax.lax.all_to_all: the same rows, JAX's [E/n, cap, n, d] layout
    read source-major ([E/n, n, cap, d])."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    buf = _a2a_buffers(n, 4)
    got = mesh_lib.all_to_all([torch.from_numpy(b) for b in buf],
                              [torch.device("cpu")] * n, axis="x",
                              split_axis=0, concat_axis=2)
    want = jax_out[f"a2a/{n}"]                 # [n, E/n, cap, n, d]
    for j in range(n):
        np.testing.assert_array_equal(
            got[j][0].numpy(), want[j].transpose(0, 2, 1, 3).reshape(
                E // n, n * 4, D))


def test_jax_ep_axis_scrambles_rows(jax_out):
    """Pinned: JAX's ep_axis output is not its per-shard moe_mlp for n > 1
    (the row-order mismatch above); the port's is."""
    for n, cf in CASES:
        diff = np.abs(jax_out[f"y_ep/{n}/{cf}"]
                      - jax_out[f"y_plain/{n}/{cf}"]).max()
        assert diff > 1e-2, (n, cf, diff)


def test_capacity_drops_choices():
    """At cf 0.5 the capacity is under the choices a shard routes: the
    drop case really drops."""
    from repro_torch.models.moe import capacity
    assert capacity(B * S, E, K, 0.5) * E < B * S * K
    assert capacity(B * S, E, K, 1.25) * E >= B * S * K


def test_moe_mlp_ep_refuses_uneven_shards():
    from repro_torch.models.moe import moe_mlp_ep
    _, ps, xs = _port_shards(2)
    with pytest.raises(ValueError):
        moe_mlp_ep(ps[:1], xs, num_experts=E, top_k=K, mlp_type="swiglu")
    with pytest.raises(ValueError):
        moe_mlp_ep(ps, [xs[0], xs[1][:1]], num_experts=E, top_k=K,
                   mlp_type="swiglu")


if __name__ == "__main__":
    jax_side(sys.argv[1])
