"""The port's pipelined train step against the JAX package's pipelined one
(the counterpart of tests/test_system.py's train and overlap cases).

JAX's shard_map needs 8 devices, and XLA fixes its host device count at the
first jax import, so this file runs itself as a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8: the subprocess runs
JAX's build_train_step for qwen3-0.6b (tests/pipeline_equiv_main.py's cut)
on a (2, 2, 2) mesh, in both schedules, and writes the init params, the
batch, the new params and the losses to an .npz. The test then runs the
port's build_train_step on a (2, 2, 2) mesh of CPU slots from the same
params and batch: loss within 1e-5, params within 1e-4 (the bf16 CE
product's epsilon, JAX's own bound against its oracle).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 PYTHONPATH=src \\
        python tests/test_torch_spmd_parity.py OUT.npz
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(stages=2, tp=2, num_layers=4, num_microbatches=2, remat=True)
B, S = 8, 32


def _flat(tree, prefix=""):
    """{path: array} of a nested dict, paths joined by '/'."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat, prefix):
    out = {}
    for path, v in flat.items():
        if not path.startswith(prefix):
            continue
        *heads, leaf = path[len(prefix):].split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def jax_side(out_path):
    """JAX's pipelined step, both schedules, on 8 host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import ARCHS, RunConfig, ShapeConfig, reduced
    from repro.core import wave
    from repro.launch.mesh import make_mesh_auto
    from repro.models import lm
    from repro.optim import make_optimizer

    assert len(jax.devices()) >= 8, jax.devices()
    mesh = make_mesh_auto((2, 2, 2), ("data", "stage", "tp"))
    key = jax.random.PRNGKey(0)
    cfg = reduced(ARCHS["qwen3-0.6b"], **CUT)
    params, pspecs = lm.init_params(cfg, key)
    inputs = jax.random.randint(key, (B, S), 0, cfg.vocab_size,
                                dtype=jnp.int32)
    labels = jax.random.randint(jax.random.fold_in(key, 1), (B, S), 0,
                                cfg.vocab_size, dtype=jnp.int32)
    opt = make_optimizer("sgd", 0.1)
    rec = {"inputs": np.asarray(inputs), "labels": np.asarray(labels)}
    rec.update({"init/" + k: v for k, v in _flat(
        jax.device_get(params)).items()})
    for overlap in (False, True):
        run = RunConfig(arch=cfg, shape=ShapeConfig("tiny", S, B, "train"),
                        optimizer="sgd", lr=0.1, compute_dtype="float32",
                        loss_chunk=16, overlap=overlap)
        step, _ = wave.build_train_step(run, mesh)
        with set_mesh(mesh):
            p_sh = jax.device_put(params, jax.tree.map(
                lambda s: NamedSharding(mesh, s), pspecs,
                is_leaf=lambda x: isinstance(x, P)))
            new, _, m = jax.jit(step)(p_sh, opt.init(params),
                                      {"inputs": inputs, "labels": labels})
        tag = "overlap" if overlap else "base"
        rec[f"loss/{tag}"] = np.float32(m["loss"])
        rec.update({f"new_{tag}/" + k: v for k, v in _flat(
            jax.device_get(new)).items()})
    np.savez(out_path, **rec)


def test_port_equals_jax_pipelined_train_step(tmp_path):
    import torch

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced
    from repro_torch.core import wave
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    out = tmp_path / "jax_pipeline.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with np.load(out) as z:
        rec = dict(z)
    cfg = reduced(ARCHS["qwen3-0.6b"], **CUT)
    init = lm.params_from_numpy(_unflat(rec, "init/"), device="cpu")
    mesh = make_test_mesh(2, 2, 2, devices="cpu")
    for tag, overlap in (("base", False), ("overlap", True)):
        run = RunConfig(arch=cfg, shape=ShapeConfig("tiny", S, B, "train"),
                        optimizer="sgd", lr=0.1, compute_dtype="float32",
                        loss_chunk=16, overlap=overlap)
        step, _ = wave.build_train_step(run, mesh)
        opt = make_optimizer("sgd", 0.1)
        new, _, m = step(init, opt.init(init),
                         {"inputs": torch.from_numpy(rec["inputs"]),
                          "labels": torch.from_numpy(rec["labels"])})
        assert abs(float(m["loss"]) - float(rec[f"loss/{tag}"])) < 1e-5
        want = _unflat(rec, f"new_{tag}/")
        got = _flat({k: (v if not isinstance(v, dict) else
                         {n: t.numpy() for n, t in v.items()})
                     for k, v in new.items()})
        assert got.keys() == _flat(want).keys()
        worst = max(float(np.abs(got[k] - w).max())
                    for k, w in _flat(want).items())
        assert worst < 1e-4, (tag, worst)
    # JAX's own schedules: the overlap loss is bit-identical to the base's
    assert rec["loss/overlap"] == rec["loss/base"]


if __name__ == "__main__":
    jax_side(sys.argv[1])
