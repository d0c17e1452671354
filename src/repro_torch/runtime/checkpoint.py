"""Atomic, exact checkpointing of the training state (the port of
repro.runtime.checkpoint).

Saved per checkpoint: one .npz per named tree (PS weights, optimizer
states, ...) and meta.json (step, WSP clocks, push count). Files are written
to a temp dir and renamed atomically; restore is bitwise-exact. A leaf is
stored under its path ("blocks/wq", "m/embed", "step") in jax.tree order,
as the JAX package names it, so a checkpoint either package wrote loads in
the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core import tree as tree_lib


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_named(tree):
    return {path: _host(leaf)
            for path, leaf in tree_lib.flatten_with_path(tree)}


def _unflatten_like(template, named):
    """The template's tree with each leaf read from `named` by its path, in
    the template leaf's shape and dtype (a tensor leaf comes back as a
    tensor on the template's device, a Python scalar as its type, any
    other leaf as numpy)."""
    leaves = []
    for path, leaf in tree_lib.flatten_with_path(template):
        arr = np.asarray(named[path])
        if isinstance(leaf, torch.Tensor):
            leaves.append(torch.from_numpy(
                np.array(arr, dtype=np.float32 if leaf.is_floating_point()
                         else arr.dtype).reshape(tuple(leaf.shape)))
                .to(device=leaf.device, dtype=leaf.dtype))
        elif isinstance(leaf, (bool, int, float)):      # e.g. a step count
            leaves.append(type(leaf)(arr.reshape(())))
        else:
            leaves.append(arr.reshape(np.shape(leaf)).astype(
                np.asarray(leaf).dtype))
    return tree_lib.unflatten_like(template, leaves)


def save_checkpoint(ckpt_dir: str, step: int, trees: dict, meta: dict):
    """trees: name -> tree (params, opt_states, ...); meta: JSON-able."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        for name, tree in trees.items():
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **_flatten_named(tree))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **meta}, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_checkpoint(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load_checkpoint(path: str, templates: dict):
    """templates: name -> tree with the target shapes/dtypes."""
    out = {}
    for name, template in templates.items():
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            out[name] = _unflatten_like(template, dict(z))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return out, meta
