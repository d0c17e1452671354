"""The benchmark's weights, drawn on the device from --seed.

One draw per stacked leaf (the layers of a leaf come in one call), in the
dtype the cell runs (float32 to train, bfloat16 to serve), with no float32
copy of the whole model. Names and shapes are the port's parameter tree
(blocks stacked over layers, `embed` padded to a multiple of 16 rows);
hetbench/tests check them against repro_torch.models.lm.param_shapes.
The reference draws the same tensors again from the same seed."""
from __future__ import annotations

import torch


def sizes(cfg: dict, family) -> dict:
    """The sizes the tree is built from, read from the configuration: the
    ones every family has, then the family's own (`family` the module of
    families/<cfg["family"]>.py)."""
    f = cfg["port"]["fields"]
    out = {"family": cfg["family"], "L": int(f["num_layers"]),
           "d": int(f["d_model"]), "ff": int(f["d_ff"]),
           "vocab": int(f["vocab_size"]),
           "Vp": -(-int(f["vocab_size"]) // 16) * 16,
           "tied": bool(f.get("tie_embeddings", False)),
           "eps": float(f.get("norm_eps", 1e-6))}
    out.update(family.sizes(f))
    return out


def leaf_specs(cfg: dict, family) -> dict:
    """{name: (shape, init, scale)} of every leaf; block leaves under
    "blocks/<name>" carry the stacked layer dim first."""
    z = sizes(cfg, family)
    L, d, Vp = z["L"], z["d"], z["Vp"]
    specs = {f"blocks/{n}": ((L,) + s, i, c)
             for n, (s, i, c) in family.block_specs(z).items()}
    specs["final_norm"] = ((d,), "normal", 0.02)
    specs["embed"] = ((Vp, d), "normal", 0.02)
    if not z["tied"]:
        specs["head"] = ((d, Vp), "normal", 0.02)
    return specs


def make(cfg: dict, seed: int, *, family, dtype, device) -> dict:
    """The port's parameter tree for `cfg`, drawn from `seed` on `device`
    in `dtype`: leaves in sorted order, one generator call each."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    params = {"blocks": {}}
    for name, (shape, init, c) in sorted(leaf_specs(cfg, family).items()):
        if init == "uniform":
            t = torch.rand(shape, generator=g, device=device, dtype=dtype)
            t.mul_(c[1] - c[0]).add_(c[0])
        else:
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            t.mul_(c)
            if init == "one_plus":
                t.add_(1.0)
        if name.startswith("blocks/"):
            params["blocks"][name[7:]] = t
        else:
            params[name] = t
    return params
