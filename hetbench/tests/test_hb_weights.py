"""The benchmark's weight maker yields the port's parameter tree."""
import json

import torch

from hetbench import families, weights
from hetbench.tests import tiny


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_names_and_shapes_are_the_ports_at_full_size():
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    for name in ("granite-moe-1b-a400m", "rwkv6-3b"):
        cfg = json.loads((tiny.HERE / "configs" / f"{name}.json").read_text())
        mine = {k: v[0] for k, v in weights.leaf_specs(
            cfg, families.load(cfg["family"])).items()}
        assert mine == _flat_shapes(lm.param_shapes(get_arch(name)))


def test_tiny_draw_is_the_seeds_in_the_dtype_asked(tiny_root):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = json.loads((tiny_root / "hetbench" / "configs" /
                      "tiny-granite.json").read_text())
    fam = families.load(cfg["family"])
    a = weights.make(cfg, 2 ** 40 + 3, family=fam, dtype=torch.bfloat16,
                     device="cpu")
    b = weights.make(cfg, 2 ** 40 + 3, family=fam, dtype=torch.bfloat16,
                     device="cpu")
    c = weights.make(cfg, 4, family=fam, dtype=torch.bfloat16,
                     device="cpu")
    arch = dataclasses.replace(get_arch(cfg["port"]["arch"]),
                               **cfg["port"]["fields"])
    assert _flat_shapes(a) == _flat_shapes(lm.param_shapes(arch))
    assert all(t.dtype == torch.bfloat16 for t in a["blocks"].values())
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
