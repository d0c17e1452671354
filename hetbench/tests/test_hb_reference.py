"""The reference agrees with the port's plain ("ref") path at a tiny size,
in float32, on the same weights and tokens."""
import dataclasses
import json

import torch

from hetbench import families, weights
from hetbench.reference import granite, prec, rwkv6


def _load(tiny_root, name):
    from repro_torch.configs import get_arch
    cfg = json.loads((tiny_root / "hetbench" / "configs" /
                      f"{name}.json").read_text())
    arch = dataclasses.replace(get_arch(cfg["port"]["arch"]),
                               **cfg["port"]["fields"])
    fam = families.load(cfg["family"])
    params = weights.make(cfg, 99, family=fam, dtype=torch.float32,
                          device="cpu")
    return cfg, arch, weights.sizes(cfg, fam), params


def test_granite_prefill_logits(tiny_root):
    from repro_torch.models import lm
    cfg, arch, z, params = _load(tiny_root, "tiny-granite")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, z["vocab"], (3, 12), generator=g)
    lens = torch.tensor([12, 5, 1])
    hid, _ = lm.forward_ref(arch, params, toks, mode="train")
    want = lm.logits_ref(arch, params, hid[torch.arange(3), lens - 1])
    got, kv = granite.prefill(z, params, toks, lens, prec.Prec(), [1])
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)
    assert kv[0][0].shape == (1, 12, z["KV"], z["hd"])


def test_granite_training_loss_and_grads(tiny_root):
    from repro_torch.models import lm
    cfg, arch, z, params = _load(tiny_root, "tiny-granite")
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, z["vocab"], (1, 16), generator=g)
    y = torch.randint(0, z["vocab"], (1, 16), generator=g)
    p1 = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_())
          for k, v in params.items()}
    p2 = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_())
          for k, v in params.items()}
    want, _ = lm.forward_ref(arch, p1, x, mode="train", labels=y)
    got = granite.train_loss(z, p2, x, y, prec.Prec())
    assert abs(float(got.detach()) - float(want.detach())) < 1e-5
    want.backward()
    got.backward()
    for n in p1["blocks"]:
        a, b = p1["blocks"][n].grad, p2["blocks"][n].grad
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-3), n


def test_rwkv6_logits(tiny_root):
    from repro_torch.models import lm
    cfg, arch, z, params = _load(tiny_root, "tiny-rwkv6")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, z["vocab"], (1, 37), generator=g)
    hid, _ = lm.forward_ref(arch, params, toks, mode="train")
    want = lm.logits_ref(arch, params, hid[0])
    got = rwkv6.forward(z, params, toks[0], prec.Prec(), torch.arange(37))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_controls_round_their_operands():
    a = torch.randn(8, 64)
    b = torch.randn(64, 8)
    exact = a @ b
    for mode, lo, hi in (("tf32", 1e-5, 3e-3), ("fp8", 1e-3, 0.3)):
        err = float(((prec.Prec(mode).mm(a, b) - exact).abs().max())
                    / exact.abs().max())
        assert lo < err < hi, (mode, err)
