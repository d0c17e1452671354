"""Training loss and grads of the dense, stub-frontend and second MoE archs
against `jax.grad`, on the CPU in f32 (the split check of
test_torch_zoo_grads.py, whose docstring says why the CE product and the
backward are held apart; gemma3 at 6 layers, trap G1), and the wave
step's microbatch split carrying embeddings.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.wave import wave_grads
from test_torch_train_loss import (LOSS_TOL, _grads_close, _params,
                                   _port_loss_and_grads, _tokens)
from test_torch_zoo_grads import _inputs, check_split_grads

CASES = {"gemma3-1b": dict(num_layers=6), "minitron-8b": {},
         "musicgen-medium": {}, "chameleon-34b": {}}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_ref_loss_and_grads_match_jax(name):
    """The split check (test_torch_zoo_grads.check_split_grads)."""
    check_split_grads(name, **CASES[name])


def test_granite_3b_loss_and_grads_match_jax():
    """The second MoE config, end to end as test_torch_train_loss holds
    granite-moe-1b-a400m: the loss with its load-balancing term and every
    leaf's grad within 1e-4 of the leaf's max (no bf16 step lands apart at
    this seed)."""
    name = "granite-moe-3b-a800m"
    arch, jarch = reduced(ARCHS[name]), j_reduced(J_ARCHS[name])
    jp, tp = _params(jarch)
    x, y = _tokens(jarch.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm.forward_ref(
        jarch, p, x, mode="train", labels=y)[0]))(jp)
    tl, tg = _port_loss_and_grads(arch, tp, x, y)
    assert abs(float(jl) - tl) <= LOSS_TOL, (float(jl), tl)
    _grads_close(jg, tg)


def test_wave_grads_take_embeddings():
    """The wave step's microbatch split carries [B, S, d_model] inputs: two
    microbatches of a stub-frontend arch give the mean of their losses and
    the mean of their grads."""
    arch = reduced(ARCHS["chameleon-34b"])
    _, tp = _params(j_reduced(J_ARCHS["chameleon-34b"]))
    x, y = _inputs(arch, B=4, S=16)
    loss, grads = wave_grads(arch, 2, tp, torch.from_numpy(x),
                             torch.from_numpy(y))
    halves = [_port_loss_and_grads(arch, tp, x[i:i + 2], y[i:i + 2])
              for i in (0, 2)]
    assert abs(float(loss) - np.mean([h[0] for h in halves])) <= LOSS_TOL
    g = grads["blocks"]["wq"]
    want = (halves[0][1]["blocks"]["wq"] + halves[1][1]["blocks"]["wq"]) / 2
    assert float((g - want).abs().max()) <= 1e-6 * float(want.abs().max())
