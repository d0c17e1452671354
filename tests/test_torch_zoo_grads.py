"""Training loss and grads of every family the presets do not train, against
`jax.grad` of the JAX package's forward_ref, on the CPU in f32.

The check of tests/test_torch_train_loss.py — loss within 1e-5, every leaf's
grad within 1e-4 of that leaf's largest |grad| — for the RWKV6, SSD hybrid,
sliding-window, local/global, squared-ReLU and stub-frontend archs and
the second MoE config at their reduced sizes (gemma3 at 6 layers so its
global layer trains too, trap G1; those in test_torch_zoo_grads_dense.py);
with test_torch_train_loss.py every ARCHS entry is covered.
Weights are the JAX init carried across with `lm.params_from_numpy`; token
ids and embeddings are drawn with numpy.

The grads are held in two parts whose sum is the whole grad (trap L1). The
CE head product rounds its operand grads to bf16 on both sides, so where the
two f32 sums differ in their last bit an element lands on the neighbouring
bf16 value: at these seeds one element of hymba's head grad and two of
minitron's normed-hidden-state grad do, and the latter reaches 1e-3 of
minitron's embedding grad through the final norm and the layers. So (1) the
CE product — the loss and its grads with respect to the normed hidden
state and the head matrix, at the same normed hidden state — agrees within
1e-4 of each grad's max, or one bf16 step of the element at no more than
1% of the elements; (2) the final norm's and the layer stack's backward
from the same normed-hidden-state grad agrees within 1e-4 of each leaf's
max, with no allowance.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from test_torch_train_loss import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL,
                                   _grads_close, _params, _tokens)

# the recurrent and windowed archs here; the dense, stub-frontend and MoE
# ones in test_torch_zoo_grads_dense.py (each file about a minute)
CASES = {"rwkv6-3b": {}, "hymba-1.5b": {}, "h2o-danube-1.8b": {}}
FLIP_SHARE = 0.01         # elements allowed one bf16 step off (CE part)


def _inputs(arch, B=2, S=32, seed=0):
    """(inputs, labels): token ids, or [B, S, d_model] embeddings for a
    stub-frontend arch (its labels stay token ids)."""
    x, y = _tokens(arch.vocab_size, B, S, seed)
    if arch.frontend != "none":
        rng = np.random.default_rng(seed + 1)
        x = (0.5 * rng.standard_normal((B, S, arch.d_model))).astype(
            np.float32)
    return x, y


def _ce_close(name, a, b):
    """One CE-product grad: within 1e-4 of its max, or one bf16 step of the
    element (the spacing of bf16 values at |a|: 2^(floor(log2 |a|) - 7)) at
    no more than FLIP_SHARE of the elements."""
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, name
    err = np.abs(a - b)
    off = err > GRAD_RTOL * float(np.abs(a).max()) + GRAD_ATOL
    step = 2.0 ** (np.floor(np.log2(np.abs(a[off]) + 1e-30)) - 7)
    assert np.all(err[off] <= step + GRAD_ATOL), (name, float(err.max()))
    assert off.mean() <= FLIP_SHARE, (name, int(off.sum()))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_ref_loss_and_grads_match_jax(name):
    """forward_ref(mode="train", labels=): the loss, the CE part's grads and
    the layer stack's grads from the same hidden-state grad match jax.grad
    of the JAX package's (see the module docstring)."""
    check_split_grads(name, **CASES[name])


def check_split_grads(name, **kw):
    """The loss, the CE product's grads and the final norm's and layer
    stack's backward from JAX's normed-hidden grad, for ARCHS[name]
    reduced with `kw`."""
    arch = reduced(ARCHS[name], **kw)
    jarch = j_reduced(J_ARCHS[name], **kw)
    jp, tp = _params(jarch)
    x, y = _inputs(arch)
    # the whole loss, as test_torch_train_loss holds it
    jl = jax.jit(lambda p: jlm.forward_ref(jarch, p, x, mode="train",
                                           labels=y)[0])(jp)
    leaves = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), tp)
    hid, _ = tlm.forward_ref(arch, leaves, torch.from_numpy(x),
                             mode="train")
    with torch.no_grad():
        tl = float(tlm.lm_loss(arch, leaves, hid, torch.from_numpy(y)))
    assert abs(float(jl) - tl) <= LOSS_TOL, (float(jl), tl)
    # (1) the CE product at JAX's normed hidden state
    def jstack_fn(p):
        hidden = jlm.forward_ref(jarch, p, x, mode="train")[0]
        return jlm.final_hidden_norm(jarch, p, hidden)

    def jce_fn(hn, head):
        return jlayers.chunked_cross_entropy(hn, head, y, chunk=hn.shape[1],
                                             valid_vocab=jarch.vocab_size)
    jhn, vjp = jax.jit(lambda p: jax.vjp(jstack_fn, p))(jp)
    jce, (jdh, jdw) = jax.jit(jax.value_and_grad(jce_fn, argnums=(0, 1)))(
        jhn, jlm.head_matrix(jarch, jp))
    hn = torch.from_numpy(np.array(jhn)).requires_grad_()
    w = tlm.head_matrix(arch, tp).detach().clone().requires_grad_()
    tce = tlayers.chunked_cross_entropy(hn, w, torch.from_numpy(y),
                                        chunk=hn.shape[1],
                                        valid_vocab=arch.vocab_size)
    tce.backward()
    assert abs(float(jce) - float(tce.detach())) <= LOSS_TOL
    _ce_close("normed hidden", jdh, hn.grad)
    _ce_close("head matrix", jdw, w.grad)
    # (2) the final norm and the layer stack from JAX's normed-hidden grad
    jstack = jax.jit(vjp)(jdh)[0]
    thn = tlm.final_hidden_norm(arch, leaves, hid)
    got = torch.autograd.grad(thn, tree_lib.leaves(leaves),
                              grad_outputs=torch.from_numpy(np.array(jdh)),
                              allow_unused=True)
    got = [g if g is not None else torch.zeros_like(t)
           for g, t in zip(got, tree_lib.leaves(leaves))]
    _grads_close(jstack, tree_lib.unflatten_like(tp, got))
