"""The port's training loss and grads against the JAX package's, on the CPU
in f32.

Weights are the JAX package's own init carried across with
`lm.params_from_numpy`; token ids are drawn with numpy from a seed. Losses
agree within 1e-5 (values of order 5). The head product rounds both
operands to bf16 and sums in f32 on both sides (trap T4), and its input
grads are rounded to bf16 on both sides too, so a grad agrees within 1e-4
of its leaf's largest entry plus 1e-8: an f32 sum in a different order can
round a hidden-state grad to the neighbouring bf16 value (2^-8 relative),
which reaches the embedding's grad at ~3e-5 of its maximum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.presets import _tiny_arch as j_tiny_arch
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.api.presets import _tiny_arch
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4          # of the leaf's largest |grad|
GRAD_ATOL = 1e-8


def _archs():
    """name -> (port arch, JAX arch): the presets' tiny qwen3; reduced
    qwen3 with 3 layers on 2 stages (one padded layer slot) and a vocab of
    250 (padded to 256, so valid_vocab masks six columns); reduced granite
    (the MoE aux loss enters the training loss)."""
    q3 = dict(num_layers=3, vocab_size=250)
    return {
        "tiny": (_tiny_arch(), j_tiny_arch()),
        "qwen3_padded": (reduced(ARCHS["qwen3-0.6b"], **q3),
                         j_reduced(J_ARCHS["qwen3-0.6b"], **q3)),
        "granite_moe": (reduced(ARCHS["granite-moe-1b-a400m"]),
                        j_reduced(J_ARCHS["granite-moe-1b-a400m"])),
    }


def _params(jarch, seed=0):
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    return jp, tlm.params_from_numpy(host, device="cpu")


def _tokens(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _grads_close(jg, tg):
    jl = tree_lib.flatten_with_path(jax.device_get(jg))
    tl = tree_lib.flatten_with_path(tg)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, path
        tol = GRAD_RTOL * float(np.abs(a).max()) + GRAD_ATOL
        err = float(np.abs(a - b).max())
        assert err <= tol, (path, err, tol)


def _port_loss_and_grads(arch, tp, x, y):
    leaves = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, _ = tlm.forward_ref(arch, leaves, torch.from_numpy(x),
                              mode="train", labels=torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), tree_lib.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        leaves)


def test_chunked_cross_entropy_below_s_with_vocab_mask():
    """A chunk of 8 over S 32 (four chunks, each recomputed in backward)
    and a head of 40 columns of which 37 are real: the loss and both
    operands' grads agree."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 32, 16)).astype(np.float32)
    head = (0.3 * rng.normal(size=(16, 40))).astype(np.float32)
    lab = rng.integers(0, 37, (2, 32)).astype(np.int32)

    def jloss(h_, w_):
        return jlayers.chunked_cross_entropy(h_, w_, lab, chunk=8,
                                             valid_vocab=37)
    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    tl = tlayers.chunked_cross_entropy(th, tw, torch.from_numpy(lab),
                                       chunk=8, valid_vocab=37)
    tl.backward()
    assert abs(float(jl) - float(tl.detach())) <= LOSS_TOL
    _grads_close({"h": jgh, "w": jgw}, {"h": th.grad, "w": tw.grad})
    # the masked columns take no gradient on either side
    assert float(tw.grad[:, 37:].abs().max()) == 0.0


def test_chunked_cross_entropy_rounds_the_head_product_like_jax():
    """Trap T4: with operands that are not bf16-exact, a plain f32 product
    is a different function — the loss differs from JAX's well past the
    tolerance, while the port's matches."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(1, 16, 64)).astype(np.float32)
    head = rng.normal(size=(64, 48)).astype(np.float32)
    lab = rng.integers(0, 48, (1, 16)).astype(np.int32)
    jl = float(jlayers.chunked_cross_entropy(jnp.asarray(h),
                                             jnp.asarray(head), lab))
    tl = float(tlayers.chunked_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(head), torch.from_numpy(lab)))
    logits = h[0] @ head
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    f32 = float(np.mean(lse - logits[np.arange(16), lab[0]]))
    assert abs(jl - tl) <= LOSS_TOL
    assert abs(jl - f32) > 10 * LOSS_TOL


@pytest.mark.parametrize("name", ["tiny", "qwen3_padded", "granite_moe"])
def test_forward_ref_loss_and_grads_match_jax(name):
    """forward_ref(mode="train", labels=) returns the same loss, aux term
    included, and every leaf's grad matches jax.grad — the padded layer
    slot of qwen3_padded is zero on both sides."""
    arch, jarch = _archs()[name]
    jp, tp = _params(jarch)
    x, y = _tokens(jarch.vocab_size)
    f = jax.jit(jax.value_and_grad(lambda p: jlm.forward_ref(
        jarch, p, x, mode="train", labels=y)[0]))
    jl, jg = f(jp)
    tl, tg = _port_loss_and_grads(arch, tp, x, y)
    assert abs(float(jl) - tl) <= LOSS_TOL, (float(jl), tl)
    _grads_close(jg, tg)
    if arch.padded_layers > arch.num_layers:
        for leaf in tg["blocks"].values():
            assert float(leaf[arch.num_layers:].abs().max()) == 0.0


def test_granite_loss_carries_the_aux_term():
    """The MoE load-balancing loss is passed through: the training loss is
    lm_loss + 0.01 * sum(aux) / num_layers, not lm_loss alone."""
    arch, jarch = _archs()["granite_moe"]
    _, tp = _params(jarch)
    x, y = _tokens(jarch.vocab_size)
    with torch.no_grad():
        loss, _ = tlm.forward_ref(arch, tp, torch.from_numpy(x),
                                  mode="train", labels=torch.from_numpy(y))
        hid, _ = tlm.forward_ref(arch, tp, torch.from_numpy(x), mode="train")
        ce = tlm.lm_loss(arch, tp, hid, torch.from_numpy(y))
    aux = (float(loss) - float(ce)) * arch.num_layers / 0.01
    # Switch aux is E * sum_e f_e p_e: 1 at perfect balance, near it here
    assert 0.5 * arch.num_layers < aux < 4.0 * arch.num_layers, aux


def test_lm_loss_chunk_below_s_matches_jax():
    """lm_loss with chunk 8 over S 32 on the padded-vocab qwen3."""
    arch, jarch = _archs()["qwen3_padded"]
    jp, tp = _params(jarch)
    rng = np.random.default_rng(3)
    hid = rng.normal(size=(2, 32, arch.d_model)).astype(np.float32)
    _, y = _tokens(jarch.vocab_size)
    jl = float(jlm.lm_loss(jarch, jp, jnp.asarray(hid), y, chunk=8))
    tl = float(tlm.lm_loss(arch, tp, torch.from_numpy(hid),
                           torch.from_numpy(y), chunk=8))
    assert abs(jl - tl) <= LOSS_TOL
