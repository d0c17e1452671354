"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of repro_torch.kernels runs its plain PyTorch
version; these tests hold those against the Pallas kernels in interpret
mode, over the sweeps of tests/test_kernels.py, with the same inputs (made
with numpy from a seed) handed to both. Tolerances: 2e-5 in f32 (the two
sum in different orders) and 5e-2 in bf16 (one bf16 rounding of the
output, plus rounding of intermediates in the Pallas kernel). The Hopper
kernels themselves are held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as j_attn
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged

F32, BF16 = "float32", "bfloat16"


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == BF16 \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(x, dtype=F32):
    """The same values as a jnp array and a CPU torch tensor of `dtype`
    (both round f32 -> bf16 to nearest even)."""
    x = np.asarray(x, np.float32)
    t = torch.from_numpy(x.copy())
    return (jnp.asarray(x, getattr(jnp, dtype)), t.to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 64, 16), (2, 4, 2, 128, 32), (1, 8, 1, 96, 64),
])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_matches_pallas(B, H, KV, S, hd, window, dtype):
    rng = np.random.default_rng(B * 1000 + S + window)
    jq, tq = _pair(rng.standard_normal((B, H, S, hd)), dtype)
    jk, tk = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    want = j_attn(jq, jk, jv, causal=True, window=window, block_q=32,
                  block_k=32, interpret=True)
    got = flash_attention_fwd(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_flash_attention_refuses_unequal_lengths():
    """Trap T1: the Pallas kernel aligns q to the start of k (it ignores
    gq0_last), the plain version aligns the ends; they disagree whenever
    Sq != Sk, so the port's wrapper refuses that case on every device."""
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((1, 2, 32, 16)))
    jk, tk = _pair(rng.standard_normal((1, 2, 64, 16)))
    pallas = j_attn(jq, jk, jk, causal=True, block_q=32, block_k=32,
                    interpret=True)
    assert not np.allclose(_np(pallas), _np(tref.attention_ref(tq, tk, tk)),
                           atol=1e-3)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_fwd(tq, tk, tk)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (2, 4, 2, 128, 32),           # GQA G=2
    (1, 6, 6, 64, 16),            # MHA: G == 1, H == KV
])
@pytest.mark.parametrize("length", [0, 1, 37, 64])
@pytest.mark.parametrize("window", [0, 48, 96])
def test_flash_decode_matches_pallas(B, H, KV, S, hd, length, window):
    rng = np.random.default_rng(S + length + window)
    jq, tq = _pair(rng.standard_normal((B, H, hd)))
    jk, tk = _pair(rng.standard_normal((B, KV, S, hd)))
    jv, tv = _pair(rng.standard_normal((B, KV, S, hd)))
    want = j_decode(jq, jk, jv, length, window=window, block_k=32,
                    interpret=True)
    got = flash_decode(tq, tk, tv, length, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    if length == 0:
        assert np.all(_np(got) == 0.0)


def test_flash_decode_zero_length_ignores_uninitialized_v():
    B, H, KV, S, hd = 2, 4, 2, 32, 16
    q1 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, H, hd)).astype(np.float32))
    k = torch.full((B, KV, S, hd), 1e6)
    v = torch.full((B, KV, S, hd), -1e6)
    assert torch.all(flash_decode(q1, k, v, 0) == 0.0)


def test_flash_decode_per_row_lengths():
    """A [B] int32 length vector masks each row at its own depth, and each
    row equals a scalar-length Pallas call at that depth."""
    B, H, KV, S, hd = 4, 4, 2, 64, 16
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng.standard_normal((B, H, hd)))
    jk, tk = _pair(rng.standard_normal((B, KV, S, hd)))
    jv, tv = _pair(rng.standard_normal((B, KV, S, hd)))
    lens = [0, 1, 33, 64]
    got = flash_decode(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    want = j_decode(jq, jk, jv, jnp.asarray(lens, jnp.int32), block_k=16,
                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    assert torch.all(got[0] == 0.0)
    for b, n in enumerate(lens):
        one = j_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], n, block_k=16,
                       interpret=True)
        np.testing.assert_allclose(_np(got[b]), _np(one[0]), atol=2e-5,
                                   rtol=2e-5)


def test_flash_decode_unaligned_cache():
    """A cache length that is not a whole number of blocks: the Pallas
    wrapper pads dead positions, the port masks the ragged tail."""
    B, H, KV, S, hd = 2, 4, 2, 37, 16
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.standard_normal((B, H, hd)))
    jk, tk = _pair(rng.standard_normal((B, KV, S, hd)))
    jv, tv = _pair(rng.standard_normal((B, KV, S, hd)))
    want = j_decode(jq, jk, jv, 37, block_k=16, interpret=True)
    np.testing.assert_allclose(_np(flash_decode(tq, tk, tv, 37)), _np(want),
                               atol=2e-5, rtol=2e-5)


def test_flash_decode_strided_view():
    """The Engine hands the contiguous cache group over as the strided view
    kf[i].transpose(1, 2); the result equals the contiguous copy's."""
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(rng.standard_normal((2, 3, 40, 2, 16)).astype(
        np.float32))
    q1 = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    lens = torch.tensor([5, 40, 0], dtype=torch.int32)
    view = cache[1].transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(flash_decode(q1, view, view, lens),
                               flash_decode(q1, view.contiguous(),
                                            view.contiguous(), lens))


@pytest.mark.parametrize("pool_dtype", ["float32", "float8_e4m3fn"])
def test_flash_decode_paged_matches_pallas(pool_dtype):
    """The stacked pool [groups, pages+1, ps, KV, hd] through the block
    table: unmapped (-1) entries, rows at their own lengths, a length-0
    row, and an fp8 pool read identically by both."""
    L, P1, ps, B, KV, G, hd = 2, 9, 4, 3, 2, 2, 16
    H = KV * G
    rng = np.random.default_rng(5)
    pools = []
    for _ in range(2):
        j = jnp.asarray(rng.standard_normal((L, P1, ps, KV, hd)),
                        jnp.float32).astype(getattr(jnp, pool_dtype))
        # the torch pool holds exactly the values the jax pool holds
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            getattr(torch, pool_dtype))
        pools.append((j, t))
    jq, tq = _pair(rng.standard_normal((B, H, hd)))
    tab = [[0, 3, 6], [1, 4, -1], [-1, -1, -1]]
    lens = [11, 6, 0]
    for layer in (0, 1):
        want = j_paged(jq, pools[0][0], pools[1][0],
                       jnp.asarray(tab, jnp.int32),
                       jnp.asarray(lens, jnp.int32), layer=layer,
                       interpret=True)
        got = flash_decode_paged(tq, pools[0][1], pools[1][1],
                                 torch.tensor(tab, dtype=torch.int32),
                                 torch.tensor(lens, dtype=torch.int32),
                                 layer=layer)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5,
                                   rtol=2e-5)
        assert torch.all(got[2] == 0.0)


def test_flash_decode_paged_matches_contiguous():
    """A contiguous cache scattered across out-of-order pages and read back
    through the block table reproduces the contiguous decode."""
    B, KV, G, hd, ps, npg = 2, 2, 2, 16, 4, 4
    H, S = KV * G, ps * npg
    rng = np.random.default_rng(6)
    q1 = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(
        np.float32))
    perm = rng.permutation(B * npg)
    tab = torch.tensor(perm.reshape(B, npg), dtype=torch.int32)
    pool_k = torch.zeros((1, B * npg + 1, ps, KV, hd))
    pool_v = torch.zeros((1, B * npg + 1, ps, KV, hd))
    for b in range(B):
        for pi in range(npg):
            sl = slice(pi * ps, (pi + 1) * ps)
            pool_k[0, perm[b * npg + pi]] = k[b, :, sl].transpose(0, 1)
            pool_v[0, perm[b * npg + pi]] = v[b, :, sl].transpose(0, 1)
    lens = torch.tensor([S, S - 3], dtype=torch.int32)
    torch.testing.assert_close(
        flash_decode_paged(q1, pool_k, pool_v, tab, lens, layer=0),
        flash_decode(q1, k, v, lens), atol=2e-5, rtol=2e-5)


def test_backends_and_dispatch():
    """The port's backends are ref / cuda; both routes agree on CPU
    tensors, and the CPU route launches nothing."""
    assert ops.BACKENDS == ("ref", "cuda")
    for bad in ("interpret", "tpu", "triton"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            ops.check_backend(bad)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32))
    before = dict(LAUNCHES)
    torch.testing.assert_close(ops.attention(q, k, k, backend="cuda"),
                               ops.attention(q, k, k, backend="ref"))
    q1 = q[:, 0]
    kT = k.transpose(1, 2)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q1, kT, kT, lens, backend="cuda"),
        ops.decode_attention(q1, kT, kT, lens, backend="ref"))
    assert LAUNCHES == before


def test_backend_registry():
    """tests/test_kernels.py's registry test with the port's names:
    set_backend validates eagerly (ValueError, not a strippable assert);
    use_backend scopes and restores the process global."""
    assert ops.check_backend("ref") == "ref"
    assert ops.KERNEL_BACKEND == "ref"            # the JAX package's default
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.set_backend("interpret")
    before = ops.KERNEL_BACKEND
    with ops.use_backend("cuda"):
        assert ops.KERNEL_BACKEND == "cuda"
        assert ops.check_backend(None) == "cuda"
        with ops.use_backend("ref"):
            assert ops.KERNEL_BACKEND == "ref"
        assert ops.KERNEL_BACKEND == "cuda"
    assert ops.KERNEL_BACKEND == before
    with pytest.raises(ValueError):
        with ops.use_backend("mosaic"):
            pass
    assert ops.KERNEL_BACKEND == before


def test_ops_dispatch_uses_ambient_backend():
    """ops.decode_attention honors use_backend when no explicit backend is
    passed, and both routes agree (on CPU tensors the "cuda" wrapper runs
    its plain version: no launch)."""
    rng = np.random.default_rng(3)
    B, H, KV, S, hd = 2, 4, 2, 32, 16
    q1, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((B, H, hd), (B, KV, S, hd), (B, KV, S, hd)))
    lens = torch.tensor([32, 7], dtype=torch.int32)
    ref = ops.decode_attention(q1, k, v, lens)            # default "ref"
    before = dict(LAUNCHES)
    with ops.use_backend("cuda"):
        out = ops.decode_attention(q1, k, v, lens)
        # the ambient backend reaches the wrapper: on meta it reports the
        # launch to a cost counter instead of running the plain version
        from repro_torch.launch.costs import CostCounter
        with CostCounter() as c:
            ops.decode_attention(*(t.to("meta") for t in (q1, k, v)),
                                 lens.to("meta"))
        c.close()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    assert c.total().kernels["flash_decode"]["simt_f32"] == 1
    assert LAUNCHES == before
