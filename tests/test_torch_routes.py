"""The routes of the kernels, on the CPU.

Every kernel picks a route before each CUDA launch (kernels/moe_gmm.py,
flash_attention.py, flash_decode.py, rwkv6_scan.py, mamba_ssd.py: `_route`):
a pure function of dtype, shape, strides and alignment, so these tests call
it on CPU tensors. bf16 operands whose rows are 16-byte aligned take the
tensor-core routes (the serve path's always are, at every head dim up to
256); d or f not a multiple of 8, an odd element offset, a stride off the
16-byte grid or float32 take the f32-FMA (SIMT) routes. The chunked WKV6 and SSD kernels
(float32 only) take their register-tile route ("tile") where the rows are
16-byte aligned, as the model's views are at every S, else "simt". The card
tests (tests/test_torch_cuda.py) assert the same routes on the launches they
make. The decode kernels also split each row's positions across blocks by
kernels/flash_decode.py:_splits, a pure function of static shapes.

The route sweeps' shapes (C 1..321 across the decode / prefill seam, S 1,
63, 65, 100 across the 64-row tile edge, decode lengths at the split
edges) also go through the port's plain versions (what the wrappers run on
the CPU, and what the card holds the kernels to) and the Pallas kernels in
interpret mode, with the same inputs made with numpy: 2e-5 in f32 (sums in
another order), 5e-2 in bf16 (one rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as j_attn
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro.kernels.moe_gmm import grouped_matmul as j_gmm
from repro_torch.kernels import LAUNCHES, ROUTES, _build, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import mamba_ssd, moe_gmm, rwkv6_scan

BF16, F32 = torch.bfloat16, torch.float32


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _offset(shape, dtype, elems=1):
    """A contiguous tensor of `shape` whose base sits `elems` elements past
    an aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


def _gmm_operands(case):
    """(x, w) for a named grouped_matmul case."""
    if case == "decode w_in":                 # granite's decode step
        x = torch.zeros(8, 32, 1024, dtype=BF16).transpose(0, 1)
        w = torch.zeros(32, 1024, 2, 512, dtype=BF16).reshape(32, 1024, 1024)
    elif case == "decode w_out":
        x = torch.zeros(32, 8, 512, dtype=BF16)
        w = torch.zeros(32, 512, 1024, dtype=BF16)
    elif case == "prefill w_in":              # granite's prefill group
        x = torch.zeros(32, 320, 1024, dtype=BF16)
        w = torch.zeros(32, 1024, 1024, dtype=BF16)
    elif case == "prefill w_out":
        x = torch.zeros(320, 32, 512, dtype=BF16).transpose(0, 1)
        w = torch.zeros(32, 512, 1024, dtype=BF16)
    elif case == "C 16":
        x, w = torch.zeros(3, 16, 72, dtype=BF16), torch.zeros(3, 72, 40,
                                                                dtype=BF16)
    elif case == "C 17":
        x, w = torch.zeros(3, 17, 72, dtype=BF16), torch.zeros(3, 72, 40,
                                                                dtype=BF16)
    elif case == "C 1, odd stride of the size-1 dim":
        x = torch.zeros(3 * 72, dtype=BF16).as_strided((3, 1, 72),
                                                       (72, 3, 1))
        w = torch.zeros(3, 72, 40, dtype=BF16)
    elif case == "d 5":
        x, w = torch.zeros(2, 1, 5, dtype=BF16), torch.zeros(2, 5, 3,
                                                              dtype=BF16)
    elif case == "f 12":
        x, w = torch.zeros(2, 4, 16, dtype=BF16), torch.zeros(2, 16, 12,
                                                               dtype=BF16)
    elif case == "odd offset":
        x, w = _offset((4, 13, 72), BF16), torch.zeros(4, 72, 40, dtype=BF16)
    elif case == "odd offset of w":
        x, w = torch.zeros(4, 13, 72, dtype=BF16), _offset((4, 72, 40), BF16)
    elif case == "row stride off the grid":
        x = torch.zeros(4, 13, 76, dtype=BF16)[..., :72]   # rows 152 bytes
        w = torch.zeros(4, 72, 40, dtype=BF16)
    elif case == "float32":
        x, w = torch.zeros(32, 8, 1024), torch.zeros(32, 1024, 1024)
    else:
        raise KeyError(case)
    return x, w


@pytest.mark.parametrize("case,want", [
    ("decode w_in", "tc_decode"), ("decode w_out", "tc_decode"),
    ("prefill w_in", "tc_prefill"), ("prefill w_out", "tc_prefill"),
    ("C 16", "tc_decode"), ("C 17", "tc_prefill"),
    ("C 1, odd stride of the size-1 dim", "tc_decode"),
    ("d 5", "simt_bf16"), ("f 12", "simt_bf16"), ("odd offset", "simt_bf16"),
    ("odd offset of w", "simt_bf16"),
    ("row stride off the grid", "simt_bf16"), ("float32", "simt_f32"),
])
def test_grouped_matmul_route(case, want):
    x, w = _gmm_operands(case)
    assert moe_gmm._route(x, w) == want
    assert want in ROUTES["grouped_matmul"]


def _attn_operands(case):
    """(q, k, v) [B, H, S, hd] views for a named flash_attention_fwd case,
    laid out [B, S, heads, hd] as the model hands them over."""
    def model(B, S, H, KV, hd, dtype=BF16):
        return tuple(torch.zeros(B, S, n, hd, dtype=dtype).transpose(1, 2)
                     for n in (H, KV, KV))
    if case == "qwen3 16/8 x 128":
        return model(8, 128, 16, 8, 128)
    if case == "granite 16/8 x 64":
        return model(8, 128, 16, 8, 64)
    if case == "hymba 25/5 x 64, S 1100":
        return model(4, 1100, 25, 5, 64)
    if case == "hd 16":
        return model(2, 100, 2, 2, 16)
    if case == "hd 32":
        return model(2, 65, 4, 2, 32)
    if case == "hd 256":
        return model(1, 64, 2, 1, 256)
    if case == "hd 256, odd offset":
        q = _offset((1, 64, 4, 256), BF16).transpose(1, 2)
        k, v = model(1, 64, 4, 1, 256)[1:]
        return q, k, v
    if case == "odd offset":
        q = _offset((2, 100, 4, 64), BF16).transpose(1, 2)
        k, v = model(2, 100, 4, 2, 64)[1:]
        return q, k, v
    if case == "float32":
        return model(8, 128, 16, 8, 128, F32)
    raise KeyError(case)


@pytest.mark.parametrize("case,want", [
    ("qwen3 16/8 x 128", "tc"), ("granite 16/8 x 64", "tc"),
    ("hymba 25/5 x 64, S 1100", "tc"), ("hd 16", "tc"), ("hd 32", "tc"),
    ("hd 256", "tc"), ("hd 256, odd offset", "simt_bf16"),
    ("odd offset", "simt_bf16"), ("float32", "simt_f32"),
])
def test_flash_attention_route(case, want):
    q, k, v = _attn_operands(case)
    assert fa._route(q, k, v) == want
    assert want in ROUTES["flash_attention_fwd"]


def test_vec16_ok_reads_base_shape_and_strides():
    """The tensor-core routes' one precondition on a tensor."""
    assert _build.vec16_ok(torch.zeros(3, 5, 16, dtype=BF16))
    assert _build.vec16_ok(torch.zeros(5, 3, 8, dtype=BF16).transpose(0, 1))
    assert _build.vec16_ok(torch.zeros(3, 5, 4))               # f32: 16 B
    assert not _build.vec16_ok(torch.zeros(3, 5, 12, dtype=BF16))
    assert not _build.vec16_ok(_offset((3, 5, 16), BF16))
    assert not _build.vec16_ok(torch.zeros(3, 5, 20, dtype=BF16)[..., :16])
    # a dim of length 1 places no constraint on its stride
    assert _build.vec16_ok(torch.zeros(48, dtype=BF16).as_strided(
        (3, 1, 16), (16, 3, 1)))


def _wkv6_operands(case):
    """(r, k, v, w) [B, H, S, hd] f32 for a named rwkv6_chunked case, laid
    out [B, S, H, hd] as the model hands them over unless noted."""
    def model(B, S, H=40, hd=64):
        return tuple(torch.zeros(B, S, H, hd).transpose(1, 2)
                     for _ in range(4))
    if case == "rwkv6-3b serve, S 128":
        return model(8, 128)
    if case == "S 1":
        return model(8, 1)
    if case == "prime S 13":
        return model(2, 13)
    if case == "S 1100":
        return model(1, 1100, 4)
    if case == "contiguous [B, H, S, hd]":
        return tuple(torch.zeros(2, 3, 17, 64) for _ in range(4))
    if case == "odd offset":
        base = _offset((2, 17, 3, 64), F32).transpose(1, 2)
        return (base,) + model(2, 17, 3)[1:]
    if case == "row stride off the grid":
        rows = torch.zeros(2, 17, 3 * 64 + 2)[..., :3 * 64]
        return tuple(rows.reshape(2, 17, 3, 64).transpose(1, 2)
                     for _ in range(4))
    raise KeyError(case)


@pytest.mark.parametrize("case,want", [
    ("rwkv6-3b serve, S 128", "tile"), ("S 1", "tile"),
    ("prime S 13", "tile"), ("S 1100", "tile"),
    ("contiguous [B, H, S, hd]", "tile"), ("odd offset", "simt"),
    ("row stride off the grid", "simt"),
])
def test_rwkv6_route(case, want):
    assert rwkv6_scan._route(*_wkv6_operands(case)) == want
    assert want in ROUTES["rwkv6_chunked"]


def _ssd_operands(case):
    """(x, B_, C_) for a named ssd_chunked case: x [B, H, S, P] and B_, C_
    [B, S, N] column slices of one [B, S, H P + 2 N] conv output, as the
    model hands them over, unless noted."""
    def model(B, S, H=50, P=64, N=16, extra=0):
        conv = torch.zeros(B, S, H * P + 2 * N + extra)[..., :H * P + 2 * N]
        x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
        return x, conv[..., H * P:H * P + N], conv[..., H * P + N:]
    if case == "hymba serve, S 128":
        return model(8, 128)
    if case == "hymba generate, S 1100":
        return model(4, 1100)
    if case == "S 1":
        return model(8, 1)
    if case == "prime S 13":
        return model(2, 13, 4)
    if case == "bf16 path: x copied, B_ / C_ copied":
        return (torch.zeros(8, 128, 50, 64).transpose(1, 2),
                torch.zeros(8, 128, 16), torch.zeros(8, 128, 16))
    if case == "odd offset of x":
        x, Bm, Cm = model(2, 13, 4)
        return _offset((2, 13, 4, 64), F32).transpose(1, 2), Bm, Cm
    if case == "row stride off the grid":
        return model(2, 13, 4, extra=1)
    if case == "granite4h group [64, 128, 512, 64], N 128":
        return model(64, 512, 128, N=128)
    if case == "N 128, S 1":
        return model(2, 1, 128, N=128)
    if case == "N 128, odd offset of x":
        x, Bm, Cm = model(2, 13, 4, N=128)
        return _offset((2, 13, 4, 64), F32).transpose(1, 2), Bm, Cm
    if case == "N 128, row stride off the grid":
        return model(2, 13, 4, N=128, extra=1)
    raise KeyError(case)


@pytest.mark.parametrize("case,want", [
    ("hymba serve, S 128", "tile"), ("hymba generate, S 1100", "tile"),
    ("S 1", "tile"), ("prime S 13", "tile"),
    ("bf16 path: x copied, B_ / C_ copied", "tile"),
    ("odd offset of x", "simt"), ("row stride off the grid", "simt"),
    ("granite4h group [64, 128, 512, 64], N 128", "tile"),
    ("N 128, S 1", "tile"), ("N 128, odd offset of x", "simt"),
    ("N 128, row stride off the grid", "simt"),
])
def test_ssd_route(case, want):
    assert mamba_ssd._route(*_ssd_operands(case)) == want
    assert want in ROUTES["ssd_chunked"]


def test_cpu_wrappers_launch_nothing_and_count_no_route():
    """On CPU tensors the wrappers run their plain versions whatever the
    route would be; launches and routes stay at 0, and reset_launches zeroes
    both tables."""
    reset_launches()
    x = torch.randn(2, 17, 16).to(BF16)
    w = torch.randn(2, 16, 24).to(BF16)
    moe_gmm.grouped_matmul(x, w)
    q = torch.randn(1, 2, 65, 32).to(BF16)
    fa.flash_attention_fwd(q, q[:, :1], q[:, :1])
    q1 = torch.randn(2, 4, 32).to(BF16)
    cache = torch.randn(2, 2, 40, 32).to(BF16)
    fd.flash_decode(q1, cache, cache, 17)
    pool = torch.randn(1, 5, 4, 2, 32).to(BF16)
    tab = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    fd.flash_decode_paged(q1, pool, pool, tab, torch.tensor(
        [7, 3], dtype=torch.int32))
    wkv = _wkv6_operands("prime S 13")
    rwkv6_scan.rwkv6_chunked(*wkv, torch.zeros(40, 64))
    x, Bm, Cm = _ssd_operands("prime S 13")
    mamba_ssd.ssd_chunked(x, torch.zeros(2, 4, 13), Bm, Cm,
                          -torch.ones(4))
    assert all(n == 0 for n in LAUNCHES.values())
    assert all(n == 0 for r in ROUTES.values() for n in r.values())
    _build.count("grouped_matmul", "tc_prefill")
    _build.count("flash_attention_fwd", "tc")
    _build.count("flash_decode", "simt_f32")
    _build.count("flash_decode_paged", "tc")
    _build.count("rwkv6_chunked", "tile")
    _build.count("ssd_chunked", "simt")
    assert LAUNCHES["grouped_matmul"] == ROUTES["grouped_matmul"][
        "tc_prefill"] == 1
    assert LAUNCHES["rwkv6_chunked"] == ROUTES["rwkv6_chunked"]["tile"] == 1
    assert LAUNCHES["ssd_chunked"] == ROUTES["ssd_chunked"]["simt"] == 1
    assert LAUNCHES["flash_decode_paged"] == ROUTES["flash_decode_paged"][
        "tc"] == 1
    reset_launches()
    assert all(n == 0 for r in ROUTES.values() for n in r.values())
    assert all(n == 0 for n in LAUNCHES.values())


@pytest.mark.parametrize("C", [1, 8, 16, 17, 100, 321])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_route_sweep_matches_pallas(C, dtype):
    """The route sweep's shapes (d 72, f 40; C across the decode / prefill
    seam at 16 and past the 64-row tiles) through the wrapper on the CPU
    (its plain version) and the Pallas grouped_matmul in interpret mode;
    x handed over strided, as the model may."""
    E, d, f = 3, 72, 40
    rng = np.random.default_rng(C)
    x = rng.standard_normal((C, E, d)).astype(np.float32).transpose(1, 0, 2)
    w = (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32)
    jx, jw = (jnp.asarray(a, dtype) for a in (x, w))
    want = j_gmm(jx, jw, block_c=16, block_f=8, block_d=24, interpret=True)
    tdt = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tx = tx.transpose(0, 1).contiguous().transpose(0, 1)     # [C, E, d] memory
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(tdt)
    got = moe_gmm.grouped_matmul(tx, tw)
    assert got.dtype == tdt and got.shape == (E, C, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("S", [1, 63, 65, 100])
@pytest.mark.parametrize("window", [0, 40])
def test_attention_route_sweep_matches_pallas(S, window):
    """The route sweep's lengths (one token, either side of the 64-row
    tile, a ragged 100) at hd 64 and GQA 4/2 in bf16 through the wrapper on
    the CPU and the Pallas flash_attention_fwd in interpret mode."""
    rng = np.random.default_rng(S + window)
    arrs = [rng.standard_normal((2, n, S, 64)).astype(np.float32)
            for n in (4, 2, 2)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = j_attn(jq, jk, jv, causal=True, window=window, block_q=32,
                  block_k=32, interpret=True)
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(BF16)
                  for a in (jq, jk, jv))
    got = fa.flash_attention_fwd(tq, tk, tv, causal=True, window=window)
    assert got.dtype == BF16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol("bfloat16"))


def _decode_operands(case):
    """(q1, k, v) for a named decode case: the contiguous cache as the
    Engine hands it over (the [B, KV, S, hd] view of a [B, S, KV, hd]
    group), or the serve pool [groups, pages + 1, page size, KV, hd]."""
    def cache(B, S, H, KV, hd, dtype=BF16):
        return (torch.zeros(B, H, hd, dtype=dtype),
                *(torch.zeros(2, B, S, KV, hd, dtype=dtype)[1].transpose(1, 2)
                  for _ in range(2)))

    def pool(B, H, KV, hd, dtype=BF16, pool_dtype=None):
        p = torch.zeros(3, 49, 16, KV, hd, dtype=pool_dtype or dtype)
        return torch.zeros(B, H, hd, dtype=dtype), p, p
    if case == "qwen3 16/8 x 128 cache":
        return cache(8, 160, 16, 8, 128)
    if case == "qwen3 16/8 x 128 pool":
        return pool(8, 16, 8, 128)
    if case == "granite 16/8 x 64 cache":
        return cache(8, 160, 16, 8, 64)
    if case == "granite 16/8 x 64 pool":
        return pool(8, 16, 8, 64)
    if case == "hymba 25/5 x 64 cache, S 1132":
        return cache(4, 1132, 25, 5, 64)
    if case == "hymba 25/5 x 64 pool":
        return pool(8, 25, 5, 64)
    if case == "fp8 pool":
        return pool(8, 16, 8, 128, pool_dtype=torch.float8_e4m3fn)
    if case == "hd 16 pool":
        return pool(2, 4, 2, 16)
    if case == "hd 32 cache":
        return cache(2, 40, 4, 2, 32)
    if case == "hd 256 cache":
        return cache(2, 40, 4, 2, 256)
    if case == "hd 256 pool":
        return pool(2, 4, 2, 256)
    if case == "hd 256 fp8 pool":
        return pool(8, 4, 1, 256, pool_dtype=torch.float8_e4m3fn)
    if case == "gemma3 tp shard 1/1 x 256 pool":
        return pool(1, 1, 1, 256)
    if case == "hd 256, odd offset of the cache":
        q1 = torch.zeros(2, 4, 256, dtype=BF16)
        k = _offset((2, 40, 1, 256), BF16).transpose(1, 2)
        return q1, k, k
    if case == "odd offset of the cache":
        q1 = torch.zeros(2, 4, 64, dtype=BF16)
        k = _offset((2, 40, 2, 64), BF16).transpose(1, 2)
        return q1, k, k
    if case == "odd offset of q1":
        _, k, v = pool(2, 4, 2, 64)
        return _offset((2, 4, 64), BF16), k, v
    if case == "float32 cache":
        return cache(8, 160, 16, 8, 128, F32)
    if case == "float32 q1, fp8 pool":
        return pool(8, 16, 8, 128, F32, torch.float8_e4m3fn)
    raise KeyError(case)


@pytest.mark.parametrize("case,want", [
    ("qwen3 16/8 x 128 cache", "tc"), ("qwen3 16/8 x 128 pool", "tc"),
    ("granite 16/8 x 64 cache", "tc"), ("granite 16/8 x 64 pool", "tc"),
    ("hymba 25/5 x 64 cache, S 1132", "tc"), ("hymba 25/5 x 64 pool", "tc"),
    ("fp8 pool", "tc"), ("hd 16 pool", "tc"), ("hd 32 cache", "tc"),
    # tc takes every head dim, hd 256 too (gemma3-1b: G 4, and G 1 on a
    # tp shard), over a bf16 or an fp8 pool; unaligned rows go to SIMT
    ("hd 256 cache", "tc"), ("hd 256 pool", "tc"), ("hd 256 fp8 pool", "tc"),
    ("gemma3 tp shard 1/1 x 256 pool", "tc"),
    ("hd 256, odd offset of the cache", "simt_bf16"),
    ("odd offset of the cache", "simt_bf16"),
    ("odd offset of q1", "simt_bf16"),
    ("float32 cache", "simt_f32"), ("float32 q1, fp8 pool", "simt_f32"),
])
def test_flash_decode_route(case, want):
    q1, k, v = _decode_operands(case)
    assert fd._route(q1, k, v) == want
    name = "flash_decode_paged" if "pool" in case else "flash_decode"
    assert want in ROUTES[name]


@pytest.mark.parametrize("B,KV,cap,route,want", [
    # the serve pools and qwen3's generate cache: one block walks a row
    (8, 8, 160, "tc", (1, 160)), (8, 5, 160, "tc", (1, 160)),
    (4, 5, 1132, "tc", (5, 256)),       # hymba's generate cache
    (9, 2, 700, "tc", (3, 256)),        # the card tests' sweep
    (8, 8, 16, "tc", (1, 16)),          # a 16-position cache: one split
    (1, 1, 8192, "tc", (32, 256)),      # one pair: chunks of the span
    (1, 1, 65536, "tc", (64, 1024)),    # ... and at most MAX_SPLITS
    (64, 8, 4096, "tc", (1, 4096)),     # 512 pairs fill the card unsplit
    (8, 8, 0, "tc", (1, 16)),           # an empty cache: zeros, one block
    # the SIMT routes keep 16 positions in flight: short chunks, two
    # blocks an SM
    (8, 8, 160, "simt_f32", (5, 32)), (8, 5, 160, "simt_bf16", (10, 16)),
    (4, 5, 1132, "simt_f32", (15, 80)), (8, 8, 16, "simt_f32", (1, 16)),
])
def test_decode_splits(B, KV, cap, route, want):
    """The split of each row's positions: chunks a multiple of 16, at least
    the route's span (or the whole capacity), covering the capacity, at
    most MAX_SPLITS of them, and enough for two blocks per SM where the
    span leaves room (the SIMT rows); from static shapes and the route
    alone."""
    splits, chunk = fd._splits(B, KV, cap, route)
    assert (splits, chunk) == want
    assert chunk % fd.TILE == 0 and splits * chunk >= cap
    assert chunk >= min(fd.SPAN[route], cap)
    assert splits <= fd.MAX_SPLITS and (splits == 1 or
                                        (splits - 1) * chunk < cap)
    if route != "tc" and cap >= 160:
        assert B * KV * splits >= fd.MIN_BLOCKS


@pytest.mark.parametrize("B,KV,cap,route,want", [
    (8, 1, 160, "tc", (1, 160)),        # gemma3's serve pool: one block
    (1, 1, 160, "tc", (1, 160)),        # ... a tp shard's 1-row microbatch
    (4, 1, 1132, "tc", (6, 192)),       # a cache of 1,132: chunks of 192
    (12, 2, 700, "tc", (4, 192)),       # the card tests' sweep
    (8, 1, 0, "tc", (1, 16)),           # an empty cache: zeros, one block
    (8, 1, 160, "simt_bf16", (10, 16)), (4, 1, 1132, "simt_f32", (36, 32)),
])
def test_decode_splits_hd256(B, KV, cap, route, want):
    """At hd 256 a tc block walks with 6 warps (a warp's ring takes 33 KB
    of shared memory), so its span is 192 positions, not 256; the SIMT
    routes' splits do not depend on the head dim."""
    splits, chunk = fd._splits(B, KV, cap, route, 256)
    assert (splits, chunk) == want
    assert chunk % fd.TILE == 0 and splits * chunk >= cap
    assert chunk >= min(fd.SPAN_HD256[route], cap)
    if route != "tc":
        assert (splits, chunk) == fd._splits(B, KV, cap, route)


def _decode_pair(shape, rng):
    """The same f32 normal draws as a jnp array and a CPU torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("window", [0, 100])
def test_decode_split_edges_match_pallas(window):
    """Lengths at the split edges of hymba's generate cache (B 8, KV 5, S
    1132: chunks of 256 on the tensor-core route, of 160 on the SIMT
    ones): 15 / 16 / 17 across the first tile, chunk - 1 / chunk / chunk +
    1 of both, 1131 and the full 1132; window 100 starts mid-chunk for the
    long rows. The contiguous wrapper on the CPU (its plain version)
    against the Pallas flash_decode in interpret mode, f32."""
    B, H, KV, S, hd = 12, 25, 5, 1132, 16
    assert fd._splits(8, KV, S, "tc") == (5, 256)
    assert fd._splits(8, KV, S, "simt_f32") == (8, 160)
    lens = [15, 16, 17, 159, 160, 161, 255, 256, 257, 600, S - 1, S]
    rng = np.random.default_rng(window + 1)
    jq, tq = _decode_pair((B, H, hd), rng)
    jk, tk = _decode_pair((B, KV, S, hd), rng)
    jv, tv = _decode_pair((B, KV, S, hd), rng)
    want = j_decode(jq, jk, jv, jnp.asarray(lens, jnp.int32), window=window,
                    block_k=128, interpret=True)
    got = fd.flash_decode(tq, tk, tv, torch.tensor(lens, dtype=torch.int32),
                          window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_tol("float32"))


@pytest.mark.parametrize("ps", [4, 16])
def test_paged_decode_split_edges_match_pallas(ps):
    """The paged wrapper at hymba's heads (25/5, G 5) with 16-position
    chunks on the SIMT routes (B 8, KV 5; one chunk on the tensor-core
    route): lengths 0, 15 / 16 / 17 across a chunk, 33, 47 and
    the capacity, pages of 4 and 16 scattered out of order, pages past each
    row's length unmapped; on the CPU (its plain version) against the
    Pallas flash_decode_paged in interpret mode, f32."""
    B, H, KV, hd, cap = 8, 25, 5, 16, 64
    npg = cap // ps
    assert fd._splits(B, KV, cap, "simt_f32") == (4, 16)
    assert fd._splits(B, KV, cap, "tc") == (1, 64)
    lens = [0, 15, 16, 17, 33, 47, 63, cap]
    rng = np.random.default_rng(ps)
    perm = rng.permutation(B * npg).reshape(B, npg)
    tab = np.where(np.arange(npg)[None] * ps < np.asarray(lens)[:, None],
                   perm, -1).astype(np.int32)
    jq, tq = _decode_pair((B, H, hd), rng)
    jk, tk = _decode_pair((2, B * npg + 1, ps, KV, hd), rng)
    jv, tv = _decode_pair((2, B * npg + 1, ps, KV, hd), rng)
    want = j_paged(jq, jk, jv, jnp.asarray(tab), jnp.asarray(lens, jnp.int32),
                   layer=1, interpret=True)
    got = fd.flash_decode_paged(tq, tk, tv, torch.from_numpy(tab),
                                torch.tensor(lens, dtype=torch.int32), layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_tol("float32"))
    assert np.all(got[0].numpy() == 0.0)


# gemma3-1b's attention: 4 query heads over 1 kv head (G 4) of 256, window
# 512 on the local layers; the global layers decode over the pool
GEMMA = dict(H=4, KV=1, hd=256, window=512)


@pytest.mark.parametrize("dtype,want", [(BF16, "tc"), (F32, "simt_f32")])
def test_routes_at_gemma3_shapes(dtype, want):
    """Every gemma3 launch takes its dtype's route at hd 256: bf16 the
    tensor-core one, f32 the SIMT one — prefill attention (serve shape
    B 8 x S 128, generate-length rows), the contiguous decode cache and the
    serve pool."""
    H, KV, hd = GEMMA["H"], GEMMA["KV"], GEMMA["hd"]
    for B, S in ((8, 128), (4, 600)):
        q = torch.zeros(B, S, H, hd, dtype=dtype).transpose(1, 2)
        k = torch.zeros(B, S, KV, hd, dtype=dtype).transpose(1, 2)
        assert fa._route(q, k, k) == want
    q1 = torch.zeros(8, H, hd, dtype=dtype)
    cache = torch.zeros(2, 8, 160, KV, hd, dtype=dtype)[1].transpose(1, 2)
    pool = torch.zeros(4, 49, 16, KV, hd, dtype=dtype)
    assert fd._route(q1, cache, cache) == fd._route(q1, pool, pool) == want
    assert want in ROUTES["flash_attention_fwd"]


@pytest.mark.parametrize("window", [0, GEMMA["window"], 40])
def test_attention_hd256_matches_pallas(window):
    """The attention wrapper on the CPU (its plain version) at gemma3's
    heads, hd 256, against the Pallas flash_attention_fwd in interpret
    mode, f32: windows 0, gemma3's 512 (wider than the rows: no band) and
    40 (a band inside the rows)."""
    H, KV, hd = GEMMA["H"], GEMMA["KV"], GEMMA["hd"]
    rng = np.random.default_rng(window + 3)
    jq, tq = _decode_pair((1, H, 96, hd), rng)
    jk, tk = _decode_pair((1, KV, 96, hd), rng)
    jv, tv = _decode_pair((1, KV, 96, hd), rng)
    want = j_attn(jq, jk, jv, causal=True, window=window, block_q=32,
                  block_k=32, interpret=True)
    got = fa.flash_attention_fwd(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_tol("float32"))


def test_decode_hd256_matches_pallas():
    """Both decode wrappers on the CPU (their plain versions) at gemma3's
    global-layer heads (G 4, hd 256) against the Pallas flash_decode (window
    0 and 48) and flash_decode_paged (4-position pages out of order, pages
    past each length unmapped) in interpret mode, f32; a length-0 row is
    exact zeros."""
    H, KV, hd = GEMMA["H"], GEMMA["KV"], GEMMA["hd"]
    B, S, ps = 4, 72, 4
    lens = [0, 17, 64, S]
    rng = np.random.default_rng(11)
    jq, tq = _decode_pair((B, H, hd), rng)
    jk, tk = _decode_pair((B, KV, S, hd), rng)
    jv, tv = _decode_pair((B, KV, S, hd), rng)
    jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(lens,
                                                        dtype=torch.int32)
    for window in (0, 48):
        want = j_decode(jq, jk, jv, jl, window=window, block_k=16,
                        interpret=True)
        got = fd.flash_decode(tq, tk, tv, tl, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   **_tol("float32"))
    npg = S // ps
    perm = rng.permutation(B * npg).reshape(B, npg)
    tab = np.where(np.arange(npg)[None] * ps < np.asarray(lens)[:, None],
                   perm, -1).astype(np.int32)
    jkp, tkp = _decode_pair((2, B * npg + 1, ps, KV, hd), rng)
    jvp, tvp = _decode_pair((2, B * npg + 1, ps, KV, hd), rng)
    want = j_paged(jq, jkp, jvp, jnp.asarray(tab), jl, layer=1,
                   interpret=True)
    got = fd.flash_decode_paged(tq, tkp, tvp, torch.from_numpy(tab), tl,
                                layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_tol("float32"))
    assert np.all(got[0].numpy() == 0.0)


def test_routes_at_one_tp_shards_shapes():
    """The spmd serve path at qwen3-0.6b's (1, 4, 4) mesh (trap T-c): one
    tp shard holds 4 query and 2 KV heads of 128 and one microbatch is one
    row, and every launch still routes tc — the paged decode over one
    (stage, tp) slot's own pool (a contiguous pool per slot; the KV-head
    chunk of the global pool would be strided, which the kernel refuses,
    trap T-a), the contiguous decode over a row slice of one stage's group
    (`layer` is a stage-local index), and the prefill attention of a
    1-row microbatch."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import cache as cache_lib

    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"], num_layers=8)
    mesh = make_test_mesh(1, 4, 4, devices="cpu")
    store = cache_lib.CacheStore(
        cfg, cache_lib.make_layout(8, 144, page_size=16, max_pages=48),
        dtype=BF16, mesh=mesh)
    q1 = torch.zeros(1, 4, 128, dtype=BF16)
    for s in range(4):
        for t in range(4):
            view = cache_lib.slice_mb(store.tree[0][s][t], 5, 1)
            kp, vp = view["kv_full"]
            assert kp.shape == (2, 49, 16, 2, 128) and kp.is_contiguous()
            assert view["block_tab"].shape == (1, 9)
            assert fd._route(q1, kp, vp) == "tc"
    glob = cache_lib.init_paged(cfg, store.layout, dtype=BF16)["kv_full"][0]
    assert not glob[:2, :, :, :2].is_contiguous()
    shapes, specs = cache_lib.cache_struct(cfg, 8, 160, seq_shards=16,
                                           dtype=BF16)
    slots = cache_lib.shard_cache(cfg, cache_lib.init_cache(
        cfg, 8, 160, seq_shards=16, dtype=BF16), mesh, specs)
    kf, vf = cache_lib.slice_mb(slots[0][3][1], 7, 1)["kv_full"]
    for i in range(2):
        assert fd._route(q1, kf[i].transpose(1, 2),
                         vf[i].transpose(1, 2)) == "tc"
    q = torch.zeros(1, 128, 4, 128, dtype=BF16).transpose(1, 2)
    k = torch.zeros(1, 128, 2, 128, dtype=BF16).transpose(1, 2)
    assert fa._route(q, k, k) == "tc"
    # one row x 2 KV heads: short caches stay one block a row (a split
    # would cost its merge more than the tc route's 256-position span)
    assert fd._splits(1, 2, 144, "tc") == (1, 144)
    assert fd._splits(1, 2, 160, "tc") == (1, 160)
