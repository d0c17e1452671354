"""The Hopper kernels and the kernel path on the card (marker `cuda`).

These tests import neither jax nor repro, so they run on a machine with an
sm_90 card and no JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere they skip. Each kernel is held against its plain PyTorch version
on the same CUDA inputs (2e-5 in f32: the sums run in another order; 5e-2
in bf16: one rounding of the output; 5e-4 for the chunked WKV6 and 1e-4
for the chunked SSD against their sequential recurrences, the tolerances
of tests/test_kernels.py, on each route; for the grouped matmul 2e-5 relative to the
output's scale in f32, its sums over d running in another order), and the
serve_kernels preset on the card streams the same greedy tokens as its
plain path on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Engine, get_preset
from repro_torch.api.serving import Request, Scheduler
from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import mamba_ssd, moe_gmm, rwkv6_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.mamba_ssd import ssd_chunked
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked
from repro_torch.models import lm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA card: the kernels have no CPU build "
                    "(chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


def _ran(name):
    """The one route `name` launched through since reset_launches()."""
    ran = [r for r, n in ROUTES[name].items() if n]
    assert len(ran) == 1 and ROUTES[name][ran[0]] == LAUNCHES[name], \
        ROUTES[name]
    return ran[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV", [(16, 2, 2), (128, 16, 8), (64, 25, 5),
                                    (256, 4, 1)])
def test_kernels_match_plain_versions(card, dtype, hd, H, KV):
    g = torch.Generator(device=card).manual_seed(hd)

    def rnd(*s, d=dtype):
        return torch.randn(s, generator=g, device=card).to(d)

    q = rnd(2, 100, H, hd).transpose(1, 2)
    k = rnd(2, 100, KV, hd).transpose(1, 2)
    for window in (0, 40):
        reset_launches()
        torch.testing.assert_close(
            flash_attention_fwd(q, k, k, window=window).float(),
            tref.attention_ref(q, k, k, window=window).float(), **_tol(dtype))
        assert _ran("flash_attention_fwd") == (
            "tc" if dtype == torch.bfloat16 else "simt_f32")
    q1 = rnd(4, H, hd)
    cache = rnd(4, 77, KV, hd).transpose(1, 2)
    lens = torch.tensor([0, 1, 40, 77], dtype=torch.int32, device=card)
    route = "tc" if dtype == torch.bfloat16 else "simt_f32"
    for window in (0, 30):
        reset_launches()
        out = flash_decode(q1, cache, cache, lens, window=window)
        torch.testing.assert_close(
            out.float(), tref.decode_ref(q1, cache, cache, lens,
                                         window=window).float(),
            **_tol(dtype))
        assert torch.all(out[0] == 0)
        assert _ran("flash_decode") == route
    tab = torch.tensor([[-1] * 5, [3, -1, -1, -1, -1], [4, 7, 9, -1, -1],
                        [0, 1, 2, 5, 6]], dtype=torch.int32, device=card)
    for pool_dt in (dtype, torch.float8_e4m3fn):
        pool = rnd(2, 21, 16, KV, hd, d=pool_dt)
        reset_launches()
        out = flash_decode_paged(q1, pool, pool, tab, lens, layer=1)
        torch.testing.assert_close(
            out.float(), tref.decode_paged_ref(q1, pool, pool, tab, lens,
                                               layer=1).float(),
            **_tol(dtype))
        assert torch.all(out[0] == 0)
        assert _ran("flash_decode_paged") == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 5, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_decode_split_sweep(card, dtype, G, hd):
    """Both decode entries across the split edges against decode_ref /
    decode_paged_ref: 12 rows (2 kv heads, G query heads each) at lengths
    0, 1, 15, 16, 17, chunk - 1, chunk, chunk + 1 and the capacity (the
    contiguous cache of 700 is cut into chunks of 256 on the tensor-core
    route and of 64 on the SIMT ones, the pools of 384 into chunks of 256
    and 32); window 0 and 40 (mid-chunk for the long rows); pages of 4,
    16 and 32 scattered out of order, those past each row's length
    unmapped, pools of q's dtype and fp8. bf16 runs on its
    tensor-core route (at hd 256 chunks of 192: 6 walking warps a block),
    again forced onto simt_bf16, and with the cache at an odd element
    offset (simt_bf16, element loads); f32 on simt_f32. Each launch's
    route is asserted, and length-0 rows are exact zeros."""
    g = torch.Generator(device=card).manual_seed(hd * 10 + G)
    B, KV, S, cap = 12, 2, 700, 384
    H = KV * G

    def rnd(*s, d=dtype):
        return torch.randn(s, generator=g, device=card).to(d)

    bf = dtype == torch.bfloat16
    picked = "tc" if bf else "simt_f32"
    forced = (None, "simt_bf16") if bf else (None,)
    q1 = rnd(B, H, hd)

    def check(name, fn, want, zero_rows, route):
        reset_launches()
        out = fn(route)
        torch.cuda.synchronize()
        ran = _ran(name)
        assert out.dtype == dtype and out.shape == q1.shape
        torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))
        assert torch.all(out[zero_rows] == 0)
        return ran

    tc = fd._splits(B, KV, S, "tc", hd)
    assert tc == ((4, 192) if hd == 256 else (3, 256))
    assert fd._splits(B, KV, S, "simt_f32", hd) == (11, 64)
    assert fd._splits(B, KV, cap, "tc", hd) == (2, 192 if hd == 256 else 256)
    assert fd._splits(B, KV, cap, "simt_f32", hd) == (12, 32)
    c = tc[1]
    lens = torch.tensor([0, 1, 15, 16, 17, 63, 64, 65, c - 1, c, c + 1, S],
                        dtype=torch.int32, device=card)
    buf = rnd(1 + 2 * B * S * KV * hd)
    cache = buf[:-1].view(2, B, S, KV, hd)
    odd = buf[1:].view(2, B, S, KV, hd)
    for window in (0, 40):
        for kv in (cache, odd) if bf else (cache,):
            k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
            want = tref.decode_ref(q1, k, v, lens, window=window)
            for route in forced:
                ran = check("flash_decode", lambda r: flash_decode(
                    q1, k, v, lens, window=window, route=r), want, 0, route)
                assert ran == (route or (picked if kv is cache
                                         else "simt_bf16"))
    pc = fd._splits(B, KV, cap, "tc", hd)[1]
    plens = torch.tensor([0, 1, 15, 16, 17, 31, 32, 33, pc - 1, pc, pc + 1,
                          cap], dtype=torch.int32, device=card)
    for ps in (4, 16, 32):
        npg = cap // ps
        perm = torch.randperm(B * npg, generator=g, device=card)
        tab = perm.to(torch.int32).reshape(B, npg)
        live = torch.arange(npg, device=card)[None] * ps < plens[:, None]
        tab = torch.where(live, tab, -1).to(torch.int32)
        for pool_dt in (dtype, torch.float8_e4m3fn):
            kp = rnd(2, B * npg + 1, ps, KV, hd, d=pool_dt)
            vp = rnd(2, B * npg + 1, ps, KV, hd, d=pool_dt)
            want = tref.decode_paged_ref(q1, kp, vp, tab, plens, layer=1)
            for route in forced:
                ran = check("flash_decode_paged", lambda r: flash_decode_paged(
                    q1, kp, vp, tab, plens, layer=1, route=r), want, 0, route)
                assert ran == (route or picked) == (route or fd._route(
                    q1, kp, vp))
    with pytest.raises(ValueError, match="route"):
        flash_decode(q1, k, v, lens, route="tc" if not bf else "simt_f32")


@pytest.mark.parametrize("B,H,S,hd", [(2, 3, 100, 64), (3, 2, 17, 64),
                                      (1, 40, 1, 64), (2, 2, 48, 64)])
def test_rwkv6_chunked_matches_plain_version(card, B, H, S, hd):
    """The chunked WKV6 kernel against the sequential recurrence: y and the
    final state, a masked tail chunk (S not a multiple of 16), strided
    [B, S, H, hd] inputs as the model hands them over, and rows whose tail
    is lens padding (k = 0, w = 0: the state must not move)."""
    g = torch.Generator(device=card).manual_seed(S)

    def rnd(scale=0.5):
        x = torch.randn((B, S, H, hd), generator=g, device=card)
        return (scale * x).transpose(1, 2)
    r, k, v = rnd(), rnd(), rnd()
    w = -4.0 * torch.rand((B, S, H, hd), generator=g,
                          device=card).transpose(1, 2)
    u = 0.3 + 0.1 * torch.randn((H, hd), generator=g, device=card)
    live = (torch.arange(S, device=card)[None, :] <
            torch.tensor([S, max(1, S // 3)] * B, device=card)[:B, None])
    live = live[:, None, :, None]
    k = torch.where(live, k, 0.0)
    w = torch.where(live, w, 0.0)
    reset_launches()
    y, st = rwkv6_chunked(r, k, v, w, u)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_chunked"] == 1
    assert _ran("rwkv6_chunked") == "tile"
    y_ref, st_ref = tref.rwkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(st, st_ref, atol=5e-4, rtol=5e-4)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_chunked(*(t.to(torch.bfloat16) for t in (r, k, v, w)), u)


@pytest.mark.parametrize("B,H,S", [(2, 3, 64), (3, 2, 100), (2, 4, 17),
                                   (1, 50, 1)])
def test_ssd_chunked_matches_plain_version(card, B, H, S):
    """The chunked SSD kernel against the sequential recurrence at P 64,
    N 16 (hymba's heads): y and the final state, a masked tail chunk (S not
    a multiple of 64), x and B/C as column slices of one conv output and dt
    as a transposed [B, S, H] view (as the model hands them over), per-step
    decays spread over (0, 1), and rows whose tail is lens padding (dt = 0:
    the state must not move)."""
    P, N = 64, 16
    g = torch.Generator(device=card).manual_seed(S)
    conv = 0.5 * torch.randn((B, S, H * P + 2 * N), generator=g, device=card)
    x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    a = -torch.linspace(1.0, 16.0, H, device=card)
    logdt = torch.empty((B, S, H), device=card).uniform_(-7.0, -1.2,
                                                         generator=g)
    dt = torch.exp(logdt).transpose(1, 2)
    live = (torch.arange(S, device=card)[None, :] <
            torch.tensor([S, max(1, S // 3)] * B, device=card)[:B, None])
    dt = torch.where(live[:, None, :], dt, 0.0)
    reset_launches()
    y, st = ssd_chunked(x, dt, Bm, Cm, a)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunked"] == 1
    assert _ran("ssd_chunked") == "tile"
    y_ref, st_ref = tref.ssd_ref(x, dt, Bm, Cm, a)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, st_ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunked(x.to(torch.bfloat16), dt, Bm, Cm, a)
    with pytest.raises(ValueError, match="not in"):
        ssd_chunked(x[..., :32], dt, Bm, Cm, a)


def test_kernels_at_granite4h_cell_shapes(card):
    """chip_smoke.py's granite4h-serve-chat cases, each launch on the route
    it names (or the wrapper's pick) against its plain version:
    ssd_chunked at (P, N) = (64, 128) on tile (the pick) and simt over
    lens-padded [64, 128, 512, 64] groups, the cell's own lengths (215 and
    63 x 1) among them, a 100-token tail and one token (1e-4 against the
    sequential recurrence), the 36 held
    experts' GEMMs at a decode step's and a prefill group's capacity, and
    both attention kernels at 32 / 8 heads of 128 (bf16: 5e-2)."""
    import chip_smoke
    gen = torch.Generator(device=card).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    seen = set()
    for name, label, dtype, route, got, want in chip_smoke.granite4h_cases(
            card, randn, gen):
        ref = want()
        reset_launches()
        out = got()
        torch.cuda.synchronize()
        assert LAUNCHES[name] == 1, (name, label)
        ran = _ran(name)
        assert route in (None, ran), (name, label, ran)
        if name == "ssd_chunked":
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, atol=chip_smoke.SSD_TOL,
                                           rtol=chip_smoke.SSD_TOL)
        else:
            torch.testing.assert_close(out.float(), ref.float(),
                                       **_tol(dtype))
        seen.add((name, ran))
        del out, ref
    assert {n for n, _ in seen} == {"ssd_chunked", "grouped_matmul",
                                    "flash_attention_fwd",
                                    "flash_decode_paged"}, seen
    assert {("ssd_chunked", "tile"), ("ssd_chunked", "simt")} <= seen, seen


def _row_lens(S, B, device):
    """Each row's length: the first full, the rest cut (their tails are
    lens padding)."""
    return torch.tensor([S] + [max(1, S // (2 + i)) for i in range(B - 1)],
                        device=device)


def _check_routes(name, fn, want, tol, short_state, shorts):
    """fn(route) for the wrapper's pick ("tile") and the forced "simt"
    route against `want` (y, state) within atol = rtol = tol, each
    launched once on the route expected, and each padded row's state equal
    to the state of its unpadded prefix (`shorts`: row -> that prefix's
    inputs, run by short_state(inputs, route))."""
    for route in (None, "simt"):
        reset_launches()
        y, st = fn(route)
        torch.cuda.synchronize()
        assert _ran(name) == (route or "tile")
        assert LAUNCHES[name] == 1 and sum(ROUTES[name].values()) == 1
        torch.testing.assert_close(y, want[0], atol=tol, rtol=tol)
        torch.testing.assert_close(st, want[1], atol=tol, rtol=tol)
        for row, st_short in shorts.items():
            torch.testing.assert_close(st[row], short_state(st_short, route),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [1, 17, 100, 128])
def test_rwkv6_routes_at_model_shapes(card, S):
    """rwkv6_chunked at rwkv6-3b's heads (40 of 64), r/k/v/w laid out
    [B, S, H, hd] and handed over as [B, H, S, hd] views (the tile route and
    the forced simt route) against the
    sequential recurrence within 5e-4: a masked tail chunk at S 1 / 17 /
    100, rows whose tail is lens padding (k = w = 0) ending at the state of
    their unpadded prefix; the same inputs at an odd element offset take
    the simt route, and forcing "tile" on them raises."""
    B, H, hd = 3, 40, 64
    g = torch.Generator(device=card).manual_seed(S)

    def rnd(scale=0.5):
        return scale * torch.randn((B, S, H, hd), generator=g, device=card)
    r, k, v = rnd(), rnd(), rnd()
    w = -4.0 * torch.rand((B, S, H, hd), generator=g, device=card)
    u = 0.3 + 0.1 * torch.randn((H, hd), generator=g, device=card)
    lens = _row_lens(S, B, card)
    live = (torch.arange(S, device=card)[None, :] < lens[:, None])[..., None,
                                                                     None]
    k, w = torch.where(live, k, 0.0), torch.where(live, w, 0.0)
    views = [t.transpose(1, 2) for t in (r, k, v, w)]
    want = tref.rwkv6_ref(*views, u)
    assert rwkv6_scan._route(*views) == "tile"

    shorts = {b: [t[b:b + 1, :int(lens[b])].transpose(1, 2)
                  for t in (r, k, v, w)] for b in range(1, B)}
    _check_routes("rwkv6_chunked",
                  lambda route: rwkv6_chunked(*views, u, route=route), want,
                  5e-4,
                  lambda sh, route: rwkv6_chunked(*sh, u, route=route)[1][0],
                  shorts)
    buf = torch.empty(4, 1 + B * S * H * hd, device=card)
    odd = []
    for i, t in enumerate((r, k, v, w)):
        o = buf[i, 1:].view(B, S, H, hd)
        o.copy_(t)
        odd.append(o.transpose(1, 2))
    assert rwkv6_scan._route(*odd) == "simt"
    reset_launches()
    y, st = rwkv6_chunked(*odd, u)
    torch.cuda.synchronize()
    assert _ran("rwkv6_chunked") == "simt"
    torch.testing.assert_close(y, want[0], atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(st, want[1], atol=5e-4, rtol=5e-4)
    with pytest.raises(ValueError, match="route"):
        rwkv6_chunked(*odd, u, route="tile")


@pytest.mark.parametrize("S", [1, 17, 100, 128, 1100])
def test_ssd_routes_at_model_shapes(card, S):
    """ssd_chunked at hymba's heads (50 of P 64, state 16), x and B/C column
    slices of one [B, S, 50 * 64 + 32] conv output and dt a transposed
    [B, S, H] view, as the model hands them over (the tile route and the
    forced simt route) against the sequential recurrence within 1e-4:
    per-step decays spread over (0, 1), a masked tail chunk at S 1 / 17 /
    100 / 1100 (hymba's generate prompt: 17 chunks and a tail of 12), rows
    whose tail is lens padding (dt = 0) ending at the state of their
    unpadded prefix; x at an odd element offset takes the simt route, and
    forcing "tile" on it raises."""
    B, H, P, N = 2 if S > 200 else 3, 50, 64, 16
    g = torch.Generator(device=card).manual_seed(S)
    conv = 0.5 * torch.randn((B, S, H * P + 2 * N), generator=g, device=card)
    x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    a = -torch.linspace(1.0, 16.0, H, device=card)
    dt = torch.empty((B, S, H), device=card).uniform_(-7.0, -1.2,
                                                      generator=g).exp_()
    lens = _row_lens(S, B, card)
    dt = torch.where(torch.arange(S, device=card)[None, :, None] <
                     lens[:, None, None], dt, 0.0).transpose(1, 2)
    want = tref.ssd_ref(x, dt, Bm, Cm, a)
    assert mamba_ssd._route(x, Bm, Cm) == "tile"

    shorts = {b: (x[b:b + 1, :, :int(lens[b])], dt[b:b + 1, :, :int(lens[b])],
                  Bm[b:b + 1, :int(lens[b])], Cm[b:b + 1, :int(lens[b])])
              for b in range(1, B)}
    _check_routes("ssd_chunked",
                  lambda route: ssd_chunked(x, dt, Bm, Cm, a, route=route),
                  want, 1e-4,
                  lambda sh, route: ssd_chunked(*sh, a, route=route)[1][0],
                  shorts)
    buf = torch.empty(1 + x.numel(), device=card)
    x_odd = buf[1:].view(B, S, H, P)
    x_odd.copy_(x.transpose(1, 2))
    x_odd = x_odd.transpose(1, 2)
    assert mamba_ssd._route(x_odd, Bm, Cm) == "simt"
    reset_launches()
    y, st = ssd_chunked(x_odd, dt, Bm, Cm, a)
    torch.cuda.synchronize()
    assert _ran("ssd_chunked") == "simt"
    torch.testing.assert_close(y, want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want[1], atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="route"):
        ssd_chunked(x_odd, dt, Bm, Cm, a, route="tile")


@pytest.mark.parametrize("S", [1, 13, 63, 64, 65, 100, 512])
def test_ssd_routes_at_state_128(card, S):
    """ssd_chunked at granite-4.0-h's state 128 (heads of P 64; H 5, so the
    last pair of the tile route's 2-head blocks holds one live head), x and
    B/C column slices of one [B, S, 5 * 64 + 256] conv output and dt a
    transposed [B, S, H] view, as the model hands them over: the tile route
    (the pick) and the forced simt route against the sequential recurrence
    within 1e-4, S across the chunk edges (1, 13, 63, 64, 65, 100, 512),
    rows lens-padded (dt = 0 past their length) to a prefix of 1, to
    another chunk edge and to nothing (a row of length 0 ends at the zero
    state); each padded row ends at the state of its unpadded prefix. x at
    an odd element offset takes simt, and forcing "tile" on it raises."""
    B, H, P, N = 4, 5, 64, 128
    g = torch.Generator(device=card).manual_seed(1000 + S)
    conv = 0.5 * torch.randn((B, S, H * P + 2 * N), generator=g, device=card)
    x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    a = -torch.linspace(1.0, 16.0, H, device=card)
    dt = torch.empty((B, S, H), device=card).uniform_(-7.0, -1.2,
                                                      generator=g).exp_()
    lens = [S, 1, (S - 1) // 64 * 64, 0]
    dt = torch.where(torch.arange(S, device=card)[None, :, None] <
                     torch.tensor(lens, device=card)[:, None, None], dt,
                     0.0).transpose(1, 2)
    want = tref.ssd_ref(x, dt, Bm, Cm, a)
    assert mamba_ssd._route(x, Bm, Cm) == "tile"
    assert torch.all(want[1][3] == 0)

    shorts = {b: (x[b:b + 1, :, :n], dt[b:b + 1, :, :n], Bm[b:b + 1, :n],
                  Cm[b:b + 1, :n]) for b, n in enumerate(lens) if 0 < n < S}
    _check_routes("ssd_chunked",
                  lambda route: ssd_chunked(x, dt, Bm, Cm, a, route=route),
                  want, 1e-4,
                  lambda sh, route: ssd_chunked(*sh, a, route=route)[1][0],
                  shorts)
    buf = torch.empty(1 + x.numel(), device=card)
    x_odd = buf[1:].view(B, S, H, P)
    x_odd.copy_(x.transpose(1, 2))
    x_odd = x_odd.transpose(1, 2)
    assert mamba_ssd._route(x_odd, Bm, Cm) == "simt"
    reset_launches()
    y, st = ssd_chunked(x_odd, dt, Bm, Cm, a)
    torch.cuda.synchronize()
    assert _ran("ssd_chunked") == "simt" and LAUNCHES["ssd_chunked"] == 1
    torch.testing.assert_close(y, want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want[1], atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="route"):
        ssd_chunked(x_odd, dt, Bm, Cm, a, route="tile")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,G,ff", [(32, 8, 1024, 2, 512),
                                        (32, 8, 512, 1, 1024),
                                        (32, 320, 1024, 2, 512),
                                        (32, 320, 512, 1, 1024),
                                        (3, 13, 72, 1, 40), (2, 1, 5, 1, 3),
                                        (3, 1, 72, 1, 40), (3, 8, 72, 1, 40),
                                        (3, 16, 72, 1, 40),
                                        (3, 17, 72, 1, 40),
                                        (3, 100, 72, 1, 40),
                                        (3, 320, 72, 1, 40),
                                        (3, 321, 72, 1, 40)])
def test_grouped_matmul_matches_plain_version(card, dtype, E, C, d, G, ff):
    """The grouped matmul against gmm_ref at granite-moe-1b's decode (C 8)
    and prefill (C 320) shapes of w_in (the [E, d, G ff] view of [E, d, G,
    ff]) and w_out, a ragged C 13 / d 72 / f 40, C across the decode /
    prefill seam (16 / 17) and past the 128-row prefill tiles (100, 320,
    321), and a tiny one; x a strided view (last dim contiguous), as the
    model may hand it over. bf16 takes a tensor-core route (decode at C <=
    16) except at d 5 / f 3; f32 the f32 one."""
    g = torch.Generator(device=card).manual_seed(C + d + ff)
    x = torch.randn((C, E, d), generator=g, device=card).to(dtype)
    x = x.transpose(0, 1)
    w = (torch.randn((E, d, G, ff), generator=g, device=card) *
         d ** -0.5).to(dtype).reshape(E, d, G * ff)
    reset_launches()
    out = grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_matmul"] == 1
    if dtype == torch.float32:
        want_route = "simt_f32"
    elif d % 8 or ff % 8:
        want_route = "simt_bf16"
    else:
        want_route = "tc_decode" if C <= 16 else "tc_prefill"
    assert _ran("grouped_matmul") == want_route == moe_gmm._route(x, w)
    assert out.dtype == dtype and out.shape == (E, C, G * ff)
    want = tref.gmm_ref(x, w)
    if dtype == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(out, want, atol=2e-5 * scale, rtol=2e-5)
    else:
        torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))
    with pytest.raises(ValueError, match="share"):
        grouped_matmul(x, w.float() if dtype != torch.float32 else w.double())


@pytest.mark.parametrize("C", [8, 13, 320])
def test_grouped_matmul_simt_bf16_route(card, C):
    """bf16 operands the tensor-core routes cannot take (x at an odd element
    offset; w's rows off the 16-byte grid) take the SIMT route, counted as
    such, and so does a forced route="simt_bf16"; both match gmm_ref, and
    forcing a tensor-core route on them raises."""
    g = torch.Generator(device=card).manual_seed(C)
    E, d, f = 4, 72, 40
    buf = torch.randn(1 + E * C * d, generator=g, device=card)
    x = buf.to(torch.bfloat16)[1:].view(E, C, d)
    w = (torch.randn((E, d, f + 4), generator=g, device=card) *
         d ** -0.5).to(torch.bfloat16)
    x_ok = x.clone()
    for xx, ww, route in ((x, w[..., :f], None), (x_ok, w[..., :f], None),
                          (x_ok, w[..., :f].contiguous(), "simt_bf16")):
        reset_launches()
        out = grouped_matmul(xx, ww, route=route)
        torch.cuda.synchronize()
        assert _ran("grouped_matmul") == "simt_bf16"
        torch.testing.assert_close(out.float(), tref.gmm_ref(xx, ww).float(),
                                   **_tol(torch.bfloat16))
    with pytest.raises(ValueError, match="route"):
        grouped_matmul(x, w[..., :f], route="tc_prefill")


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 100, 1100])
def test_flash_attention_tc_route_sweep(card, hd, S):
    """flash_attention_fwd in bf16 on its tensor-core route at lengths
    around the 64-row tiles and hymba's 1100, GQA 4/2, window 0 and 40,
    inputs laid out [B, S, heads, hd] as the model hands them over; the
    same inputs through route="simt_bf16", and unaligned rows (an odd
    element offset of q) through the SIMT route, all against the plain
    version."""
    g = torch.Generator(device=card).manual_seed(S + hd)
    B = 1 if S > 200 else 2

    def rnd(n):
        return torch.randn((B, S, n, hd), generator=g,
                           device=card).to(torch.bfloat16).transpose(1, 2)
    q, k, v = rnd(4), rnd(2), rnd(2)
    buf = torch.zeros(1 + q.numel(), dtype=torch.bfloat16, device=card)
    q_odd = buf[1:].view(B, S, 4, hd).transpose(1, 2)
    q_odd.copy_(q)
    for window in (0, 40):
        want = tref.attention_ref(q, k, v, window=window).float()
        for qq, route, ran in ((q, None, "tc"), (q, "simt_bf16", "simt_bf16"),
                               (q_odd, None, "simt_bf16")):
            reset_launches()
            out = flash_attention_fwd(qq, k, v, window=window, route=route)
            torch.cuda.synchronize()
            assert _ran("flash_attention_fwd") == ran == (
                route or fa._route(qq, k, v))
            torch.testing.assert_close(out.float(), want,
                                       **_tol(torch.bfloat16))
    with pytest.raises(ValueError, match="route"):
        flash_attention_fwd(q_odd, k, v, route="tc")


def test_serve_kernels_on_card_match_cpu(card):
    """The serve_kernels preset (f32) through the Hopper kernels on the
    card and through the plain versions on the CPU: one greedy stream per
    request, with every prefill and decode step launching its kernel."""
    plan = get_preset("serve_kernels")
    params = lm.init_params(plan.arch, torch.Generator().manual_seed(0))
    for name in ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wo"):
        params["blocks"][name].mul_(20.0)     # layers, not the embedding
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 256, int(rng.integers(2, 9)),
                             dtype=np.int32), int(rng.integers(1, 9)))
            for i in range(8)]

    def run(device):
        p = {k: ({n: t.to(device) for n, t in v.items()}
                 if k == "blocks" else v.to(device))
             for k, v in params.items()}
        return Scheduler(Engine(plan, params=p, device=device)).run(
            [Request(i, pr.copy(), n) for i, pr, n in reqs])

    reset_launches()
    on_card = run(card)
    assert LAUNCHES["flash_attention_fwd"] == 2 * on_card.prefill_calls
    assert LAUNCHES["flash_decode_paged"] == 2 * on_card.decode_steps > 0
    on_cpu = run("cpu")
    assert [r.tokens for r in on_card.requests] == \
        [r.tokens for r in on_cpu.requests]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemma3_hd256_kernels_match_plain_versions(card, dtype):
    """gemma3-1b's shapes, hd 256: prefill attention at 4/1 heads of 256
    over rows of 128 and 600 with window 0 and 512, and both decode kernels
    at its global layers' shapes (G 4, a [8, 160] cache, pools of
    16-position pages in the dtype and in fp8) — each against its plain
    version on the route `_route` gives (tc in bf16, simt_f32) and, in
    bf16, again forced onto simt_bf16."""
    g = torch.Generator(device=card).manual_seed(256)
    bf = dtype == torch.bfloat16
    want_route = "tc" if bf else "simt_f32"
    forced = (None, "simt_bf16") if bf else (None,)

    def rnd(*s, d=dtype):
        return torch.randn(s, generator=g, device=card).to(d)

    def check(name, fn, want, route, zero_row=None):
        reset_launches()
        out = fn(route)
        torch.cuda.synchronize()
        assert _ran(name) == (route or want_route)
        torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))
        if zero_row is not None:
            assert torch.all(out[zero_row] == 0)
    for B, S in ((8, 128), (2, 600)):
        q = rnd(B, S, 4, 256).transpose(1, 2)
        k = rnd(B, S, 1, 256).transpose(1, 2)
        v = rnd(B, S, 1, 256).transpose(1, 2)
        assert fa._route(q, k, v) == want_route
        for window in (0, 512):
            want = tref.attention_ref(q, k, v, window=window)
            for route in forced:
                check("flash_attention_fwd", lambda r: flash_attention_fwd(
                    q, k, v, window=window, route=r), want, route)
    B, S = 8, 160
    q1 = rnd(B, 4, 256)
    cache = rnd(2, B, S, 1, 256)
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    lens = torch.tensor([0, 1, 15, 16, 17, 77, 140, 160], dtype=torch.int32,
                        device=card)
    assert fd._route(q1, kc, vc) == want_route
    want = tref.decode_ref(q1, kc, vc, lens)
    for route in forced:
        check("flash_decode", lambda r: flash_decode(q1, kc, vc, lens,
                                                     route=r), want, route, 0)
    ps, npg = 16, 10
    tab = torch.randperm(B * npg, generator=g, device=card).to(
        torch.int32).reshape(B, npg)
    live = torch.arange(npg, device=card)[None] * ps < lens[:, None]
    tab = torch.where(live, tab, -1).to(torch.int32)
    for pool_dt in (dtype, torch.float8_e4m3fn):
        kp = rnd(4, B * npg + 1, ps, 1, 256, d=pool_dt)
        vp = rnd(4, B * npg + 1, ps, 1, 256, d=pool_dt)
        assert fd._route(q1, kp, vp) == want_route
        want = tref.decode_paged_ref(q1, kp, vp, tab, lens, layer=3)
        for route in forced:
            check("flash_decode_paged", lambda r: flash_decode_paged(
                q1, kp, vp, tab, lens, layer=3, route=r), want, route, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_one_tp_shards_shapes(card, dtype):
    """The attention kernels at the shapes one tp shard of qwen3-0.6b's
    (1, 4, 4) serve mesh hands them: 4 query / 2 KV heads of 128 and a
    1-row microbatch (and gemma3-1b's shard at the end: 1 query head over
    1 kv head of 256) — the paged decode over one (stage, tp) slot's own
    pool (2 stage-local layer groups, 48 pages of 16 + the trash page),
    the contiguous decode over a row slice of one stage's group, and the
    prefill attention; each against its plain version, on the route
    `_route` gives. A KV-head chunk of a global pool is strided: the paged
    kernel refuses it (trap T-a)."""
    g = torch.Generator(device=card).manual_seed(25)

    def rnd(*s):
        return torch.randn(s, generator=g, device=card).to(dtype)

    tc = "tc" if dtype == torch.bfloat16 else "simt_f32"
    q1 = rnd(1, 4, 128)
    kp, vp = rnd(2, 49, 16, 2, 128), rnd(2, 49, 16, 2, 128)
    tab = torch.tensor([[3, 17, 40, 8, 22, -1, -1, -1, -1]],
                       dtype=torch.int32, device=card)
    for layer, n in ((0, 1), (1, 77), (1, 80)):
        lens = torch.tensor([n], dtype=torch.int32, device=card)
        reset_launches()
        out = flash_decode_paged(q1, kp, vp, tab, lens, layer=layer)
        torch.cuda.synchronize()
        assert _ran("flash_decode_paged") == tc
        torch.testing.assert_close(out.float(), tref.decode_paged_ref(
            q1, kp, vp, tab, lens, layer=layer).float(), **_tol(dtype))
    group = rnd(2, 8, 160, 2, 128)                 # one stage's kv_full
    kc = group[1, 5:6].transpose(1, 2)             # microbatch 5's row
    lens = torch.tensor([133], dtype=torch.int32, device=card)
    reset_launches()
    out = flash_decode(q1, kc, kc, lens)
    torch.cuda.synchronize()
    assert _ran("flash_decode") == tc
    torch.testing.assert_close(out.float(), tref.decode_ref(
        q1, kc, kc, lens).float(), **_tol(dtype))
    q = rnd(1, 128, 4, 128).transpose(1, 2)
    k = rnd(1, 128, 2, 128).transpose(1, 2)
    reset_launches()
    out = flash_attention_fwd(q, k, k)
    torch.cuda.synchronize()
    assert _ran("flash_attention_fwd") == tc
    torch.testing.assert_close(out.float(), tref.attention_ref(
        q, k, k).float(), **_tol(dtype))
    whole = rnd(8, 49, 16, 8, 128)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode_paged(q1, whole[:2, :, :, :2], whole[:2, :, :, :2],
                           tab, lens, layer=0)
    # gemma3-1b's shard: 1 query head over 1 kv head of 256 (G 1)
    q1 = rnd(1, 1, 256)
    kp, vp = rnd(2, 49, 16, 1, 256), rnd(2, 49, 16, 1, 256)
    for n in (1, 77, 80):
        lens = torch.tensor([n], dtype=torch.int32, device=card)
        reset_launches()
        out = flash_decode_paged(q1, kp, vp, tab, lens, layer=1)
        torch.cuda.synchronize()
        assert _ran("flash_decode_paged") == tc
        torch.testing.assert_close(out.float(), tref.decode_paged_ref(
            q1, kp, vp, tab, lens, layer=1).float(), **_tol(dtype))
    kc = rnd(2, 8, 160, 1, 256)[1, 5:6].transpose(1, 2)
    lens = torch.tensor([133], dtype=torch.int32, device=card)
    reset_launches()
    out = flash_decode(q1, kc, kc, lens)
    torch.cuda.synchronize()
    assert _ran("flash_decode") == tc
    torch.testing.assert_close(out.float(), tref.decode_ref(
        q1, kc, kc, lens).float(), **_tol(dtype))
    q = rnd(1, 128, 1, 256).transpose(1, 2)
    k = rnd(1, 128, 1, 256).transpose(1, 2)
    reset_launches()
    out = flash_attention_fwd(q, k, k, window=512)
    torch.cuda.synchronize()
    assert _ran("flash_attention_fwd") == tc
    torch.testing.assert_close(out.float(), tref.attention_ref(
        q, k, k, window=512).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 8, 40])
def test_grouped_matmul_at_a_tp_shard(card, dtype, C):
    """granite-moe-1b-a400m's w_in over tp 2 (its ff split: f = G ff / tp
    = 512) and w_out's shard ([E, ff / tp, d]) as the model reshapes them,
    at a decode microbatch's and a prefill microbatch's capacities."""
    g = torch.Generator(device=card).manual_seed(C)
    E, d, G, ff = 32, 1024, 2, 512
    w_in = torch.randn((E, d, G, ff), generator=g, device=card) * d ** -0.5
    w_out = torch.randn((E, ff, d), generator=g, device=card) * ff ** -0.5
    for x_dim, w in ((d, w_in.chunk(2, dim=3)[1].to(dtype).reshape(
            E, d, G * ff // 2)), (ff // 2, w_out.chunk(2, dim=1)[0].to(
                dtype))):
        x = torch.randn((E, C, x_dim), generator=g, device=card).to(dtype)
        reset_launches()
        out = grouped_matmul(x, w)
        torch.cuda.synchronize()
        want_route = "simt_f32" if dtype == torch.float32 else (
            "tc_decode" if C <= 16 else "tc_prefill")
        assert _ran("grouped_matmul") == want_route == moe_gmm._route(x, w)
        want = tref.gmm_ref(x, w)
        if dtype == torch.float32:
            scale = float(want.abs().max())
            torch.testing.assert_close(out, want, atol=2e-5 * scale,
                                       rtol=2e-5)
        else:
            torch.testing.assert_close(out.float(), want.float(),
                                       **_tol(dtype))
