"""The tile routes' decompositions of the chunked WKV6 and SSD kernels,
written out in torch, against the Pallas kernels in interpret mode, on the
CPU.

The Hopper kernels' tile routes (csrc/rwkv6_scan.cu:wkv6_tile_kernel,
csrc/mamba_ssd.cu:ssd_tile_kernel) compute the recurrence differently from
the Pallas kernels: fixed chunks (16 / 64) with a zero-padded tail where
Pallas shrinks the chunk to a divisor of S (1 for a prime S), each block a
slice of the state's columns on its own, y as one product [r' | A] [S ; v]
(WKV6) or [M | exp(cs) C] [x ; h] (SSD), and for SSD C B^T once per (row,
chunk) for a group of heads. The functions below follow those steps in
torch (f32, cs in f64 for SSD, as the kernels hold them), so their algebra is
checked here at odd S (1, 13, 17, 100) against the Pallas kernels the
kernels replace, within the tolerances of tests/test_kernels.py (5e-4 for
WKV6, 1e-4 for SSD); the card tests hold the kernels to the same plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba_ssd import ssd_chunked as j_ssd_chunked
from repro.kernels.rwkv6_scan import rwkv6_chunked as j_rwkv6_chunked

WKV_TOL = dict(atol=5e-4, rtol=5e-4)
SSD_TOL = dict(atol=1e-4, rtol=1e-4)


def wkv6_tiles(r, k, v, w, u, width=32, C=16):
    """The tile route of rwkv6_chunked: chunks of C with the tail padded
    with zeros (k = w = 0: the state does not move), r' = r e^{cs_{t-1}},
    k' = k e^{-cs_t}, the scores A (strictly below the diagonal, the u-bonus
    on it), then per slice of `width` state columns y = [r' | A] [S ; v] and
    S <- e^{cs_last} (S + k'^T v)."""
    B, H, S, hd = r.shape
    n = -(-S // C)
    r, k, v, w = (F.pad(t, (0, 0, 0, n * C - S)) for t in (r, k, v, w))
    y = torch.zeros(B, H, n * C, hd)
    state = torch.zeros(B, H, hd, hd)
    below = torch.tril(torch.ones(C, C, dtype=torch.bool), -1)
    for c in range(n):
        rows = slice(c * C, (c + 1) * C)
        rc, kc, vc, wc = (t[:, :, rows] for t in (r, k, v, w))
        cs = torch.cumsum(wc, 2)
        rp, kp = rc * torch.exp(cs - wc), kc * torch.exp(-cs)
        A = torch.where(below, rp @ kp.transpose(-1, -2), 0.0) + \
            torch.diag_embed((rc * u[None, :, None] * kc).sum(-1))
        dec = torch.exp(cs[:, :, -1])[..., None]
        for j0 in range(0, hd, width):
            cols = slice(j0, j0 + width)
            St, vs = state[..., cols], vc[..., cols]
            y[:, :, rows, cols] = torch.cat([rp, A], -1) @ torch.cat([St, vs],
                                                                     -2)
            state[..., cols] = dec * (St + kp.transpose(-1, -2) @ vs)
    return y[:, :, :S], state


def ssd_tiles(x, dt, Bm, Cm, a, width=32, heads=2, C=64):
    """The tile route of ssd_chunked: chunks of C with the tail padded with
    zeros (dt = 0: the state does not move), C B^T once per (row, chunk)
    for each group of `heads` heads (the last group short where `heads`
    does not divide H), per head cs in f64, M = C B^T
    exp(cs_t - cs_s) dt_s on and below the diagonal, then per slice of
    `width` state columns y = [M | exp(cs) C] [x ; h] and h <- exp(cs_last)
    h + B^T (exp(cs_last - cs) dt x)."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    n = -(-S // C)
    pad = n * C - S
    x = F.pad(x, (0, 0, 0, pad))
    dt = F.pad(dt, (0, pad))
    Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
    y = torch.zeros(B, H, n * C, P)
    h = torch.zeros(B, H, N, P)
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool))
    for c in range(n):
        rows = slice(c * C, (c + 1) * C)
        Bc, Cc = Bm[:, rows], Cm[:, rows]
        for g0 in range(0, H, heads):
            CB = Cc @ Bc.transpose(-1, -2)            # shared by the group
            for hh in range(g0, min(g0 + heads, H)):
                d = dt[:, hh, rows]
                cs = torch.cumsum(d.double() * float(a[hh]), -1)
                diff = (cs[:, :, None] - cs[:, None, :]).float()
                M = torch.where(causal, CB * (torch.exp(diff) * d[:, None, :]),
                                0.0)
                Cp = torch.exp(cs.float())[..., None] * Cc
                wts = torch.exp((cs[:, -1:] - cs).float()) * d
                dec = torch.exp(cs[:, -1].float())[:, None, None]
                for p0 in range(0, P, width):
                    cols = slice(p0, p0 + width)
                    xs, hs = x[:, hh, rows, cols], h[:, hh, :, cols]
                    y[:, hh, rows, cols] = torch.cat([M, Cp], -1) @ \
                        torch.cat([xs, hs], -2)
                    h[:, hh, :, cols] = dec * hs + Bc.transpose(-1, -2) @ (
                        wts[..., None] * xs)
    return y[:, :, :S], h


def _wkv_inputs(B, H, S, hd, seed):
    """r, k, v (0.5 N(0,1)), w = -exp(clip(N(0,1), -8, 1.386)) in [-4, 0)
    and u = 0.3 + 0.1 N(0,1), numpy f32 (tests/test_kernels.py's mix); rows
    past each row's length as lens padding leaves them (k = w = 0)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, H, S, hd)) for _ in range(3))
    w = -np.exp(np.clip(rng.standard_normal((B, H, S, hd)), -8.0, 1.386))
    u = 0.3 + 0.1 * rng.standard_normal((H, hd))
    live = (np.arange(S)[None, :] < np.array([S, max(1, S // 3)])[:B, None])
    k, w = (np.where(live[:, None, :, None], t, 0.0) for t in (k, w))
    return [np.asarray(t, np.float32) for t in (r, k, v, w, u)]


def _ssd_inputs(B, H, S, N, P, seed):
    """x, B, C (0.5 N(0,1)), dt = softplus(N(0,1)), a = -exp(linspace(0, 2,
    H)), numpy f32 (tests/test_kernels.py's mix); rows past each row's
    length as lens padding leaves them (dt = 0)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, H, S, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S))))
    Bm, Cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    a = -np.exp(np.linspace(0.0, 2.0, H))
    live = (np.arange(S)[None, :] < np.array([S, max(1, S // 3)])[:B, None])
    dt = np.where(live[:, None, :], dt, 0.0)
    return [np.asarray(t, np.float32) for t in (x, dt, Bm, Cm, a)]


@pytest.mark.parametrize("S", [1, 13, 17, 100])
def test_wkv6_tile_decomposition_matches_pallas(S):
    """WKV6's tile route, per slice of 32 state columns, a masked tail
    chunk at S 13 / 17 / 100 (Pallas: chunks of 13, 1 and 10), against the
    Pallas rwkv6_chunked in interpret mode: y and the final state; the
    second row's tail is lens padding, so its state is the one after its
    S // 3 real rows."""
    B, H, hd = 2, 2, 64
    arrs = _wkv_inputs(B, H, S, hd, seed=S)
    y_j, st_j = j_rwkv6_chunked(*map(jnp.asarray, arrs), chunk=16,
                                interpret=True)
    y_t, st_t = wkv6_tiles(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **WKV_TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **WKV_TOL)
    L = max(1, S // 3)
    short = [t[1:2, :, :L] for t in arrs[:4]] + [arrs[4]]
    _, st_short = wkv6_tiles(*map(torch.from_numpy, short))
    np.testing.assert_allclose(st_t[1:2].numpy(), st_short.numpy(), **WKV_TOL)


@pytest.mark.parametrize("S", [1, 13, 17, 100])
def test_ssd_tile_decomposition_matches_pallas(S):
    """SSD's tile route at P 64, N 16 (hymba's heads), per slice of 32
    state columns with C B^T shared by pairs of heads (H 3: the last pair
    is one head, as for an odd H on the card), a masked tail chunk
    at S 13 / 17 / 100 (Pallas: chunks of 13, 17 and 50), against the
    Pallas ssd_chunked in interpret mode: y and the final state; the second
    row's tail is lens padding, so its state is the one after its S // 3
    real rows."""
    B, H, N, P = 2, 3, 16, 64
    arrs = _ssd_inputs(B, H, S, N, P, seed=S)
    y_j, st_j = j_ssd_chunked(*map(jnp.asarray, arrs), chunk=64,
                              interpret=True)
    y_t, st_t = ssd_tiles(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **SSD_TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **SSD_TOL)
    L = max(1, S // 3)
    x, dt, Bm, Cm, a = arrs
    short = (x[1:2, :, :L], dt[1:2, :, :L], Bm[1:2, :L], Cm[1:2, :L], a)
    _, st_short = ssd_tiles(*map(torch.from_numpy, short))
    np.testing.assert_allclose(st_t[1:2].numpy(), st_short.numpy(), **SSD_TOL)
