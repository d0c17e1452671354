"""Ablations of the chunked WKV6 and SSD tile kernels on the card.

    python -m repro_torch.kernels.scan_ablation [wkv6] [ssd] [ssd128]

Each variant is a copy of csrc/rwkv6_scan.cu or csrc/mamba_ssd.cu with one
part of the tile kernel's chunk loop taken out (its loop bounds set to 0,
its branch made dead), its cp.async ring deepened, or its tiling changed
(slices of 16 state columns; SSD: one head a block), compiled beside the
real kernel (one nvcc each, all started together, into
build/scan_ablation/). The suites: wkv6 (rwkv6_chunked), ssd (the SSD tile
kernel at state 16) and ssd128 (at state 128); all three without an
argument. A variant's output is wrong by design: only its time
is read. Every variant is timed as chip_smoke.py phase 2 times the kernels
(device time, a CUDA graph replayed over one input set per layer), at the
serve shape and a long one (ssd128: granite4h-serve-chat's padded
[64, 128, 512, 64] group), with the real kernel timed first and last. The
time a variant saves is what that part costs; `occ` is the blocks an SM can
hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Needs one sm_90 card
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import torch

from repro_torch.kernels import _build, mamba_ssd, rwkv6_scan

OUT = _build.BUILD_ROOT.parent / "scan_ablation"
NO_LOAD = ("    load(c + L::STAGES - 1, (c + L::STAGES - 1) % L::STAGES);",
           "    repro::cp_async_commit();")

# slices of 16 columns hand 2-float rows to repro::ldv / stv
PAIRS = ('#include "mma.cuh"\n', '#include "mma.cuh"\nnamespace repro {\n'
         "__device__ void ldv(const float* p, float (&o)[2]) {\n"
         "  const float2 v = *reinterpret_cast<const float2*>(p);\n"
         "  o[0] = v.x; o[1] = v.y;\n}\n"
         "__device__ void stv(float* p, const float (&o)[2]) {\n"
         "  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);\n}\n"
         "}  // namespace repro\n")

# (source text, its replacement) per variant; each text must occur once
WKV6 = {
    "slices of 16": [("constexpr int JW = 32;", "constexpr int JW = 16;"), PAIRS],
    "stages 3": [("WKV_STAGES = 2;", "WKV_STAGES = 3;")],
    "stages 4": [("WKV_STAGES = 2;", "WKV_STAGES = 4;")],
    "no next-chunk loads": [NO_LOAD],
    "no A (cumsum, exponentials)": [
        ("    // A. cs over the chunk", "    if (a.S < 0)  // A. cs over the chunk")],
    "no B-D products": [
        ("for (int g = 0; g < 2; ++g) {", "for (int g = 0; g < 0; ++g) {"),
        ("for (int g = 0; g < 4; ++g) step(", "for (int g = 0; g < 0; ++g) step("),
        ("      step(R + HD + 4 * w, V + 4 * w * JW, JW);", ""),
        ("#pragma unroll 4\n      for (int s = 0; s < C; ++s) {",
         "#pragma unroll 4\n      for (int s = 0; s < 0; ++s) {")],
}
SSD = {
    "slices of 16": [("constexpr int PW = 32;", "constexpr int PW = 16;"), PAIRS],
    "1 head a block": [("constexpr int HG = 2;", "constexpr int HG = 1;")],
    "slices of 16, 1 head a block": [
        ("constexpr int PW = 32;", "constexpr int PW = 16;"), PAIRS,
        ("constexpr int HG = 2;", "constexpr int HG = 1;")],
    "stages 3": [("SSD_STAGES = 2;", "SSD_STAGES = 3;")],
    "no next-chunk loads": [NO_LOAD],
    "no cs scans": [("    if ((w == 1 || w == 3) && (w >> 1) < HG) {",
                     "    if (g.S < 0) {")],
    "no M exponentials": [
        ("            Msh[t * MP + s] = s <= t ? cb[r][2 * cp + c2] * (e * dts[c2]) : 0.f;",
         "            Msh[t * MP + s] = s <= t ? cb[r][2 * cp + c2] * dts[c2] : 0.f;")],
    "no C B^T": [("      for (int n = 0; n < N; n += 4) {\n        float av",
                  "      for (int n = 0; n < 0; n += 4) {\n        float av")],
    "no y products": [
        ("for (int s = kh ? 32 : 0; s < s_hi; s += 4)",
         "for (int s = kh ? 32 : 0; s < 0; s += 4)"),
        ("for (int n = 0; n < N; n += 4) step(", "for (int n = 0; n < 0; n += 4) step(")],
    "no state products": [("for (int s = 32 * tw; s < 32 * tw + 32; ++s) {",
                           "for (int s = 32 * tw; s < 0; ++s) {")],
}
# state 128 (SsdTile<128>): one row, HEADS heads and all 64 columns a block
SSD128 = {
    "1 head a block": [("NT = 256, HEADS = 2, STAGES = 2;",
                        "NT = 256, HEADS = 1, STAGES = 2;")],
    "no next-chunk loads": [
        ("    load_bc(c + 1);", "    repro::cp_async_commit();"),
        ("      load_x(gh, c + 1);", "      repro::cp_async_commit();")],
    "no cs scans": [("    if ((w & 1) && (w >> 1) < HB) {", "    if (g.S < 0) {")],
    "no M exponentials": [
        ("Msh[t * MP + s] = s <= t ? cb[r][2 * jp + j2] * (e * dts[j2]) : 0.f;",
         "Msh[t * MP + s] = s <= t ? cb[r][2 * jp + j2] * dts[j2] : 0.f;")],
    "no C B^T": [("    if (2 * ch + 1 <= rb)\n", "    if (g.S < 0)\n"),
                 ("    else if (2 * ch <= rb)\n", "    else if (g.S < 0)\n")],
    "no read-out C h": [("mac_rows<P>(Cs, BP, Hsh + py, N, ct, acc);",
                         "mac_rows<P>(Cs, BP, Hsh + py, 0, ct, acc);")],
    "no intra-chunk M x": [("mac_rows<P>(Msh, MP, X + py, 16 * rb + 16, ct, acc);",
                            "mac_rows<P>(Msh, MP, X + py, 0, ct, acc);")],
    "no state update": [("      for (int s = 0; s < C; ++s) {\n        float bq[4]",
                         "      for (int s = 0; s < 0; ++s) {\n        float bq[4]")],
}
# suite: (source, variants, the tile kernel and its layout for occupancy())
SUITES = {"wkv6": ("rwkv6_scan", WKV6, ("wkv6_tile_kernel", "WkvTile")),
          "ssd": ("mamba_ssd", SSD, ("ssd_tile_kernel<64, 16>", "SsdTile<16>")),
          "ssd128": ("mamba_ssd", SSD128,
                     ("ssd_tile_kernel<64, 128>", "SsdTile<128>"))}


def _variant(i: int, suite: str, tag: str, edits, nvcc: str) -> ctypes.CDLL:
    """The suite's csrc/<src>.cu with `edits`, and an `occupancy()` entry,
    built as variant number i."""
    src, _, (kern, layout) = SUITES[suite]
    text = (_build.CSRC / f"{src}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src} {tag}: {old!r} is not in the source once")
        text = text.replace(old, new)
    text += (f'\nextern "C" int occupancy() {{\n  int n = -1;\n'
             f'  cudaFuncSetAttribute({kern}, cudaFuncAttributeMaxDynamicSharedMemorySize, '
             f'{layout}::BYTES);\n  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, {kern}, '
             f'{layout}::NT, {layout}::BYTES);\n  return n;\n}}\n')
    name = f"{src}_{i}"
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src} {tag}:\n{res.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def _time_ms(fn, argsets, reps=3):
    """Device ms per call: a CUDA graph over argsets, replayed `reps` times."""
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    cg = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cg):
        for a in argsets:
            fn(*a)
    cg.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        cg.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * len(argsets))


def _wkv6_call(lib):
    f = lib.rwkv6_chunked_launch
    f.restype, f.argtypes = _build.INT, rwkv6_scan._ARGS

    def call(r, k, v, w, u):
        B, H, S, hd = r.shape
        y = torch.empty((B, S, H, hd), device=r.device).transpose(1, 2)
        st = torch.empty((B, H, hd, hd), device=r.device)
        err = f(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), y.data_ptr(), st.data_ptr(), B, H, S, hd,
                *r.stride()[:3], *y.stride()[:3], 1,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rwkv6 variant: CUDA error {err}")
    return call


def _ssd_call(lib):
    f = lib.ssd_chunked_launch
    f.restype, f.argtypes = _build.INT, mamba_ssd._ARGS

    def call(x, dt, Bm, Cm, a):
        B, H, S, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty((B, S, H, P), device=x.device).transpose(1, 2)
        st = torch.empty((B, H, N, P), device=x.device)
        err = f(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                a.data_ptr(), y.data_ptr(), st.data_ptr(), B, H, S, P, N,
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                *Cm.stride()[:2], *y.stride()[:3], 1,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd variant: CUDA error {err}")
    return call


def _wkv6_inputs(B, H, S, g):
    """r, k, v, w [B, H, S, 64] views of [B, S, H, 64] memory, u [H, 64]."""
    dev = g.device
    rkv = [(0.5 * torch.randn(B, S, H, 64, generator=g, device=dev)
            ).transpose(1, 2) for _ in range(3)]
    w = (-4.0 * torch.rand(B, S, H, 64, generator=g, device=dev)
         ).transpose(1, 2)
    return (*rkv, w, 0.3 * torch.ones(H, 64, device=dev))


def _ssd_inputs(B, H, S, g, P=64, N=16):
    """x and B/C column slices of one conv output, dt a [B, S, H] view."""
    dev = g.device
    conv = 0.5 * torch.randn(B, S, H * P + 2 * N, generator=g, device=dev)
    x = conv[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    dt = torch.empty((B, S, H), device=dev).uniform_(
        -7.0, -1.2, generator=g).exp_().transpose(1, 2)
    return (x, dt, conv[..., H * P:H * P + N], conv[..., H * P + N:],
            -torch.linspace(1.0, 16.0, H, device=dev))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scan_ablation: needs a CUDA card")
    suites = argv or list(SUITES)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(su, t, e) for su in suites
            for t, e in [("base", []), *SUITES[su][1].items()]]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda ij: _variant(ij[0], *ij[1], nvcc),
                           enumerate(jobs)))
    by_suite: dict = {}
    for (su, tag, _), lib in zip(jobs, libs):
        by_suite.setdefault(su, {})[tag] = lib
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for su, make, inputs, shapes in (
            ("wkv6", _wkv6_call, _wkv6_inputs,
             (((8, 40, 128), 32), ((8, 40, 1024), 4))),
            ("ssd", _ssd_call, _ssd_inputs,
             (((8, 50, 128), 32), ((4, 50, 1100), 3))),
            ("ssd128", _ssd_call, partial(_ssd_inputs, N=128),
             (((64, 128, 512), 2),))):
        if su not in by_suite:
            continue
        variants = by_suite[su]
        for (B, H, S), layers in shapes:
            sets = [inputs(B, H, S, g) for _ in range(layers)]
            order = ["base", *[t for t in variants if t != "base"], "base"]
            times: dict = {}
            for tag in order:
                times.setdefault(tag, []).append(
                    _time_ms(make(variants[tag]), sets))
            for tag, ts in times.items():
                row = dict(kernel=su, shape=[B, H, S], variant=tag,
                           ms=round(sum(ts) / len(ts), 4),
                           occ=variants[tag].occupancy())
                rows.append(row)
                print(f"[ablation] {su} [{B},{H},{S}] {tag}: "
                      f"{row['ms']:.4f} ms, occ {row['occ']}"
                      + (f" (first {ts[0]:.4f}, last {ts[1]:.4f})"
                         if len(ts) > 1 else ""), flush=True)
            del sets
    print(json.dumps({"ablation": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
