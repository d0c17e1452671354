"""The hd-256 tensor-core routes' two build-time choices, timed on the card.

    python -m repro_torch.kernels.hd256_variants

csrc/flash_attention.cu takes TC_GB256 query heads a block at hd 256 where
the GQA group is even (1 or 2: shared memory allows no more), and
csrc/flash_decode.cu walks a row with TC_WARPS_HD256 warps a block there (a
warp's ring takes 33 KB). Each variant is a copy of the source with that
constant changed, compiled beside the real one (one nvcc each, all started
together, into build/hd256_variants/) and timed through the wrappers, with
the loaded library swapped, at gemma3-1b's shapes as chip_smoke.py phase 2
times them: device time, a CUDA graph over one input set per layer, in
turns (the variants in order, then in reverse, averaged). A decode variant
is timed at several spans (kernels/flash_decode.py:SPAN_HD256, the floor of
a chunk), since its warps set how many positions a block keeps in flight.
Each variant's hd-256 tensor-core kernels' registers and spills (nvcc
-Xptxas -v) are printed too. Needs one sm_90 card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.scan_ablation import _time_ms

OUT = _build.BUILD_ROOT.parent / "hd256_variants"
# (source, constant's line in it, the values it is built with)
VARIANTS = {"flash_attention": ("constexpr int TC_GB256 = {};", (1, 2)),
            "flash_decode": ("constexpr int TC_WARPS_HD256 = {};", (3, 4, 6))}
SPANS = (64, 128, 192)


def _build_variant(src: str, value: int, nvcc: str):
    """csrc/<src>.cu with its constant set to `value`: (library, the ptxas
    lines of its hd-256 tensor-core kernels)."""
    line, _ = VARIANTS[src]
    text = (_build.CSRC / f"{src}.cu").read_text()
    real = [v for v in range(1, 9) if text.count(line.format(v)) == 1]
    if len(real) != 1:
        raise RuntimeError(f"{src}: {line.format('N')!r} is not in the "
                           f"source once")
    text = text.replace(line.format(real[0]), line.format(value))
    cu, so = OUT / f"{src}_{value}.cu", OUT / f"lib{src}_{value}.so"
    cu.write_text(text)
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-o", str(so), str(cu)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src} = {value}:\n"
                           f"{res.stderr[-3000:]}")
    log = res.stdout.splitlines() + res.stderr.splitlines()
    info = []
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln and "_tc_" in ln and \
                "Li256E" in ln:
            rest = [x.split("info    : ")[-1].strip() for x in log[i + 1:i + 4]]
            info.append(ln.split("'")[1] + ": " + "; ".join(
                x for x in rest if "registers" in x or "spill" in x))
    return ctypes.CDLL(str(so)), info


def _use(src: str, lib) -> None:
    """Make the wrappers launch from `lib` for csrc/<src>.cu."""
    _build._LIBS[src] = lib
    for key in [k for k in _build._ENTRIES if k[0] == src]:
        del _build._ENTRIES[key]


def _in_turns(timers: dict) -> dict:
    ms = {k: [t()] for k, t in timers.items()}
    for k, t in reversed(list(timers.items())):
        ms[k].append(t())
    return {k: round(sum(v) / len(v), 4) for k, v in ms.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("hd256_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(src, v) for src, (_, vals) in VARIANTS.items() for v in vals]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda j: _build_variant(*j, nvcc),
                                      jobs)))
    for (src, v), (_, info) in built.items():
        for ln in info:
            print(f"[variants] {src} = {v}: {ln}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    rows = []
    # prefill attention: gemma3-1b's serve shape over 26 layers' inputs and
    # B 2 x S 600 with window 512 over 4
    for B, S, window, layers in ((8, 128, 0, 26), (2, 600, 512, 4)):
        sets = [tuple(rnd(B, S, n, 256).transpose(1, 2) for n in (4, 1, 1))
                for _ in range(layers)]

        def timer(lib, window=window, sets=sets):
            def run():
                _use("flash_attention", lib)
                return _time_ms(lambda q, k, v: flash_attention_fwd(
                    q, k, v, window=window), sets)
            return run
        ms = _in_turns({v: timer(built[("flash_attention", v)][0])
                        for v in VARIANTS["flash_attention"][1]})
        for v, t in ms.items():
            rows.append(dict(kernel="flash_attention_fwd", TC_GB256=v,
                             shape=f"B{B} S{S} 4/1x256 window {window}",
                             ms=t))
        del sets
    # decode: the serve pool (B 8, lengths 17..160 on 16-position pages)
    # and a contiguous [8, 160] cache at length 140
    B, ps, npg, P1 = 8, 16, 10, 49
    lens = torch.tensor(np.random.default_rng(0).integers(17, 161, B),
                        device=dev, dtype=torch.int32)
    tab = torch.full((B, npg), -1, dtype=torch.int32, device=dev)
    free = iter(torch.randperm(P1 - 1, generator=g, device=dev).tolist())
    for b in range(B):
        for i in range(-(-int(lens[b]) // ps)):
            tab[b, i] = next(free)
    clens = torch.full((B,), 140, device=dev, dtype=torch.int32)

    def n_sets(live):   # layers of inputs whose live K/V is twice the L2
        return max(4, -(-2 * 50_000_000 // (4 * live * 256)))
    n = n_sets(int(lens.sum()))
    kp, vp = rnd(n, P1, ps, 1, 256), rnd(n, P1, ps, 1, 256)
    q1 = rnd(B, 4, 256)
    paged = [(q1, kp, vp, tab, lens, layer) for layer in range(n)]
    cache = rnd(n_sets(int(clens.sum())), 2, B, 160, 1, 256)
    cont = [(q1, c[0].transpose(1, 2), c[1].transpose(1, 2), clens)
            for c in cache]
    for name, fn, sets in (
            ("flash_decode_paged", lambda q1, kp, vp, tab, lens, layer:
             flash_decode_paged(q1, kp, vp, tab, lens, layer=layer), paged),
            ("flash_decode", flash_decode, cont)):
        keep = fd.SPAN_HD256["tc"]

        def timer(lib, span, fn=fn, sets=sets):
            def run():
                _use("flash_decode", lib)
                fd.SPAN_HD256["tc"] = span
                return _time_ms(fn, sets)
            return run
        try:
            ms = _in_turns({(v, span): timer(built[("flash_decode", v)][0],
                                             span)
                            for v in VARIANTS["flash_decode"][1]
                            for span in SPANS})
            for (v, span), t in ms.items():
                fd.SPAN_HD256["tc"] = span
                rows.append(dict(kernel=name, TC_WARPS_HD256=v, span=span,
                                 splits_chunk=fd._splits(B, 1, 160, "tc",
                                                         256),
                                 shape="B8 4/1x256 cap 160", ms=t))
        finally:
            fd.SPAN_HD256["tc"] = keep
    for r in rows:
        print("[variants] " + json.dumps(r), flush=True)
    print(json.dumps({"hd256_variants": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
