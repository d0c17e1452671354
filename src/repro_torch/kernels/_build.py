"""Build and load the Hopper kernels at first use.

Every `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`),
loaded with ctypes — no PyTorch headers, so a build takes seconds, not
the minutes `torch.utils.cpp_extension.load` needs. The libraries land in
`<repo>/build/repro_torch_kernels/<hash>/`, keyed by a hash of every source
and the flags, so an edited kernel rebuilds and an unchanged one loads.

Each C entry takes device pointers and the stream as `void*`, sizes and
strides as ints, launches on that stream and returns `cudaGetLastError()`;
`check()` raises when it is not 0. Nothing here falls back to a kernel's
plain version: without nvcc or a CUDA device, loading raises.

`LAUNCHES[name]` counts the launches each wrapper makes (only where it
launches its kernel), so a run can show that its path went through the
kernels. On a meta tensor (the dry run, launch/dryrun.py) a wrapper runs
its checks and allocations, picks its route, reports the launch with its
`cost()` to the active cost counter (launch/costs.py) and returns the
empty output: LAUNCHES and ROUTES stay the card's exact counts. The Router's replicas launch from host threads at once (each
ctypes call releases the GIL), so the counts and the first build of a
library are taken under locks. Every kernel has more than one route
(grouped_matmul, flash_attention_fwd, flash_decode, flash_decode_paged:
bf16 tensor-core tiles beside f32-FMA ones; rwkv6_chunked, ssd_chunked:
f32 register tiles fed by cp.async beside the first f32-FMA design) and
counts each launch once more in `ROUTES[name][route]`; a route is picked
before the launch by the wrapper's `_route`, never switched after an
error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0, "flash_decode": 0,
                            "flash_decode_paged": 0, "rwkv6_chunked": 0,
                            "ssd_chunked": 0, "grouped_matmul": 0}

ROUTES: dict[str, dict[str, int]] = {
    "flash_attention_fwd": {"tc": 0, "simt_bf16": 0, "simt_f32": 0},
    "flash_decode": {"tc": 0, "simt_bf16": 0, "simt_f32": 0},
    "flash_decode_paged": {"tc": 0, "simt_bf16": 0, "simt_f32": 0},
    "grouped_matmul": {"tc_decode": 0, "tc_prefill": 0, "simt_bf16": 0,
                       "simt_f32": 0},
    "rwkv6_chunked": {"tile": 0, "simt": 0},
    "ssd_chunked": {"tile": 0, "simt": 0}}

_LIBS: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()     # LAUNCHES / ROUTES updates
_LOAD_LOCK = threading.Lock()      # first build + load of a library


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def count(name: str, route: str | None = None) -> None:
    """One launch of `name` (through `route`, for a kernel with routes).
    `+=` on a dict item is a read, an add and a store, so the update is
    taken under a lock: replica threads launch at the same time."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if route is not None:
            ROUTES[name][route] += 1


def simt_route(dtype) -> str:
    """The f32-FMA route of a kernel with routes, for operands of `dtype`."""
    import torch
    return "simt_f32" if dtype == torch.float32 else "simt_bf16"


def vec16_ok(t) -> bool:
    """Whether `t` can be copied in 16-byte vectors along its last dim (which
    is contiguous): a 16-byte aligned base, and the last dim's length and
    every other stride (of a dim longer than 1) whole multiples of 16
    bytes. The tensor-core routes' cp.async and TMA copies need it."""
    per = 16 // t.element_size()
    # a meta tensor has no address: its base is taken as allocated (the
    # caching allocator aligns every block to 512 bytes) plus its offset
    base = t.storage_offset() * t.element_size() if t.device.type == "meta" \
        else t.data_ptr()
    return base % 16 == 0 and t.shape[-1] % per == 0 and all(
        n == 1 or s % per == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]))


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    nvcc on PATH. Raises when none exists."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands.append("/usr/local/cuda/bin/nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the repro_torch Hopper kernels: nvcc not found (looked "
        "in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH). The kernels run "
        "only on an sm_90 card with the CUDA toolkit; tensors on the CPU "
        "take the plain PyTorch versions instead")


def _require_device() -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cannot load the repro_torch Hopper kernels: no CUDA device is "
            "visible to torch. The kernels run only on an sm_90 card; "
            "tensors on the CPU take the plain PyTorch versions instead")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(nvcc: str, name: str, out_dir: Path) -> Path:
    so = out_dir / f"lib{name}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / f"{name}.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def build_all() -> float:
    """Compile every csrc/*.cu (one nvcc each, all started together) and
    load them. Returns the seconds it took; 0-ish when already built."""
    _require_device()
    nvcc = find_nvcc()
    out_dir = _build_dir()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        sos = list(ex.map(lambda n: _compile(nvcc, n, out_dir), names))
    for name, so in zip(names, sos):
        _LIBS.setdefault(name, ctypes.CDLL(str(so)))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        # one thread builds; the others wait for it instead of racing on
        # the same temporary file
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _require_device()
                so = _compile(find_nvcc(), name, _build_dir())
                lib = _LIBS.setdefault(name, ctypes.CDLL(str(so)))
    return lib


_ENTRIES: dict = {}


def entry(name: str, fn: str, argtypes: list):
    """The C entry `fn` of csrc/<name>.cu with its ctypes signature (an int
    result, `argtypes`), set up once: a launch then pays only the call."""
    key = (name, fn)
    f = _ENTRIES.get(key)
    if f is None:
        f = getattr(load(name), fn)
        f.restype, f.argtypes = INT, argtypes
        _ENTRIES[key] = f
    return f


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) for csrc/<name>.cu."""
    p = _build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by one of `lib`'s entries
    (every csrc library exports `repro_cuda_error_string`)."""
    if err != 0:
        fn = lib.repro_cuda_error_string
        fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({fn(err).decode()})")


def dtype_code(dtype) -> int:
    """The dtype codes of csrc/common.cuh (repro::DType)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
    if dtype not in codes:
        raise ValueError(f"the kernels take float32, bfloat16 or "
                         f"float8_e4m3fn, got {dtype}")
    return codes[dtype]


# ctypes argument kinds shared by the wrappers
PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong
