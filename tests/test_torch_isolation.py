"""The port stands alone: no jax, no repro, no silent CPU fallback."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BANNED = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|"
                    r"from\s+repro(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter that imports repro_torch and every submodule
    finds neither jax nor repro in sys.modules."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "n = sum(k.startswith('repro_torch') for k in sys.modules)\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    n, bad = out.stdout.split(" ", 1)
    assert bad.strip() == "[]", bad
    assert int(n) >= 25              # every module was really imported


def test_no_jax_or_repro_import_lines():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for f in files:
        with open(f) as fh:
            hit = BANNED.search(fh.read())
        assert hit is None, f"{f}: {hit.group(0)!r}"


def test_default_device_is_cuda_and_kernels_do_not_fall_back():
    """Engine(plan) with no device means the CUDA card — without one it
    raises and names device='cpu'; the kernel loader without nvcc or a
    card raises instead of handing back a plain version."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the check is for the CPU")
    from repro_torch.api import Engine, get_preset
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(get_preset("serve_tiny"))
    for call in (_build.build_all, lambda: _build.load("flash_decode")):
        with pytest.raises(RuntimeError, match="repro_torch Hopper kernels"):
            call()
    # a wrapper handed a CUDA tensor without a card raises too (a fake
    # tensor stands in for one); on meta it launches nothing and hands back
    # an empty output (the dry run's branch), never the plain version
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_decode import flash_decode_paged
    with FakeTensorMode():
        q1 = torch.zeros(1, 2, 32, device="cuda")
        pool = torch.zeros(1, 3, 4, 2, 32, device="cuda")
        tab = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
        with pytest.raises((RuntimeError, NotImplementedError)):
            flash_decode_paged(q1, pool, pool, tab, 1)
    before = dict(LAUNCHES)
    q1 = torch.zeros(1, 2, 32, device="meta")
    pool = torch.zeros(1, 3, 4, 2, 32, device="meta")
    tab = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    out = flash_decode_paged(q1, pool, pool, tab, 1)
    assert out.device.type == "meta" and out.shape == q1.shape
    assert LAUNCHES == before


@pytest.mark.parametrize("module", [
    "repro_torch.launch.costs", "repro_torch.launch.dryrun",
    "repro_torch.models.moe", "repro_torch.kernels.ops"])
def test_new_modules_import_no_benchmarks(module):
    """The dry run, its counter and the expert-parallel exchange import
    neither jax, repro nor benchmarks (the JAX package's analysers, which
    import jax): the port counts with its own counter."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro', 'benchmarks')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, "src", *module.split(".")) + ".py"
    with open(path) as fh:
        src = fh.read()
    assert BANNED.search(src) is None, path
    assert re.search(r"^\s*(import|from)\s+benchmarks\b", src,
                     re.M) is None, path


@pytest.mark.parametrize("module", [
    "repro_torch.faults.plan", "repro_torch.faults.errors",
    "repro_torch.faults.injector", "repro_torch.faults.supervisor",
    "repro_torch.faults", "repro_torch.obs.summary",
    "repro_torch.models.frontend", "repro_torch.models.cnn",
    "repro_torch.configs.paper_models", "repro_torch.launch.mesh",
    "repro_torch.core.wave"])
def test_copied_modules_stand_alone(module):
    """The modules copied from pure-Python JAX-package modules import in a
    fresh interpreter without jax or repro (they keep their own copy of
    what they need), and have no import line naming either."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
    path = os.path.join(ROOT, "src", *module.split("."))
    path = path + ".py" if os.path.exists(path + ".py") else \
        os.path.join(path, "__init__.py")
    with open(path) as fh:
        assert BANNED.search(fh.read()) is None, path
