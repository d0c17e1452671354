"""No module the benchmark runs imports JAX or the JAX package, compared
by whole top-level name; the reference imports nothing of the port."""
import ast
import json
import subprocess
import sys

from hetbench.tests.tiny import HERE, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_anywhere():
    for f in HERE.rglob("*.py"):
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, (f, bad)


def test_reference_imports_nothing_of_the_port():
    for f in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(f)), f


def test_a_run_loads_neither(tiny_root):
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "from hetbench import harness\n"
        "out = harness.run_cell(%r, 'tiny-granite-chat', 5, 0.5, False, "
        "t_process=time.monotonic(), device='cpu')\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (str(REPO / "src"), str(REPO), str(tiny_root)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_run_exits_nonzero_without_the_card_or_the_port(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "hetbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run(
        [sys.executable, "hetbench/run.py", "--workload", "granite-serve-chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()
