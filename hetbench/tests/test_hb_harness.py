"""Every tiny cell runs end to end on the CPU through the harness, and a
new mix, cell and metric join as new files."""
import json
import shutil

import pytest

from hetbench import harness
from hetbench.tests import tiny


def _run(root, cell, trace=False, seed=2 ** 31 + 77, seconds=1.0, **kw):
    import time
    return harness.run_cell(root, cell, seed, seconds, trace,
                            t_process=time.monotonic(), device="cpu", **kw)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cell_is_correct_and_reports_its_metrics(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"] is True, out["checks"]
    assert list(out)[0] == "correct" and list(out)[-1] == "checks"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values()
               if v["unit"] != "GiB")
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny-granite-train", "tiny-granite-chat"])
def test_traced_run_reads_its_per_layer_metrics(tiny_root, cell):
    # decode_step_ms.serve reads two decode steps with no prefill between
    out = _run(tiny_root, cell, trace=True, seconds=3.0)
    assert out["correct"] is True
    assert "window_s" in out["device"] and "breakdown" in out
    names = set(out["metrics"])
    if cell.endswith("train"):
        assert {"wave_compute_ms.train", "push_ms.train", "pull_ms.train",
                "mfu.train", "tokens_per_s.train"} <= names
    else:
        assert {"decode_step_ms.serve", "prefill_share.serve",
                "pages_peak_share.serve", "mfu.serve",
                "tokens_per_s.chat"} <= names


def test_a_new_mix_cell_and_metric_are_new_files(tiny_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    h = root / "hetbench"
    mix = json.loads((h / "traffic" / "tiny-chat.json").read_text())
    mix.update(max_batch=2, prompt_law={"law": "uniform", "lo": 2, "hi": 8})
    (h / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (h / "cells" / "dummy-cell.json").write_text(json.dumps(
        {"limits": tiny.LIMITS["tiny-granite-chat"]}))
    (h / "metrics" / "dummy_tokens.serve.py").write_text(
        "def read(run):\n"
        "    return float(run.timeline.tokens) if run.kind == 'serve' "
        "else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-cell", "config": "tiny-granite",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_tokens.serve", "unit": "tokens",
                               "better": "higher", "source": "program_span",
                               "layer": "api/serving.py Scheduler",
                               "moves": "itl_p95_ms",
                               "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"]:
        if "tiny-granite-chat" in m.get("workloads", []):
            m["workloads"].append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "dummy-cell", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["dummy_tokens.serve"]["value"] > 0
    assert "itl_p95_ms" in _run(root, "dummy-cell")["metrics"]


def test_a_new_family_is_new_files(tiny_root, tmp_path):
    """A configuration of a family the harness has never seen joins as a
    family module and a configuration file: the drivers, the weights and
    the metric readers reach the family through the configuration."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    h = root / "hetbench"
    (h / "families" / "dummy.py").write_text(
        "from hetbench.families import moe\n"
        "CALLS = []\n"
        "train_loss, sizes = moe.train_loss, moe.sizes\n"
        "def _seen(name):\n"
        "    def f(*a, **k):\n"
        "        CALLS.append(name)\n"
        "        return getattr(moe, name)(*a, **k)\n"
        "    return f\n"
        "for _n in ('block_specs', 'matmul_params', 'token_flops',\n"
        "           'prompt_flops', 'train_flops', 'check_serve'):\n"
        "    globals()[_n] = _seen(_n)\n")
    cfg = json.loads((h / "configs" / "tiny-granite.json").read_text())
    cfg.update(name="tiny-dummy", family="dummy")
    (h / "configs" / "tiny-dummy.json").write_text(json.dumps(cfg))
    (h / "cells" / "dummy-chat.json").write_text(json.dumps(
        {"limits": tiny.LIMITS["tiny-granite-chat"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-chat", "config": "tiny-dummy",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-granite-chat" in m.get("workloads", []):
            m["workloads"].append("dummy-chat")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "dummy-chat", trace=True)
    assert out["correct"] is True, out["checks"]
    assert "mfu.serve" in out["metrics"]
    import sys
    calls = set(sys.modules["hetbench_family_dummy"].CALLS)
    assert {"block_specs", "check_serve", "prompt_flops"} <= calls
