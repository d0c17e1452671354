"""Pytest set-up for hetbench/tests.

tests/tiny.py's `make_root` shrinks the four cells it has stand-ins for
and renames the cells in each metric's `workloads` list to theirs; a list
that also names a cell added since (a cell of its own configuration, with
its own tiny run in tests/test_torch_granite4h.py) would be a name it
cannot rename. `make_root` is wrapped here to read a BENCHMARK.json whose
lists name the four cells only: a metric of the other cells alone is then
reported in no tiny cell, as in no real cell but those."""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

from hetbench.tests import tiny

# the real cells tiny.make_root has stand-ins for
SHRUNK = ("granite-train-wsp", "granite-serve-chat", "rwkv6-serve-rag",
          "granite-serve-rag")
_make_root = tiny.make_root


def make_root(tmp: Path) -> Path:
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in SHRUNK]
    repo = tiny.REPO
    with tempfile.TemporaryDirectory(dir=tmp) as view:
        (Path(view) / "BENCHMARK.json").write_text(json.dumps(bench))
        tiny.REPO = Path(view)
        try:
            return _make_root(tmp)
        finally:
            tiny.REPO = repo


tiny.make_root = make_root
