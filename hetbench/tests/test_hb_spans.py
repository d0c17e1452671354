"""The readers of the program's serve-step and training-wave spans: each
reads a number in a traced run of every tiny cell its entry names, and
None where the run holds none of its spans or totals (an untraced run, a
program without them)."""
import json
import time
from types import SimpleNamespace

import pytest

from hetbench import harness

NEW = ("decode_issue_ms.serve", "decode_drain_ms.serve",
       "decode_pick_ms.serve", "admit_ms.serve", "prefill_pad_share.serve",
       "fwd_bwd_ms.train", "optim_ms.train", "wave_wait_ms.train",
       "pull_wait_ms.train", "pull_h2d_ms.train", "ps_pull_ms.train",
       "ps_apply_ms.train")
TRAIN_NAMES = ("fwd_bwd", "optim", "pull_wait", "h2d", "pull_serve",
               "push_apply")


def _entries(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}


def _reader(root, name):
    return harness.load_module(root / "hetbench" / "metrics" / f"{name}.py",
                               "hb_test_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def traced(tiny_root):
    """The run object of a traced run of each tiny cell, as its entry
    point returns it to the harness."""
    cells = sorted({w for m in _entries(tiny_root).values()
                    for w in m["workloads"]})
    out = {}
    for name in cells:
        cell = harness.Cell(tiny_root, name)
        ctx = harness.context(cell, 2 ** 31 + 91, 3.0, True,
                              t_process=time.monotonic(), device="cpu")
        out[name] = cell.driver.run(ctx)
    return out


def test_every_new_metric_has_its_entry(tiny_root):
    got = _entries(tiny_root)
    assert sorted(got) == sorted(NEW)
    for m in got.values():
        assert m["better"] == "lower" and m["workloads"]
        assert m["moves"] == ("setup_s" if m["name"].endswith(".train")
                              else "itl_p95_ms")


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_number_in_its_traced_cells(tiny_root, traced, name):
    read = _reader(tiny_root, name).read
    for cell in _entries(tiny_root)[name]["workloads"]:
        v = read(traced[cell])
        assert isinstance(v, float) and v > 0, (name, cell, v)
        if name == "prefill_pad_share.serve":
            assert v < 100


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_without_its_spans(tiny_root, traced, name):
    read = _reader(tiny_root, name).read
    if name.endswith(".train"):
        run = traced["tiny-granite-train"]
        assert read(SimpleNamespace(**dict(vars(run), spans=[]))) is None
        old = [e for e in run.spans if e[2] not in TRAIN_NAMES]
        assert read(SimpleNamespace(**dict(vars(run), spans=old))) is None
        assert read(traced["tiny-granite-chat"]) is None
    else:
        run = traced["tiny-granite-chat"]
        # a report of a program without the totals, and an untraced one
        bare = SimpleNamespace(decode_steps=5, prefill_calls=2)
        assert read(SimpleNamespace(**dict(vars(run), report=bare))) is None
        if name != "prefill_pad_share.serve":
            zero = SimpleNamespace(**dict(vars(run.report)))
            for f in ("decode_issue_s", "decode_drain_s", "logits_d2h_s",
                      "pick_s", "admit_s"):
                setattr(zero, f, 0.0)
            assert read(SimpleNamespace(**dict(vars(run),
                                               report=zero))) is None
        assert read(traced["tiny-granite-train"]) is None
