"""Tiny stand-ins of the benchmark's cells for the CPU tests: a copy of
hetbench/ under a temporary root, with configurations of the same
families at toy widths, mixes at toy lengths and a BENCHMARK.json naming
them. The harness runs them as it runs the real cells."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

GRANITE = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
           "head_dim": 16, "d_ff": 32, "vocab_size": 250, "num_experts": 4,
           "top_k": 2, "stages": 1, "tp": 1}
RWKV6 = {"num_layers": 2, "d_model": 128, "d_ff": 96, "vocab_size": 250,
         "ssm_heads": 2, "stages": 1, "tp": 1}


def _config(name, tiny):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["port"]["fields"].update(tiny)
    cfg["reduced"] = sorted(tiny)
    return cfg


def _mixes():
    train = json.loads((HERE / "traffic" / "train-wsp.json").read_text())
    train.update(rows_per_wave=4, seq=32, microbatches=2)
    chat = json.loads((HERE / "traffic" / "chat-b128.json").read_text())
    chat.update(max_batch=4, prompt_len=16, gen=12, requests=512, block=8,
                prompt_law={"law": "loguniform", "lo": 4, "hi": 16},
                output_law={"law": "loguniform", "lo": 3, "hi": 12},
                page_size=4, profile_steps=2)
    rag = json.loads((HERE / "traffic" / "rag-b16.json").read_text())
    rag.update(max_batch=3, prompt_len=40, gen=6, requests=256, block=8,
               prompt_law={"law": "uniform", "lo": 10, "hi": 40},
               output_law={"law": "uniform", "lo": 2, "hi": 6},
               page_size=4, profile_steps=2)
    return {"tiny-train": train, "tiny-chat": chat, "tiny-rag": rag}


CELLS = {"tiny-granite-train": ("tiny-granite", "tiny-train"),
         "tiny-granite-chat": ("tiny-granite", "tiny-chat"),
         "tiny-rwkv6-rag": ("tiny-rwkv6", "tiny-rag"),
         "tiny-granite-rag": ("tiny-granite", "tiny-rag")}
# set between the sound program's readings at these sizes and the
# control's (tests/test_hb_control.py)
LIMITS = {"tiny-granite-train": {"loss1": 1e-6, "grad1": 5e-6,
                                 "change3": 5e-6},
          "tiny-granite-chat": {"gap_prefill": 0.05, "logits_prefill": 0.02,
                                "kv_prefill": 0.02, "gap_decode": 0.05,
                                "logits_decode": 0.02, "kv_decode": 0.02},
          "tiny-granite-rag": {"gap_prefill": 0.05, "logits_prefill": 0.02,
                               "kv_prefill": 0.02, "gap_decode": 0.05,
                               "logits_decode": 0.02, "kv_decode": 0.02},
          "tiny-rwkv6-rag": {"gap_served": 0.05, "logits_prefill": 0.02,
                             "logits_decode": 0.02}}


def make_root(tmp: Path) -> Path:
    """A checkout-like root under tmp holding hetbench/ (tests and caches
    left out), the tiny files and a BENCHMARK.json of the tiny cells with
    the real one's metrics."""
    root = Path(tmp) / "root"
    shutil.copytree(HERE, root / "hetbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    h = root / "hetbench"
    for name, tiny in (("tiny-granite", _config("granite-moe-1b-a400m",
                                                GRANITE)),
                       ("tiny-rwkv6", _config("rwkv6-3b", RWKV6))):
        (h / "configs" / f"{name}.json").write_text(json.dumps(tiny))
    for name, mix in _mixes().items():
        (h / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, lim in LIMITS.items():
        (h / "cells" / f"{cell}.json").write_text(json.dumps({"limits": lim}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    real = {w["name"]: w for w in bench["workloads"]}
    rename = {"granite-train-wsp": "tiny-granite-train",
              "granite-serve-chat": "tiny-granite-chat",
              "rwkv6-serve-rag": "tiny-rwkv6-rag",
              "granite-serve-rag": "tiny-granite-rag"}
    bench["workloads"] = [
        dict(real[r], name=t, config=CELLS[t][0], traffic=CELLS[t][1])
        for r, t in rename.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
