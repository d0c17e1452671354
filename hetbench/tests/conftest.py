import sys
from pathlib import Path

import pytest
import torch

# one thread a test process: the tiny cells' windows are timed, and
# workers that share the cores would each run a handful of steps
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from hetbench.tests import tiny
    return tiny.make_root(tmp_path_factory.mktemp("hb"))
