"""The control (the reference one precision step down, or a planted
fault, put in the program's place) comes out not correct under each tiny
cell's own limits, over three seeds as on the card, through the same
judgement as the program's runs: the mechanism hetbench/control.py runs
there."""
import time

import pytest

from hetbench import control
from hetbench.tests import tiny

SEEDS = (2 ** 31 + 9, 2 ** 31 + 10, 2 ** 31 + 11)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_separates_from_the_program(tiny_root, cell):
    for seed in SEEDS:
        out = control.read(tiny_root, cell, seed, 1.0,
                           t_process=time.monotonic(), device="cpu")
        assert out["control_correct"] is False, out["control_checks"]
        prog = out["program"]
        if prog:
            # the serve control is read on the program's own run
            assert prog["correct"] is True, prog
            assert any(out["control_readings"][n] > 3 * prog[n]
                       for n in tiny.LIMITS[cell]), (prog, out)


@pytest.mark.parametrize("fault", ["fault:half_batch", "fault:no_exchange"])
def test_planted_training_faults_fail_the_limits(tiny_root, fault):
    for seed in SEEDS:
        out = control.read(tiny_root, "tiny-granite-train", seed, 1.0,
                           fault, t_process=time.monotonic(), device="cpu")
        assert out["control_correct"] is False, out["control_checks"]
