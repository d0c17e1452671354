"""The control, on the card: the reference in the precision just below the
configuration's (TF32 operands for float32 training, fp8 e4m3 for
bfloat16 serving), or a planted fault ("fault:half_batch",
"fault:no_exchange"; training), put in the program's place and judged by
the cell's own limits, which it has to fail.

    python3 hetbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--control fp8]

All seeds run in one process. Prints one JSON line a seed: the control's
readings, `control_correct` (false where a limit caught it) and, where
the control needs the program's run (serving: it is read on the run's
own inputs and pages), the program's readings. The benchmark's own runs
never run the control."""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from hetbench import harness  # noqa: E402

CONTROL = {"fit": "tf32", "scheduler": "fp8"}


def read(root, workload: str, seed: int, seconds: float, mode: str = "",
         *, t_process: float, device=None) -> dict:
    """One seed's control: its readings and whether the cell's limits let
    it pass. A driver with a `control(ctx)` of its own reads it with no
    program run; the others run the cell with the control read beside."""
    cell = harness.Cell(root, workload)
    mode = mode or CONTROL[cell.mix["entry"]]
    hooks = {"control": mode}
    if hasattr(cell.driver, "control"):
        ctx = harness.context(cell, seed, seconds, False,
                              t_process=t_process, device=device,
                              hooks=hooks)
        readings, program, notes = cell.driver.control(ctx), {}, \
            getattr(ctx, "notes", {})
    else:
        out = harness.run_cell(root, workload, seed, seconds, False,
                               t_process=t_process, device=device,
                               hooks=hooks)
        readings, program, notes = out["control"], out["readings"], \
            out["notes"]
        program.update(correct=out["correct"], timings=out["timings"])
    ok, checks = harness.judge(readings, cell.limits)
    return {"seed": int(seed), "control": mode, "control_correct": ok,
            "control_checks": checks, "control_readings": readings,
            "program": program, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="",
                    help="the precision or fault (default: the entry's)")
    a = ap.parse_args(argv)
    t = T_PROCESS
    for seed in (int(s) for s in a.seeds.split(",")):
        out = read(ROOT, a.workload, seed, a.seconds, a.control,
                   t_process=t)
        print(json.dumps(out), flush=True)
        t = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
