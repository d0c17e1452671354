"""Model families, one file each: families/<family>.py, found by the
`family` a configuration names. A family module gives

    sizes(fields) -> dict        its sizes, read from the port's fields
    block_specs(z) -> dict       {leaf: (shape, init, scale)} of one layer
    matmul_params(z), token_flops(z, pos), prompt_flops(z, L)
                                 the forward FLOPs of the real tokens
    check_serve(ctx, z, reqs, seen, mode) -> (readings, control readings)
                                 the served outputs against the reference

and, where the family trains, train_flops(z, rows, seq) and
train_loss(z, params, inputs, labels, prec). Its plain reference is
reference/<model>.py. A new family is two new files."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str, where: Path = HERE):
    """The family module families/<name>.py under `where`, loaded once per
    file."""
    path = Path(where) / f"{name}.py"
    key = f"hetbench_family_{name}"
    mod = sys.modules.get(key)
    if mod is None or Path(mod.__file__) != path:
        if not path.is_file():
            raise KeyError(f"no family {name!r}: {path} does not exist")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod
