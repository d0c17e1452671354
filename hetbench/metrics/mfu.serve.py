"""Model FLOPs utilisation of the window's serving (%): the forward FLOPs
of the real prompt tokens admitted and the real tokens decoded in the
window (the family's prompt_flops / token_flops, no padding, no idle rows),
over the window, against the H100's 989 TFLOP/s of bf16."""
from hetbench import costs


def read(run):
    if run.kind != "serve":
        return None
    z, fam = run.z, run.family
    f = sum(fam.prompt_flops(z, int(L)) for _, lens in run.prefills
            for L in lens)
    f += sum(fam.token_flops(z, int(p)) for _, pos in run.decodes
             for p in pos)
    t0, t1 = run.window
    return 100.0 * f / (t1 - t0) / costs.PEAK_BF16
