"""Model FLOPs utilisation of the window's training (%): a wave's model
FLOPs (the family's train_flops: 6 x the matmul weights a token plus
3 x causal attention's forward FLOPs), times the waves run, over the
window, against the H100's 67 TFLOP/s of float32 outside the tensor
cores."""
from hetbench import costs


def read(run):
    if run.kind != "train" or not run.waves:
        return None
    t0, t1 = run.window
    return 100.0 * run.wave_flops * len(run.waves) / (t1 - t0) \
        / costs.PEAK_F32
