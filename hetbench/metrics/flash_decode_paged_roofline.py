"""flash_decode_paged's share of its roofline in the traced slice (%): the
least time the decode steps' real rows need (each live row's K/V read
once; costs.decode_paged, per layer) over the profiled device time of the
paged decode kernels."""
from hetbench import costs, profiling

KERNELS = ("decode_tc_kernel", "decode_simt_kernel")


def read(run):
    if run.kind != "serve" or run.prof is None:
        return None
    dev = profiling.kernel_seconds(run.prof["by_name"], KERNELS)
    calls = run.prof_calls[1]
    if dev <= 0 or not calls:
        return None
    need = sum(run.z["L"] * costs.bound_s(*costs.decode_paged(
        run.z, [int(p) + 1 for p in pos]), costs.PEAK_BF16)
        for pos in calls if len(pos))
    return 100.0 * need / dev
