"""rwkv6_chunked's share of its roofline in the traced slice (%): the
least time the admitted prompts' WKV recurrence needs (costs.wkv on the
real lengths, float32, per layer) over the profiled device time of the
WKV6 kernels, padding included."""
from hetbench import costs, profiling

KERNELS = ("wkv6_tile_kernel", "wkv6_kernel")


def read(run):
    if run.kind != "serve" or run.prof is None:
        return None
    dev = profiling.kernel_seconds(run.prof["by_name"], KERNELS)
    calls = run.prof_calls[0]
    if dev <= 0 or not calls:
        return None
    need = sum(run.z["L"] * costs.bound_s(*costs.wkv(
        run.z, [int(L) for L in lens]), costs.PEAK_F32) for lens in calls)
    return 100.0 * need / dev
