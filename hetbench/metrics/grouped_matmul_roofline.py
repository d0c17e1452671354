"""grouped_matmul's share of its roofline in the traced slice (%): the
least time the real tokens' top_k choices need through both expert GEMMs
of every layer (costs.expert_gemms: every expert's weights read once),
prefill and decode calls together, over the profiled device time of the
grouped-matmul kernels."""
from hetbench import costs, profiling

KERNELS = ("gmm_kernel", "gmm_tc_decode", "gmm_tc_prefill")


def read(run):
    if run.kind != "serve" or run.prof is None:
        return None
    dev = profiling.kernel_seconds(run.prof["by_name"], KERNELS)
    pre, dec = run.prof_calls
    tokens = [int(sum(lens)) for lens in pre] + [len(pos) for pos in dec]
    if dev <= 0 or not tokens:
        return None
    need = sum(run.z["L"] * costs.bound_s(f, b, costs.PEAK_BF16)
               for n in tokens if n for f, b in costs.expert_gemms(run.z, n))
    return 100.0 * need / dev
