"""flash_attention_fwd's share of its roofline in the traced slice (%):
the least time the admitted prompts' causal attention needs
(costs.attention_prefill on the real lengths, per layer) over the
profiled device time of the attention kernels, padding included."""
from hetbench import costs, profiling

KERNELS = ("attn_tc_kernel", "attn_kernel")


def read(run):
    if run.kind != "serve" or run.prof is None:
        return None
    dev = profiling.kernel_seconds(run.prof["by_name"], KERNELS)
    calls = run.prof_calls[0]
    if dev <= 0 or not calls:
        return None
    need = sum(run.z["L"] * costs.bound_s(*costs.attention_prefill(
        run.z, [int(L) for L in lens]), costs.PEAK_BF16) for lens in calls)
    return 100.0 * need / dev
