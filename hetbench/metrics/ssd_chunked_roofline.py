"""ssd_chunked's share of its roofline in the traced slice (%): the least
time the admitted prompts' SSD scans need in every Mamba layer (the
family's ssd_bound_s: its ssd_chunked cost on the real lengths, float32)
over the profiled device time of the SSD kernels, padding included.
Nothing to read for a family without Mamba layers."""
from hetbench import profiling

KERNELS = ("ssd_tile_kernel", "ssd_kernel")


def read(run):
    if run.kind != "serve" or run.prof is None \
            or not hasattr(run.family, "ssd_bound_s"):
        return None
    dev = profiling.kernel_seconds(run.prof["by_name"], KERNELS)
    calls = run.prof_calls[0]
    if dev <= 0 or not calls:
        return None
    need = sum(run.family.ssd_bound_s(run.z, [int(L) for L in lens])
               for lens in calls)
    return 100.0 * need / dev
