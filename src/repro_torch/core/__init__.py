"""repro_torch.core — the WSP protocol, the parameter server, the wave step
and the analytic partitioner / allocator (the port of repro.core)."""
