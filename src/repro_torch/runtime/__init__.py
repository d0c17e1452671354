"""repro_torch.runtime — the virtual workers, their device/host staging,
checkpoints and the deprecated trainer shims (the port of repro.runtime)."""
