"""repro_torch — the PyTorch + CUDA port of the HetPipe reproduction.

It grows beside the JAX package `repro`, mirroring its sub-packages
(configs, kernels, models, serve, obs, api, launch), and imports neither
`repro` nor `jax`. This slice serves the dense GQA family on one NVIDIA
H100: the continuous-batching Scheduler over a paged KV pool
(`repro_torch.api.serving`), with the prefill and decode attention in
hand-written Hopper kernels (`repro_torch.kernels`).
"""
