"""minitron-8b [dense]: pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000. Squared-ReLU MLP
(non-gated), as in the Nemotron-4 family.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    attn_type="full",
    mlp_type="relu2",
    stages=8, tp=2,             # 4 layers/stage; tp=2 halves per-device weights
    num_microbatches=16,  # §Perf: 1.84x vs nm4, temp 63->20GB
    subquadratic=False,
)
