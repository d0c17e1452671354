"""hymba-1.5b [hybrid]: parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Meta-tokens are stubbed off (systems-level reproduction; see DESIGN.md).
Most layers use SWA (window 1024); first/middle/last are global.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_type="hybrid_swa",
    window_size=1024,
    mlp_type="swiglu",
    ssm_type="ssd",
    ssm_state=16,
    ssm_expand=2,
    hybrid_parallel=True,
    stages=16, tp=1,            # 2 layers/stage
    num_microbatches=8,
    subquadratic=True,
)
