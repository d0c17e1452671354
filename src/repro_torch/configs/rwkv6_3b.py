"""rwkv6-3b [ssm]: Finch, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536. 40 wkv heads x 64.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    attn_type="none",
    mlp_type="relu2",           # rwkv channel-mix uses squared relu
    ssm_type="rwkv6",
    ssm_state=64,               # head_dim of the wkv state (64x64 per head)
    ssm_heads=40,
    stages=16, tp=1,            # 2 layers/stage
    num_microbatches=8,
    subquadratic=True,          # O(1) recurrent state
)
