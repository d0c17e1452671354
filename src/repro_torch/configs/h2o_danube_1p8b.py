"""h2o-danube-1.8b [dense]: llama+mistral mix with SWA [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_type="swa",
    window_size=4096,
    mlp_type="swiglu",
    stages=8, tp=2,             # 3 layers/stage
    num_microbatches=8,
    subquadratic=True,          # SWA window bounds the KV working set
)
