"""granite-moe-1b-a400m [moe] [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, 32 experts top-8.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    attn_type="full",
    mlp_type="swiglu",
    num_experts=32,
    top_k=8,
    tie_embeddings=True,
    stages=8, tp=2,             # 3 layers/stage; optional EP over tp
    num_microbatches=8,
    subquadratic=False,
)
