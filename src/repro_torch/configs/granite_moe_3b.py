"""granite-moe-3b-a800m [moe] [hf:ibm-granite/granite-3.0-3b-a800m-base].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, 40 experts top-8.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    attn_type="full",
    mlp_type="swiglu",
    num_experts=40,
    top_k=8,
    tie_embeddings=True,
    stages=16, tp=1,            # 2 layers/stage
    num_microbatches=8,
    subquadratic=False,
)
