"""qwen3-0.6b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-0.6B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,               # qwen3 uses head_dim 128 (16*128 != d_model; q/o proj rectangular)
    d_ff=3072,
    vocab_size=151936,
    attn_type="full",
    qk_norm=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    stages=4, tp=4,             # 7 layers/stage, heads 4/dev, kv 2/dev
    num_microbatches=16,  # §Perf: nm16 cuts bubble 1.375->1.19
    subquadratic=False,
)
