"""gemma3-1b [dense]: 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144. Local window 512,
local rope theta 10k, global theta 1M. Sandwich norms, GeGLU, embed scaling.
26 layers -> 4 stages x 7 slots = 28 (2 masked pad slots; see DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attn_type="local_global",
    window_size=512,
    local_global_ratio=5,
    qk_norm=True,
    norm_style="rms_sandwich",
    mlp_type="geglu",
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    stages=4, tp=4,             # 4 q heads -> 1/dev; kv head replicated over tp
    num_microbatches=8,
    subquadratic=True,          # 5/6 layers windowed; global-layer KV seq-sharded at 500k
)
