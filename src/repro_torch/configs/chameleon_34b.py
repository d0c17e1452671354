"""chameleon-34b [vlm]: early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ-VAE image
frontend is a stub: input_specs() provides precomputed patch/token embeddings.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    attn_type="full",
    qk_norm=True,               # chameleon stabilizes with qk-norm
    mlp_type="swiglu",
    frontend="vlm_stub",
    stages=8, tp=2,             # 6 layers/stage; tp=2 for per-device weight fit
    num_microbatches=4,
    subquadratic=False,
)
