"""musicgen-medium [audio]: decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048. The EnCodec/codebook
frontend is a stub: input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attn_type="full",
    norm_style="ln_pre",
    mlp_type="gelu",
    frontend="audio_stub",
    stages=16, tp=1,            # 3 layers/stage, no padding
    num_microbatches=8,
    subquadratic=False,
)
