"""granite-4.0-h-small [hybrid moe] [hf:ibm-granite/granite-4.0-h-small].

40L d_model=4096: 36 Mamba-2 layers (128 heads of 64, state 128, one
group, conv 4 with bias, expand 2) and 4 GQA NoPE attention layers (32
query / 8 KV heads of 128) at 5, 15, 25, 35; after every layer 72 routed
SwiGLU experts of 768 (top-10) and a shared SwiGLU expert of 1536; vocab
100352 tied. The granite multipliers (embedding, attention, residual,
logits) are not applied, as for granite-moe-1b-a400m.

ARCH holds every expert; a card of the two-card expert-parallel
deployment holds half of them (experts_held=36, expert_offset 0 or 36)
and runs the rest of each layer whole.
"""
from repro_torch.configs.base import ArchConfig

MAMBA_EVERY = 10        # one attention layer in each period of 10, at 5

ARCH = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    attn_type="full",
    mlp_type="swiglu",
    norm_eps=1e-5,
    ssm_type="ssd",
    ssm_state=128,
    ssm_heads=128,
    ssm_expand=2,
    ssm_conv_bias=True,
    ssm_gate_norm=True,
    layer_types=tuple("attention" if i % MAMBA_EVERY == 5 else "mamba"
                      for i in range(40)),
    pos_emb="nope",
    num_experts=72,
    top_k=10,
    shared_ff=1536,
    tie_embeddings=True,
    stages=1, tp=1,
    num_microbatches=1,
    subquadratic=True,
)
