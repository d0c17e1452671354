"""Config system: architecture, shape, mesh, WSP and run configs.

Every assigned architecture is a frozen ``ArchConfig``; input-shape cells are
``ShapeConfig``s. The cross product (arch x shape) defines the dry-run cells.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool (exact public-literature config)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention pattern ---
    attn_type: str = "full"         # full | swa | local_global | none
    window_size: int = 0            # swa / local-layer window
    local_global_ratio: int = 0     # e.g. 5 -> 5 local : 1 global (gemma3)
    qk_norm: bool = False
    norm_style: str = "rms_pre"     # rms_pre | rms_sandwich | ln_pre
    mlp_type: str = "swiglu"        # swiglu | geglu | gelu | relu2
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # local_global: separate theta for global layers
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scaling

    # --- SSM / hybrid ---
    ssm_type: str = ""              # "" | rwkv6 | ssd
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 -> derived (d_inner // 64)
    ssm_expand: int = 2             # d_inner = ssm_expand * d_model (ssd)
    hybrid_parallel: bool = False   # hymba: attn + ssm branches in parallel

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- modality frontend ---
    frontend: str = "none"          # none | audio_stub | vlm_stub (input = embeddings)

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- mesh mapping: model axis (16) = stages x tp ---
    stages: int = 16
    tp: int = 1
    # pipeline knobs
    num_microbatches: int = 4       # Nm (wave size); partitioner may lower it
    remat: bool = True              # recompute stage activations in backward
    # long_500k applicability (sub-quadratic attention available?)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def check_production(self, model_axis: int = 16) -> None:
        assert self.stages * self.tp == model_axis, (
            f"{self.name}: stages*tp must equal the model-axis size {model_axis}")

    # ---- derived sizes -------------------------------------------------
    @property
    def layer_slots(self) -> int:
        """Per-stage layer slots (padded so every stage runs the same program)."""
        return math.ceil(self.num_layers / self.stages)

    @property
    def padded_layers(self) -> int:
        return self.layer_slots * self.stages

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // 64)

    def layer_kinds(self) -> list[int]:
        """Per-layer attention kind: 0=full, 1=windowed, 2=none (pure ssm)."""
        kinds = []
        for i in range(self.padded_layers):
            if self.attn_type == "none":
                kinds.append(2)
            elif self.attn_type == "swa":
                kinds.append(1)
            elif self.attn_type == "local_global":
                r = self.local_global_ratio
                kinds.append(0 if (i % (r + 1)) == r else 1)
            elif self.attn_type == "hybrid_swa":
                # hymba: first, middle, last layers full; rest windowed
                full = {0, self.num_layers // 2, self.num_layers - 1}
                kinds.append(0 if i in full else 1)
            else:
                kinds.append(0)
        return kinds

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # head
        per_layer = 0
        if self.num_heads > 0:
            per_layer += d * self.num_heads * hd      # wq
            per_layer += 2 * d * self.num_kv_heads * hd
            per_layer += self.num_heads * hd * d      # wo
        if self.ssm_type == "ssd":
            di = self.d_inner
            per_layer += d * 2 * di + di * d          # in/out proj
            per_layer += di * 2 * self.ssm_state * 2  # B,C proj (approx)
        if self.ssm_type == "rwkv6":
            per_layer += 4 * d * d + 2 * d * 64       # r,k,v,o + decay lora
        if self.num_experts:
            gated = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            per_layer += self.num_experts * (d * ff * gated + ff * d)
            per_layer += d * self.num_experts         # router
        else:
            gated = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            per_layer += d * ff * gated + ff * d
        per_layer += 4 * d                            # norms
        return n + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        gated = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        inactive = (self.num_experts - self.top_k) * (d * ff * gated + ff * d)
        return self.param_count() - L * inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class WSPConfig:
    """Wave Synchronous Parallel knobs (paper Sections 4-5)."""

    staleness_D: int = 0            # global clock-distance bound
    schedule: str = "gpipe"         # gpipe (wave-flush) | 1f1b (continuous injection)
    sync_mode: str = "allreduce"    # allreduce (SPMD D=0) | ps (host-level, D>=0)
    hierarchical: bool = True       # pod-local reduce before cross-pod
    compression: str = "none"       # none | topk
    compression_ratio: float = 0.01
    zero1: bool = False             # shard optimizer state over data axis


@dataclass(frozen=True)
class RunConfig:
    arch: "ArchConfig"
    shape: "ShapeConfig"
    wsp: WSPConfig = field(default_factory=WSPConfig)
    multi_pod: bool = False
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = ""           # "" -> compute_dtype; "f8" halves KV traffic
    # which implementation runs the hot-path attention mixes:
    # "ref" = plain torch, "cuda" = the repro_torch.kernels Hopper kernels
    kernel_backend: str = "ref"
    # software-pipelined (skewed) schedule: issue the boundary-activation
    # ppermute of tick t concurrently with tick t+1's stage compute
    overlap: bool = False
    seed: int = 0
    loss_chunk: int = 512           # vocab-chunked CE chunk along seq

    @property
    def num_vw(self) -> int:
        return 16 * (2 if self.multi_pod else 1)

    @property
    def vw_batch(self) -> int:
        assert self.shape.global_batch % 16 == 0 or self.shape.global_batch == 1
        return max(1, self.shape.global_batch // 16)


def reduced(arch: ArchConfig, **over) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=4, d_model=64, d_ff=128, vocab_size=256,
        num_heads=max(0, min(arch.num_heads, 4)),
        num_kv_heads=max(0, min(arch.num_kv_heads, 2)),
        head_dim=16 if arch.num_heads else 0,
        stages=2, tp=1, num_microbatches=2,
        window_size=min(arch.window_size, 32) if arch.window_size else 0,
        ssm_state=min(arch.ssm_state, 8) if arch.ssm_state else 0,
        ssm_heads=2 if arch.ssm_type else 0,
        num_experts=min(arch.num_experts, 4) if arch.num_experts else 0,
        top_k=min(arch.top_k, 2) if arch.top_k else 0,
    )
    small.update(over)
    return dataclasses.replace(arch, **small)
