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
    ssm_conv_bias: bool = False     # Mamba-2: the depthwise conv has a bias
    ssm_gate_norm: bool = False     # Mamba-2's gated norm: y * silu(z) is
                                    # normed (hymba: norm(y) * silu(z))
    # per-layer mixer kinds ("attention" | "mamba"), one per layer; () keeps
    # one kind in every layer (attn_type / hybrid_parallel decide it). A
    # mixed-kind model stacks each kind's leaves over its own layers only
    layer_types: tuple = ()
    pos_emb: str = "rope"           # rope | nope (no position embedding)

    # --- MoE ---
    num_experts: int = 0            # routed over (the router's outputs)
    top_k: int = 0
    capacity_factor: float = 1.25
    experts_held: int = 0           # this card's share: experts
    expert_offset: int = 0          # [offset, offset + held) of num_experts
                                    # are held here (0: all of them)
    shared_ff: int = 0              # a shared SwiGLU expert's width (0: none)

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
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.layer_types and len(self.layer_types) != self.num_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} "
                             f"layer_types for {self.num_layers} layers")
        if set(self.layer_types) - {"attention", "mamba"}:
            raise ValueError(f"{self.name}: layer_types are 'attention' or "
                             f"'mamba', got {sorted(set(self.layer_types))}")
        if self.pos_emb not in ("rope", "nope"):
            raise ValueError(f"{self.name}: pos_emb {self.pos_emb!r}")
        if self.expert_offset + self.held_experts > self.num_experts:
            raise ValueError(f"{self.name}: experts [{self.expert_offset}, "
                             f"{self.expert_offset + self.held_experts}) "
                             f"outside the {self.num_experts} routed over")

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
    def held_experts(self) -> int:
        """Experts whose weights this card holds (all unless cut)."""
        return self.experts_held or self.num_experts

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // 64)

    def layer_kinds(self) -> list[int]:
        """Per-layer attention kind: 0=full, 1=windowed, 2=none (pure ssm;
        a mixed-kind model's Mamba-2 layers)."""
        kinds = []
        for i in range(self.padded_layers):
            if self.layer_types:
                kinds.append(2 if i < self.num_layers
                             and self.layer_types[i] == "mamba" else 0)
            elif self.attn_type == "none":
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
        """Analytic parameter count (embedding + blocks + head), by layer
        kind for a mixed-kind model. The ten configs the JAX package
        shares keep its count (its SSD term approximates the hybrid's
        projections; every layer of theirs has one kind)."""
        n = self.vocab_size * self.d_model             # embed
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size        # head
        if not self.layer_types:
            return n + self.num_layers * self._legacy_layer_params()
        ffn = self._ffn_params(self.held_experts) + 2 * self.d_model
        return n + sum(ffn + self._mixer_params(t) for t in self.layer_types)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        gated = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        inactive = (self.held_experts - self.top_k) * (d * ff * gated
                                                      + ff * d)
        return self.param_count() - L * inactive

    def _legacy_layer_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        hd = self.head_dim
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
        per_layer += self._ffn_params(self.num_experts)
        per_layer += 4 * d                            # norms
        return per_layer

    def _ffn_params(self, experts: int) -> int:
        """A layer's FFN: `experts` routed experts and the router (or the
        dense MLP), and the shared expert."""
        d, ff = self.d_model, self.d_ff
        gated = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        if not self.num_experts:
            return d * ff * gated + ff * d
        n = experts * (d * ff * gated + ff * d) + d * self.num_experts
        return n + 3 * d * self.shared_ff

    def _mixer_params(self, kind: str) -> int:
        """One layer's mixer: GQA attention, or a Mamba-2 mixer (in_proj to
        z, x, B, C and dt; the depthwise conv of x, B, C with its bias;
        dt_bias, A_log, D; the gated norm; out_proj)."""
        d, hd = self.d_model, self.head_dim
        if kind == "attention":
            return 2 * d * (self.num_heads + self.num_kv_heads) * hd
        di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
        conv = di + 2 * N
        return (d * (di + conv + H) + 4 * conv
                + conv * self.ssm_conv_bias + 3 * H + di + di * d)


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
