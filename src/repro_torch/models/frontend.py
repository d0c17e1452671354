"""Modality frontend stubs for [audio] / [vlm] architectures (the port of
repro.models.frontend).

These architectures specify the transformer BACKBONE only; the EnCodec /
VQ-VAE frontends are stubs that produce precomputed frame/patch
embeddings. Runnable examples synthesize them from an explicit
torch.Generator on the caller's device (the JAX package draws from
jax.random, which torch cannot reproduce: parity tests pass embeddings
across as numpy).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def stub_embeddings(cfg: ArchConfig, generator: torch.Generator, batch: int,
                    seq_len: int, dtype=torch.float32):
    """Deterministic stand-in for frontend output: [B, S, d_model] on the
    generator's device."""
    x = torch.randn((batch, seq_len, cfg.d_model), generator=generator,
                    device=generator.device)
    return (0.02 * x).to(dtype)


def stub_labels(cfg: ArchConfig, generator: torch.Generator, batch: int,
                seq_len: int):
    """[B, S] int32 labels in [0, vocab) on the generator's device."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)
