"""Named serve presets: one-line access to the canonical serve scenarios
(the serve presets of repro.api.presets, over the same tiny config).

    from repro_torch.api import Engine, get_preset
    report = Engine(get_preset("serve_tiny")).generate()

get_preset forwards keyword overrides through Plan.replace (double
underscores reach nested specs: get_preset("serve_paged",
serve__max_pages=16)).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.plan import Plan, ServeSpec

PRESETS: dict[str, Callable[[], Plan]] = {}


def preset(name: str):
    def deco(fn: Callable[[], Plan]):
        PRESETS[name] = fn
        return fn
    return deco


def list_presets() -> dict[str, str]:
    """name -> first docstring line."""
    return {n: (fn.__doc__ or "").strip().splitlines()[0]
            for n, fn in PRESETS.items()}


def get_preset(name: str, **overrides) -> Plan:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    plan = PRESETS[name]()
    return plan.replace(**overrides) if overrides else plan


def _tiny_arch(name: str = "qwen3-0.6b", **over):
    """qwen3-0.6b cut down to 2 layers and width 32 (repro's _tiny_arch)."""
    from repro_torch.configs import ARCHS, reduced
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_heads=2, num_kv_heads=2, head_dim=16,
                num_microbatches=2)
    base.update(over)
    return reduced(ARCHS[name], **base)


@preset("serve_tiny")
def serve_tiny() -> Plan:
    """Batched greedy serving on the plain path (prefill + decode through
    Engine.generate(), or continuous batching via repro_torch.api.serving)."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4))


@preset("serve_paged")
def serve_paged() -> Plan:
    """Paged-KV continuous batching: 4-token pages from a pool sized below
    the worst case."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, max_pages=12))


@preset("serve_kernels")
def serve_kernels() -> Plan:
    """Paged continuous batching on the Hopper kernels: decode walks the KV
    pool through the block table inside flash_decode_paged, prefill runs
    flash_attention_fwd (their plain versions on CPU tensors)."""
    return Plan(arch=_tiny_arch(),
                serve=ServeSpec(prompt_len=8, gen=8, max_batch=4,
                                page_size=4, max_pages=12,
                                kernel_backend="cuda"))
