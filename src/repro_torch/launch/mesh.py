"""Logical meshes (the port of repro.launch.mesh).

A Mesh names a torch device for every slot of a (data, stage, tp) grid, or
(pod, data, stage, tp), or the production (data, model) grid. The spmd
backend (core.wave) runs it from one process: every slot's work is issued
by this controller onto the slot's device, and the JAX package's
collectives become tensor ops over the slots' tensors (a psum over tp is a
sum of the shards' partials on the stage's device, a ppermute over stage
is a move to the next stage's device).

Slots are laid out row-major with tp innermost, JAX's device order. When
there are fewer devices than slots, the devices wrap round-robin over the
slots (ROADMAP trap Y1): this is the port's counterpart of JAX's
`--xla_force_host_platform_device_count`, with one difference — slots
that share a device share its memory, and a tensor's `.to(slot)` between
them is a no-op rather than a copy.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An ndarray of torch devices with named axes. `shape` maps each axis
    name to its size, in axis order (as jax's Mesh.shape)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def physical(self) -> list:
        """The distinct devices behind the slots, in slot order."""
        return list(dict.fromkeys(self.devices.ravel().tolist()))

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}; {len(self.physical())} device(s))"


def _devices(devices) -> list:
    """The physical devices slots wrap over: None means every visible CUDA
    device (and raises without one: the CPU is only ever asked for); a
    device or a name means that one; a sequence means those."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh_auto lays slots over the CUDA devices by default "
                "and torch sees none; pass devices='cpu' to build a mesh of "
                "CPU slots")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_mesh_auto(shape, names, devices=None) -> Mesh:
    """A mesh of `shape` over `names`: slot i (row-major, the last axis
    innermost) is device i mod len(devices) — every slot its own device
    when there are enough, else the devices wrap (trap Y1)."""
    devs = _devices(devices)
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = devs[i % len(devs)]
    return Mesh(grid.reshape(tuple(shape)), names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, devices)


def make_logical_mesh(prod: Mesh, stages: int, tp: int) -> Mesh:
    """Split the production mesh's `model` axis into (stage, tp), keeping
    the slot order (tp innermost, as the JAX package keeps tp groups on
    adjacent devices)."""
    model = prod.shape["model"]
    assert stages * tp == model, (stages, tp, model)
    devs = prod.devices
    return Mesh(devs.reshape(devs.shape[:-1] + (stages, tp)),
                prod.axis_names[:-1] + ("stage", "tp"))


def make_test_mesh(data: int = 2, stages: int = 2, tp: int = 2,
                   devices: Optional[object] = None) -> Mesh:
    """A small (data, stage, tp) mesh; on the CPU pass devices='cpu' (the
    slots then share the one CPU device)."""
    return make_mesh_auto((data, stages, tp), ("data", "stage", "tp"),
                          devices)
