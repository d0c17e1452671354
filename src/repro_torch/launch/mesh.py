"""Logical meshes (the port of repro.launch.mesh).

A Mesh names a torch device for every slot of a (data, stage, tp) grid, or
(pod, data, stage, tp), or the production (data, model) grid. The spmd
backend (core.wave) runs it from one process: every slot's work is issued
by this controller onto the slot's device, and the JAX package's
collectives become tensor ops over the slots' tensors, named here: `psum`
(a psum over tp is a sum of the shards' partials on the stage's device),
`pmax`, `pmean`, `ppermute` (over stage: a move to the next stage's
device) and `all_to_all` (the expert-parallel exchange). Each does exactly
those tensor ops and, when a cost counter is active (launch.costs), also
reports its kind, axis, axis size and payload bytes. `slot(...)` scopes
the work issued for one (data, stage, tp) slot for the counter; with no
counter both cost one global read.

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

from repro_torch import obs
from repro_torch.launch import costs
from repro_torch.launch.costs import slot  # noqa: F401  (re-exported)
from repro_torch.obs import trace as obs_trace


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


# ----------------------------------------------------------------------------
# the dry run's symmetry shortcut
# ----------------------------------------------------------------------------
def issued_data_slots(n: int) -> int:
    """How many of a step's n data slots it issues: all of them, unless the
    active cost counter reckons the others by symmetry (launch.dryrun)."""
    c = costs._ACTIVE
    if c is None or c.data_slots is None or n <= c.data_slots:
        return n
    c.reckoned_from = n               # the counter reckons the rest
    return c.data_slots


def stand_in(t):
    """An empty tensor like `t`, neither counted nor charged: the output of
    a data slot the active counter reckons by symmetry."""
    with costs._ACTIVE.uncounted():
        return torch.empty_like(t, requires_grad=False)


# ----------------------------------------------------------------------------
# collectives over the slots' tensors
# ----------------------------------------------------------------------------
def _report(kind, axis, n, t):
    if costs._ACTIVE is not None:
        costs.collective(kind, axis, n, t.numel() * t.element_size())


def psum(parts, device, *, axis: str, n: Optional[int] = None):
    """The psum over `axis`: the partials added on `device`, in order
    (parts[0] moved there, then each next one moved and added). `n` is
    the axis size when the parts are not one per member (default: their
    count); the payload reported is one partial's bytes."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    _report("psum", axis, len(parts) if n is None else n, parts[0])
    return out


def pmean(parts, device, *, axis: str):
    """The pmean over `axis`: psum's sum, divided by the member count."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    _report("pmean", axis, len(parts), parts[0])
    return out / len(parts)


def pmax(parts, *, axis: str):
    """The pmax over `axis`: the elementwise maximum of the parts, in
    order, where they lie."""
    out = parts[0]
    for part in parts[1:]:
        out = torch.maximum(out, part)
    _report("pmax", axis, len(parts), parts[0])
    return out


def ppermute(x, device, *, axis: str, n: int):
    """One member's send of a ppermute over `axis` (size `n`): x moved to
    the receiver's device. The send is a `pp_send` span (`dir="act"`) in
    the thread's bound scope (obs.span), and under autograd so is the
    gradient's send back in backward (`dir="grad"`): host time, the
    copy's enqueue and any wait inside it."""
    _report("ppermute", axis, n, x)
    with obs.span("pp_send", dir="act"):
        if torch.is_grad_enabled() and x.requires_grad:
            return _Send.apply(x, device, obs_trace.current_scope())
        return x.to(device)


class _Send(torch.autograd.Function):
    """x.to(device) whose backward, the gradient's send back to x's device,
    is a `pp_send` span in the scope bound at the send: autograd runs the
    backward on threads of its own."""

    @staticmethod
    def forward(ctx, x, device, scope):
        ctx.src, ctx.scope = x.device, scope
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        with obs_trace.span_in(ctx.scope, "pp_send", dir="grad"):
            return g.to(ctx.src), None, None


def all_to_all(xs, devices, *, axis: str, split_axis: int,
               concat_axis: int):
    """jax.lax.all_to_all over a list of members: member j receives chunk j
    of every member's x along `split_axis`, concatenated along
    `concat_axis` in the senders' order, on devices[j]."""
    n = len(xs)
    chunks = [x.chunk(n, dim=split_axis) for x in xs]
    _report("all_to_all", axis, n, xs[0])
    return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)],
                      dim=concat_axis) for j in range(n)]
