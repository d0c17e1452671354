"""Weights and deltas between a worker's device and the parameter server's
host memory, one flat copy each way.

A virtual worker's params, grads, optimizer state and deltas live on its
device; the parameter server keeps w_global as host numpy f32. Once a wave
the deltas go to the host and (every pull_every waves) w_global comes back.
Copying leaf by leaf would issue hundreds of small transfers a wave;
HostStaging instead gathers the leaves (in jax.tree order) into one flat
device buffer and moves it in a single copy to or from pinned host memory,
and times both directions (`d2h_s`, `h2d_s`: host seconds of the last
copy, the caller's stream synchronized before the clock starts).

The host side of to_host() is a view of a staging buffer that the next-
but-one to_host() overwrites: two buffers alternate, so an async push may
still be reading one wave's deltas while the worker stages the next.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import tree as tree_lib


class HostStaging:
    def __init__(self, template, device):
        """template: a tree of tensors (or arrays) with the shapes to
        stage; device: where the worker's tensors live."""
        self.device = torch.device(device)
        named = tree_lib.flatten_with_path(template)
        self.shapes = [tuple(l.shape) for _, l in named]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()
        self.skeleton = tree_lib.tree_map(lambda _: 0, template)
        n = self.offsets[-1]
        cuda = self.device.type == "cuda"
        self._out = [torch.empty(n, dtype=torch.float32, pin_memory=cuda)
                     for _ in range(2)]
        self._in = torch.empty(n, dtype=torch.float32, pin_memory=cuda)
        # the device-side flat buffer (the host buffers serve on the CPU)
        self._dev = torch.empty(n, dtype=torch.float32, device=self.device) \
            if cuda else None
        self._turn = 0
        self.d2h_s = 0.0
        self.h2d_s = 0.0

    @property
    def nbytes(self) -> int:
        return self.offsets[-1] * 4

    def _sync(self):
        """Wait for this thread's work on the device (its current stream)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _views(self, flat: np.ndarray) -> list:
        return [flat[a:b].reshape(s) for a, b, s in
                zip(self.offsets[:-1], self.offsets[1:], self.shapes)]

    def to_host(self, tree):
        """A tree of host numpy f32 views of `tree`'s values (tensors on
        the device). Trees of numpy arrays pass through unchanged."""
        leaves = tree_lib.leaves(tree)
        if not any(isinstance(l, torch.Tensor) for l in leaves):
            return tree
        self._sync()
        t0 = time.monotonic()
        host = self._out[self._turn]
        self._turn ^= 1
        flat = [l.detach().reshape(-1).float() for l in leaves]
        if self._dev is None:
            torch.cat(flat, out=host)
        else:
            torch.cat(flat, out=self._dev)
            host.copy_(self._dev)
        out = tree_lib.unflatten_like(self.skeleton,
                                      self._views(host.numpy()))
        self.d2h_s = time.monotonic() - t0
        return out

    def to_device(self, host_tree, into):
        """Copy a tree of host arrays (w_global as the PS pulls it) into the
        device tensors of `into`, in place; returns `into`."""
        self._sync()
        t0 = time.monotonic()
        buf = self._in.numpy()
        for v, a in zip(self._views(buf), tree_lib.leaves(host_tree)):
            v[...] = a
        src = self._in
        if self._dev is not None:
            self._dev.copy_(self._in)
            src = self._dev
        with torch.no_grad():
            for t, a, b in zip(tree_lib.leaves(into), self.offsets[:-1],
                               self.offsets[1:]):
                t.copy_(src[a:b].view(t.shape))
        self._sync()
        self.h2d_s = time.monotonic() - t0
        return into


def device_tree(tree, device, dtype=torch.float32):
    """Fresh `dtype` tensors on `device` with the shapes and values of
    `tree`'s leaves (host arrays or tensors); never aliases them."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=device, dtype=dtype, copy=True)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)
    return tree_lib.tree_map(one, tree)


def add_(params, deltas):
    """params += deltas in place, on the params' device (deltas may be
    tensors or host arrays)."""
    with torch.no_grad():
        for p, d in zip(tree_lib.leaves(params), tree_lib.leaves(deltas)):
            p.add_(torch.as_tensor(d, device=p.device, dtype=p.dtype))
    return params
