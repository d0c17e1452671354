"""Host-level emulation of the collectives the SPMD path would run on device
(the port of repro.dist.collectives).

Each collective takes one tree per participating worker (nested dicts of
numpy arrays or tensors), actually executes the algorithm's communication
schedule on numpy buffers (chunked ring reduce-scatter / all-gather,
pod-hierarchical reduce), and returns

    (reduced_tree, predicted_seconds)

where the cost comes from a ClusterTopology alpha-beta model (0.0 when no
topology is given). Trees flatten in jax.tree order (`core.tree`), so the
vectors, their chunks and the summation order are the JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import tree as tree_lib


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):              # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# -- tree <-> flat vector -------------------------------------------------

def _stack_flat(trees):
    """Flatten each worker's tree into one float32 vector; all trees must
    share a structure. Returns (vectors, spec) for _unflatten."""
    assert trees, "need at least one worker tree"
    leaves0 = [_host(l) for l in tree_lib.leaves(trees[0])]
    paths0 = [p for p, _ in tree_lib.flatten_with_path(trees[0])]
    shapes = [l.shape for l in leaves0]
    dtypes = [l.dtype for l in leaves0]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    vecs = []
    for t in trees:
        named = tree_lib.flatten_with_path(t)
        assert [p for p, _ in named] == paths0, \
            "workers disagree on tree structure"
        if named:
            # concatenate copies once; f32 leaves are not copied before it
            vecs.append(np.concatenate(
                [np.asarray(_host(l), np.float32).ravel()
                 for _, l in named]))
        else:
            vecs.append(np.zeros(0, np.float32))
    return vecs, (trees[0], shapes, dtypes, sizes)


def _unflatten(vec, spec):
    template, shapes, dtypes, sizes = spec
    out, off = [], 0
    for sh, dt, sz in zip(shapes, dtypes, sizes):
        # views of `vec` (a fresh vector) where the dtype already matches
        out.append(vec[off:off + sz].reshape(sh).astype(dt, copy=False))
        off += sz
    return tree_lib.unflatten_like(template, out)


def _chunk_slices(n: int, W: int):
    bounds = np.linspace(0, n, W + 1).astype(np.int64)
    return [slice(int(bounds[c]), int(bounds[c + 1])) for c in range(W)]


# -- ring schedule --------------------------------------------------------

def ring_reduce_scatter(vectors: list[np.ndarray]) -> list[np.ndarray]:
    """Run the W-1-step ring reduce-scatter schedule; returns the W summed
    chunks (chunk c fully reduced, as held by its final owner)."""
    W = len(vectors)
    if W == 1:
        return [vectors[0].copy()]
    n = vectors[0].size
    sl = _chunk_slices(n, W)
    acc = [v.astype(np.float32).copy() for v in vectors]
    for step in range(W - 1):
        # worker i sends chunk (i - step) mod W to its ring successor; stage
        # all sends first so a step's transfers are simultaneous
        staged = [(i, (i - step) % W, acc[i][sl[(i - step) % W]].copy())
                  for i in range(W)]
        for i, c, data in staged:
            acc[(i + 1) % W][sl[c]] += data
    # after W-1 hops chunk c has been fully accumulated at worker (c-1) mod W
    return [acc[(c - 1) % W][sl[c]] for c in range(W)]


def ring_all_gather(chunks: list[np.ndarray]) -> np.ndarray:
    """All-gather of the reduced chunks (every worker ends with the concat;
    the schedule is W-1 forwarding steps — data-independent, so we return
    the concatenation directly)."""
    return np.concatenate([np.asarray(c, np.float32) for c in chunks])


def _worker_names(topology, workers, W):
    if workers is not None:
        assert len(workers) == W, (len(workers), W)
        return list(workers)
    if topology is not None:
        names = topology.worker_names()
        assert len(names) >= W, "topology has fewer workers than trees"
        return names[:W]
    return [f"vw{i}" for i in range(W)]


# -- public collectives ---------------------------------------------------

def ring_allreduce(trees, *, topology=None, workers=None,
                   average: bool = False):
    """Bandwidth-optimal ring all-reduce over one tree per worker.

    Returns (tree, seconds): the element-wise sum (or mean) as numpy arrays
    in the first worker's dtypes, plus the topology-predicted time (0.0
    untimed).
    """
    vecs, spec = _stack_flat(trees)
    W = len(vecs)
    names = _worker_names(topology, workers, W)
    total = ring_all_gather(ring_reduce_scatter(vecs))
    if average:
        total = total / np.float32(W)
    nbytes = total.nbytes
    cost = (topology.ring_allreduce_cost(names, nbytes)
            if topology is not None else 0.0)
    return _unflatten(total, spec), cost


def hierarchical_allreduce(trees, *, topology=None, workers=None,
                           average: bool = False):
    """Pod-local ring reduce, then a cross-pod ring over pod leaders, then
    pod-local broadcast — the full vector crosses the slow inter-pod tier
    only 2(P-1)/P times. With no topology it degenerates to one pod."""
    vecs, spec = _stack_flat(trees)
    W = len(vecs)
    names = _worker_names(topology, workers, W)
    if topology is None:
        groups = {"pod0": list(range(W))}
    else:
        groups = {}
        for i, w in enumerate(names):
            groups.setdefault(topology._resolve(w).name, []).append(i)
    # stage 1: pod-local ring reduce to one partial sum per pod
    partials = []
    for idxs in groups.values():
        partials.append(ring_all_gather(
            ring_reduce_scatter([vecs[i] for i in idxs])))
    # stage 2: leader ring across pods (broadcast back is data-identical)
    total = ring_all_gather(ring_reduce_scatter(partials))
    if average:
        total = total / np.float32(W)
    nbytes = total.nbytes
    cost = (topology.hierarchical_allreduce_cost(names, nbytes)
            if topology is not None else 0.0)
    return _unflatten(total, spec), cost
