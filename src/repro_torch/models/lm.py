"""Model assembly: parameter init and sharding specs, per-layer metadata,
the weight carrier from the JAX package, the loss, the shard views and
stage application of the spmd pipeline (core.wave), and the plain
(non-pipelined) forward.

Parameter layout (the JAX package's): block leaves are stacked over all
layers on dim 0 with `padded_layers = stages * layer_slots` slots; the
same leaf names, the same stacking, so a JAX param tree carries over leaf
for leaf (`params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (LayerCtx, apply_layer,
                                       apply_layer_tp)
from repro_torch.models.layers import (chunked_cross_entropy, layer_norm,
                                       rms_norm)
# the cache's layout lives in serve.cache; the JAX package's lm names stay
from repro_torch.serve.cache import (cache_struct, init_cache,  # noqa: F401
                                     serve_dtypes)


def padded_vocab(cfg: ArchConfig, mult: int = 16) -> int:
    """Vocab padded to a multiple of 16 (the JAX package's sharding pad);
    logits_ref drops the padded columns."""
    return (cfg.vocab_size + mult - 1) // mult * mult


# ----------------------------------------------------------------------------
# Layer metadata
# ----------------------------------------------------------------------------
def layer_meta(cfg: ArchConfig) -> dict:
    """Per-slot arrays, shaped [stages, slots]."""
    kinds = np.array(cfg.layer_kinds(), np.int32)
    Lp = cfg.padded_layers
    valid = np.arange(Lp) < cfg.num_layers
    kinds = np.where(valid, kinds, 2 if cfg.ssm_type == "rwkv6" else 0)
    full_i = np.zeros(Lp, np.int32)
    win_i = np.zeros(Lp, np.int32)
    st, sl = cfg.stages, cfg.layer_slots
    m_full = m_win = 0
    for s in range(st):
        nf = nw = 0
        for j in range(sl):
            l = s * sl + j
            if valid[l] and kinds[l] == 0 and cfg.attn_type != "none":
                full_i[l] = nf
                nf += 1
            elif valid[l] and kinds[l] == 1:
                win_i[l] = nw
                nw += 1
        m_full, m_win = max(m_full, nf), max(m_win, nw)
    rs = lambda a: a.reshape(st, sl)
    return dict(kind=rs(kinds), valid=rs(valid), full_i=rs(full_i),
                win_i=rs(win_i), m_full=m_full, m_win=m_win)


def ssm_slots(cfg: ArchConfig) -> tuple[np.ndarray, int]:
    """(ssm_i [padded_layers], m_ssm): each layer's slot in its stage's
    group of the per-slot SSM state, and the group's size. Every layer of
    a one-kind model owns a slot (its index in the stage); a mixed-kind
    model's Mamba layers alone do, counted in each stage as full_i counts
    the attention layers."""
    sl, Lp = cfg.layer_slots, cfg.padded_layers
    if not cfg.layer_types:
        return np.arange(Lp) % sl, sl
    ssm_i, m = np.zeros(Lp, np.int64), 0
    for s in range(cfg.stages):
        n = 0
        for l in range(s * sl, min((s + 1) * sl, cfg.num_layers)):
            if cfg.layer_types[l] == "mamba":
                ssm_i[l] = n
                n += 1
        m = max(m, n)
    return ssm_i, m


def leaf_kind(cfg: ArchConfig, name: str) -> Optional[str]:
    """The layer kind a block leaf belongs to in a mixed-kind model
    ("attention" or "mamba": it is stacked over that kind's layers only),
    or None (every layer has it)."""
    if not cfg.layer_types:
        return None
    if name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
        return "attention"
    return "mamba" if name.startswith("ssd_") else None


def leaf_rows(cfg: ArchConfig, name: str) -> int:
    """A block leaf's stacked rows: every padded layer's, or the layers of
    the kind it belongs to."""
    kind = leaf_kind(cfg, name)
    return cfg.padded_layers if kind is None else \
        cfg.layer_types.count(kind)


def layer_leaves(cfg: ArchConfig, layers: dict, l: int) -> dict:
    """Layer l's leaves out of the per-layer lists `layers` (a stacked
    leaf unbound on dim 0): a kind's leaf is indexed by l's place among
    that kind's layers, and only where l is of that kind."""
    if not cfg.layer_types:
        return {k: v[l] for k, v in layers.items()}
    kind = cfg.layer_types[l]
    place = cfg.layer_types[:l].count(kind)
    out = {}
    for k, v in layers.items():
        lk = leaf_kind(cfg, k)
        if lk is None:
            out[k] = v[l]
        elif lk == kind:
            out[k] = v[place]
    return out


def uniform_kind(cfg: ArchConfig) -> Optional[int]:
    """Static layer kind if every (real) layer is identical, else None."""
    if cfg.num_layers % cfg.stages:
        return None
    return {"full": 0, "swa": 1, "none": 2}.get(cfg.attn_type)


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------
def _block_shapes(cfg: ArchConfig) -> dict[str, tuple[tuple, str]]:
    """Dense-, RWKV6-, SSD-hybrid- and MoE-family leaf -> (per-layer
    shape, init)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
    out: dict[str, tuple[tuple, str]] = {}

    if cfg.ssm_type == "rwkv6":
        Hs, hds = cfg.n_ssm_heads, d // cfg.n_ssm_heads
        out["ln1"] = ((d,), "zeros")
        out["ln2"] = ((d,), "zeros")
        for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            out[m] = ((d,), "half")
        for w in ("wr", "wk", "wv", "wg"):
            out[w] = ((d, d), "normal")
        out["wo"] = ((d, d), "normal_out")
        out["w0"] = ((d,), "w0")
        out["wa"] = ((d, 64), "zeros")
        out["wb"] = ((64, d), "zeros")
        out["u"] = ((Hs, hds), "half")
        out["gn_scale"] = ((d,), "ones")
        out["gn_bias"] = ((d,), "zeros")
        out["cm_mu_k"] = ((d,), "half")
        out["cm_mu_r"] = ((d,), "half")
        out["cm_k"] = ((d, ff), "normal")
        out["cm_v"] = ((ff, d), "normal_out")
        out["cm_r"] = ((d, d), "normal")
        return out

    def norm(name):
        out[name] = ((d,), "zeros" if "rms" in cfg.norm_style else "ones")
        if cfg.norm_style == "ln_pre":
            out[name + "_b"] = ((d,), "zeros")

    norm("ln1")
    out["wq"] = ((d, H * hd), "normal")
    out["wk"] = ((d, KV * hd), "normal")
    out["wv"] = ((d, KV * hd), "normal")
    out["wo"] = ((H * hd, d), "normal_out")
    if cfg.qk_norm:
        out["q_norm"] = ((hd,), "zeros")
        out["k_norm"] = ((hd,), "zeros")
    if cfg.norm_style == "rms_sandwich":
        out["ln1_post"] = ((d,), "zeros")
        out["ln2_post"] = ((d,), "zeros")
    norm("ln2")
    if cfg.num_experts:
        E = cfg.held_experts
        out["router"] = ((d, cfg.num_experts), "normal")
        out["moe_w_in"] = ((E, d, G, ff), "normal")
        out["moe_w_out"] = ((E, ff, d), "normal_out")
        if cfg.shared_ff:
            out["shared_wi"] = ((d, G, cfg.shared_ff), "normal")
            out["shared_wo"] = ((cfg.shared_ff, d), "normal_out")
    else:
        out["mlp_wi"] = ((d, G, ff), "normal")
        out["mlp_wo"] = ((ff, d), "normal_out")
    if cfg.hybrid_parallel or cfg.layer_types:
        di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        if cfg.hybrid_parallel:
            out["bn_attn"] = ((d,), "zeros")
            out["bn_ssm"] = ((d,), "zeros")
        if cfg.ssm_conv_bias:
            out["ssd_conv_b"] = ((di + 2 * N,), "zeros")
        out["ssd_in_proj"] = ((d, 2 * di + 2 * N + Hs), "normal")
        out["ssd_conv_w"] = ((4, di + 2 * N), "normal")
        out["ssd_dt_bias"] = ((Hs,), "dt_bias")
        out["ssd_A_log"] = ((Hs,), "a_log")
        out["ssd_D"] = ((Hs,), "ones")
        out["ssd_norm_scale"] = ((di,), "zeros")
        out["ssd_out_proj"] = ((di, d), "normal_out")
    return out


# the per-layer dim each block leaf splits over tp (the JAX package's
# PartitionSpecs, lm.py _block_shapes); every other leaf is whole
_TP_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "mlp_wi": 2, "mlp_wo": 0,
           "moe_w_in": 3, "moe_w_out": 1}


def param_specs(cfg: ArchConfig) -> dict:
    """The JAX package's sharding specs as plain tuples: per leaf, one entry
    per dim naming the mesh axis it is split over (None: whole). Block
    leaves split their stacked layer dim over "stage" and, when cfg.tp > 1,
    one dim over "tp" — wk / wv stay whole where KV % tp != 0 (trap Y3),
    RWKV6 splits none. The embed and head carry JAX's ("stage", "tp") vocab
    split, which only places them across devices; the port keeps both
    whole on the data slot's first device (the numbers are the same)."""
    tp = "tp" if cfg.tp > 1 else None
    kv_tp = tp if cfg.num_kv_heads and cfg.num_kv_heads % cfg.tp == 0 \
        else None
    blocks = {}
    for name, (shape, _) in sorted(_block_shapes(cfg).items()):
        spec = [None] * len(shape)
        dim = None if cfg.ssm_type == "rwkv6" else _TP_DIM.get(name)
        if dim is not None:
            spec[dim] = kv_tp if name in ("wk", "wv") else tp
        blocks[name] = ("stage",) + tuple(spec)
    if cfg.layer_types:
        raise ValueError(f"{cfg.name}: a mixed-kind model stacks each "
                         f"kind's leaves over its own layers, which the "
                         f"stage split of the spmd backend does not cut; "
                         f"it runs on the threads backend")
    specs = {"blocks": blocks, "final_norm": (None,)}
    if cfg.norm_style == "ln_pre":
        specs["final_norm_b"] = (None,)
    if cfg.frontend == "none":
        specs["embed"] = (("stage", "tp"), None)
    if not cfg.tie_embeddings:
        specs["head"] = (None, ("stage", "tp"))
    return specs


def param_shapes(cfg: ArchConfig, dtype=torch.float32):
    """Meta tensors matching init_params leaf for leaf (names, the
    [padded_layers, ...] stacking, dtypes): the dry run's stand-ins, no
    allocation."""
    def meta(shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {"blocks": {n: meta((leaf_rows(cfg, n),) + shp) for n, (shp, _)
                      in sorted(_block_shapes(cfg).items())},
           "final_norm": meta((cfg.d_model,))}
    if cfg.norm_style == "ln_pre":
        out["final_norm_b"] = meta((cfg.d_model,))
    Vp = padded_vocab(cfg)
    if cfg.frontend == "none":
        out["embed"] = meta((Vp, cfg.d_model))
    if not cfg.tie_embeddings:
        out["head"] = meta((cfg.d_model, Vp))
    return out


def _init_leaf(gen, shape, init, cfg: ArchConfig, dtype, device):
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "half":
        return torch.full(shape, 0.5, dtype=dtype, device=device)
    if init == "w0":
        return torch.full(shape, -5.0, dtype=dtype, device=device)
    if init == "dt_bias":
        return torch.full(shape, -4.6, dtype=dtype, device=device)
    if init == "a_log":     # log(1..16) over the heads, in every layer
        a = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return a.expand(shape).to(dtype).contiguous()
    scale = 0.02
    if init == "normal_out":
        scale = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (scale * x).to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                dtype=torch.float32, device="cpu"):
    """Random params with the JAX package's leaf names and [padded_layers,
    ...] stacking, drawn from `generator` (which must live on `device`).
    The draws differ from jax.random's; parity tests carry JAX's weights
    across with params_from_numpy instead."""
    shapes = _block_shapes(cfg)
    blocks = {name: _init_leaf(generator, (leaf_rows(cfg, name),) + shp,
                               init, cfg, dtype, device)
              for name, (shp, init) in sorted(shapes.items())}
    params = {"blocks": blocks,
              "final_norm": (torch.ones if cfg.norm_style == "ln_pre"
                             else torch.zeros)((cfg.d_model,), dtype=dtype,
                                               device=device)}
    if cfg.norm_style == "ln_pre":
        params["final_norm_b"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                             device=device)
    Vp = padded_vocab(cfg)
    if cfg.frontend == "none":
        params["embed"] = _init_leaf(generator, (Vp, cfg.d_model), "normal",
                                     cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = _init_leaf(generator, (cfg.d_model, Vp), "normal",
                                    cfg, dtype, device)
    return params


def params_from_numpy(tree, *, device, dtype=torch.float32):
    """The JAX package's param pytree (nested dicts of numpy arrays, e.g.
    `jax.device_get(params)`) -> the port's params: the same names, the
    same stacking, as `dtype` tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)      # bfloat16 et al. have no torch view
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------------
def embed_tokens(cfg: ArchConfig, params, tokens_or_embeds):
    if cfg.frontend != "none":
        x = tokens_or_embeds           # precomputed frame/patch embeddings
    else:
        x = params["embed"][tokens_or_embeds.long()]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def final_hidden_norm(cfg: ArchConfig, params, h):
    if cfg.norm_style == "ln_pre":
        return layer_norm(h, params["final_norm"], params["final_norm_b"],
                          eps=cfg.norm_eps)
    return rms_norm(h, params["final_norm"], eps=cfg.norm_eps)


def head_matrix(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def lm_loss(cfg: ArchConfig, params, hidden, labels, *, chunk=512):
    h = final_hidden_norm(cfg, params, hidden)
    return chunked_cross_entropy(h, head_matrix(cfg, params), labels,
                                 chunk=min(chunk, h.shape[1]),
                                 valid_vocab=cfg.vocab_size)


# ----------------------------------------------------------------------------
# Shard views and stage application (the spmd pipeline, core.wave)
# ----------------------------------------------------------------------------
def shard_blocks(cfg: ArchConfig, blocks, mesh, data: int = 0):
    """Each (stage, tp) slot's slice of the stacked block leaves, for data
    slot `data` of `mesh` (a launch.mesh.Mesh whose last axes are stage and
    tp): out[s][t] is the list, one entry per layer slot, of dicts leaf ->
    that layer's slice, on the slot's device.

    The stage slice is `layer_slots` rows of the stacked layer axis, the tp
    slice a chunk of the dim the spec marks "tp" (a mesh tp above cfg.tp
    == 1 gives every tp slot the whole leaf). Every slice is a view made by
    one split / chunk / unbind per leaf, and a copy only where the slot's
    device differs from the leaf's: autograd writes each leaf's grad once,
    where indexing a layer per tick would add a full-size zero grad per
    layer and tick (trap L4)."""
    specs = param_specs(cfg)["blocks"]
    devs = mesh.devices.reshape(-1, mesh.shape["stage"],
                                mesh.shape["tp"])[data]
    n_st, n_tp = devs.shape
    sl = cfg.layer_slots
    out = [[[{} for _ in range(sl)] for _ in range(n_tp)]
           for _ in range(n_st)]
    for name, leaf in blocks.items():
        spec = specs[name]
        tdim = spec.index("tp") if "tp" in spec else None
        if tdim is not None and leaf.shape[tdim] % n_tp:
            raise ValueError(f"{name} {tuple(leaf.shape)}: dim {tdim} does "
                             f"not split over tp {n_tp}")
        stage_views = leaf.split(sl)
        if len(stage_views) != n_st:
            raise ValueError(f"{name}: {len(stage_views)} stages of "
                             f"{sl} slots against a mesh of {n_st} stages")
        for s, sv in enumerate(stage_views):
            parts = sv.chunk(n_tp, dim=tdim) if tdim is not None \
                else [sv] * n_tp
            for t, part in enumerate(parts):
                for j, layer in enumerate(part.to(devs[s, t]).unbind(0)):
                    out[s][t][j][name] = layer
    return out


def stage_apply(cfg: ArchConfig, stage_layers, x, meta_local,
                ctx: LayerCtx, caches=None):
    """One pipeline stage: stage_layers[t] is tp shard t's list of
    per-layer leaf dicts (shard_blocks(...)[s], or its first entry alone
    when the layer runs whole), meta_local this stage's [slots] arrays
    (kind, valid, full_i, win_i). In prefill and decode caches[t] is shard
    t's stage-local cache (its groups indexed by the stage's full_i /
    win_i, its SSM state by the slot j), written in place; ctx carries the
    microbatch's pos / lens. Padded slots are skipped; the JAX package
    computes them and masks the result and the cache writes out, which
    gives the same x and cache. MoE layers append their aux loss to
    ctx.aux. Returns x."""
    uk = uniform_kind(cfg)
    for j in range(cfg.layer_slots):
        if uk is None and not meta_local["valid"][j]:
            continue
        ctx_j = dataclasses.replace(
            ctx, kind=uk if uk is not None else int(meta_local["kind"][j]),
            full_i=int(meta_local["full_i"][j]),
            win_i=int(meta_local["win_i"][j]), ssm_i=j)
        x = apply_layer_tp(cfg, [shard[j] for shard in stage_layers], x,
                           ctx_j, caches)
    return x


# ----------------------------------------------------------------------------
# Reference (non-pipelined, single-device) forward
# ----------------------------------------------------------------------------
def forward_ref(cfg: ArchConfig, params, tokens_or_embeds, *, mode="train",
                cache=None, pos=None, labels=None, lens=None,
                kernel_backend="ref"):
    """Plain layer loop. Returns (hidden, cache), or (loss, cache) in
    train mode with `labels`: the chunked CE plus 0.01 x the layers' MoE
    load-balancing loss over num_layers, as the JAX package. `pos`
    (decode) is a scalar or a [B] tensor; `lens` [B] marks per-row prompt
    lengths for right-padded prefill — cache writes stop at each row's
    length. The cache is written in place. `kernel_backend`
    ("ref"/"cuda") picks the plain paths or the kernels."""
    x = embed_tokens(cfg, params, tokens_or_embeds)
    if mode == "decode":
        pos = torch.as_tensor(pos, device=x.device)
        pos = pos.expand(x.shape[0]) if pos.dim() == 0 else pos
    meta = layer_meta(cfg)
    kinds = meta["kind"].reshape(-1)
    valid = meta["valid"].reshape(-1)
    full_i = meta["full_i"].reshape(-1)
    win_i = meta["win_i"].reshape(-1)
    sl = cfg.layer_slots
    ssm_i, m_ssm = ssm_slots(cfg)
    aux = [] if mode == "train" and labels is not None else None
    # one unbind per stacked leaf: its backward writes the leaf's grad once,
    # where indexing each layer would materialize a full-size zero grad per
    # layer and sum them
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for l in range(cfg.padded_layers):
        if not valid[l]:
            continue
        st_idx = l // sl
        # global cache, stage-major group indexing
        ctx = LayerCtx(mode=mode, pos=pos, kind=int(kinds[l]),
                       full_i=int(st_idx * meta["m_full"] + full_i[l]),
                       win_i=int(st_idx * meta["m_win"] + win_i[l]),
                       ssm_i=int(st_idx * m_ssm + ssm_i[l]), lens=lens,
                       kernel_backend=kernel_backend, aux=aux)
        p_l = layer_leaves(cfg, layers, l)
        x, cache = apply_layer(cfg, p_l, x, ctx, cache)
    if aux is not None:
        aux_t = torch.stack(aux).sum() if aux else x.new_zeros(
            (), dtype=torch.float32)
        return lm_loss(cfg, params, x, labels) + 0.01 * aux_t / max(
            cfg.num_layers, 1), cache
    return x, cache


def logits_ref(cfg: ArchConfig, params, hidden):
    """f32 logits over the real vocabulary (an f32 head, as the JAX
    package computes it)."""
    h = final_hidden_norm(cfg, params, hidden)
    logits = h.float() @ head_matrix(cfg, params).float()
    return logits[..., : cfg.vocab_size]


# ----------------------------------------------------------------------------
# Input specs (meta stand-ins; no allocation)
# ----------------------------------------------------------------------------
def input_specs(run) -> dict:
    """Meta tensors for the step of this (arch, shape) cell, by the JAX
    package's rules: token ids [B, S] int32 (the stub frontends: [B, S, d]
    embeddings in the compute dtype); prefill adds cache_struct's cache of
    seq_len; decode takes one token against a seq_len cache, sequence-
    sharded 16 ways under 16 rows, and a scalar int32 pos."""
    cfg, shp = run.arch, run.shape
    B, S = shp.global_batch, shp.seq_len
    dt, cache_dt = serve_dtypes(run.compute_dtype, run.cache_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def inputs(seq):
        return meta((B, seq, cfg.d_model), dt) if cfg.frontend != "none" \
            else meta((B, seq), torch.int32)

    def cache(seq_shards=1):
        shapes, _ = cache_struct(cfg, B, S, seq_shards=seq_shards,
                                 dtype=cache_dt)
        return {k: (tuple(meta(*x) for x in v) if isinstance(v[1], tuple)
                    else meta(*v)) for k, v in shapes.items()}

    if shp.kind == "train":
        return {"inputs": inputs(S), "labels": meta((B, S), torch.int32)}
    if shp.kind == "prefill":
        return {"inputs": inputs(S), "cache": cache()}
    return {"inputs": inputs(1), "cache": cache(16 if B < 16 else 1),
            "pos": meta((), torch.int32)}
