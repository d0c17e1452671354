"""The Engine: one facade executing a serve Plan (repro.api.engine's serve
half) for the dense GQA, sliding-window, attention-free RWKV6 and SSD
hybrid families.

Serve-mode Plans (Plan.serve = ServeSpec) run on the threads backend
through the non-pipelined `lm.forward_ref` cache path:

  prefill() / decode() / generate()   one aligned batch over the contiguous
                                      cache (with kernel_backend="cuda":
                                      full-attention decode through
                                      flash_decode, RWKV6 prefill through
                                      rwkv6_chunked, SSD prefill through
                                      ssd_chunked)
  prefill_into() / decode(store)      the CacheStore the Scheduler drives
                                      (dense: the paged pool, prefill
                                      through flash_attention_fwd, decode
                                      through flash_decode_paged; RWKV6: no
                                      pool, per-slot WKV state and token
                                      shifts, prefill through rwkv6_chunked,
                                      decode in plain torch; windowed
                                      layers: per-slot kv_win rings, plain
                                      torch; hymba: the pool for its 3 full
                                      layers, rings, per-slot SSD state and
                                      conv tails, prefill through
                                      ssd_chunked)

The JAX Engine jit-compiles these steps; here they run eagerly under
torch.inference_mode(), writing the caches in place. Entry points run on
the CUDA card unless the caller passes device="cpu" — then the kernels'
wrappers take their plain PyTorch versions. Training (fit/step), the spmd
backend, faults and the Router are later ROADMAP items.
"""
from __future__ import annotations

import hashlib
import time

import torch

from repro_torch.api.plan import Plan
from repro_torch.api.report import ServeReport, Telemetry
from repro_torch.models import lm
from repro_torch.obs import NULL_TRACER
from repro_torch.serve import cache as cache_lib


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card; without one that raises instead of
    silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and torch sees "
                "none; pass device='cpu' to run on the CPU (the kernels' "
                "plain PyTorch versions)")
        return torch.device("cuda")
    return torch.device(device)


def sample_key(*parts) -> int:
    """A torch.Generator seed from integers, e.g. (sample_seed, rid, k): a
    request's sample stream depends on its own key only, never on its
    co-batched neighbours."""
    h = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Engine:
    """Executes a serve Plan. Params are drawn from the Plan's ArchConfig
    (a torch.Generator seeded with run.seed, in run.compute_dtype) unless
    injected — `lm.params_from_numpy` carries the JAX package's weights."""

    def __init__(self, plan: Plan, *, params=None, tracer=None, device=None):
        if not isinstance(plan, Plan):
            raise TypeError(f"Engine wants a Plan, got {type(plan).__name__}")
        if plan.arch is None:
            raise ValueError("Plan.arch is unset: the Engine builds the "
                             "model from the architecture")
        self.plan = plan
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._params = params
        self._serve = None         # lazy state for the serve surface
        self._serve_paged = None   # lazy paged (CacheStore) executors

    # ------------------------------------------------------------------
    def fit(self, **_):
        raise NotImplementedError("training (Engine.fit/step under WSP) is "
                                  "ROADMAP Queue 1 items 2-3")

    def attach_telemetry(self, report):
        """Attach the metrics snapshot to `report` — no-op untraced."""
        if self.tracer.enabled:
            report.telemetry = Telemetry.from_metrics(self.tracer.metrics)
        return report

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # serve surface
    # ------------------------------------------------------------------
    def _require_serve(self, what: str):
        if self.plan.serve is None:
            raise ValueError(f"{what}() serves requests; Plan.serve is "
                             f"unset — give the Plan a ServeSpec")

    def _ensure_serve(self):
        if self._serve is not None:
            return
        plan, run, sv = self.plan, self.plan.run, self.plan.serve
        cfg = plan.arch
        if cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: stub frontends are "
                                      f"ROADMAP Queue 1 item 5")
        cdt, cache_dt = cache_lib.serve_dtypes(run.compute_dtype,
                                               sv.cache_dtype)
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(run.seed)
            self._params = lm.init_params(cfg, gen, dtype=cdt,
                                          device=self.device)
        pre_fn, dec_fn = _ref_serve_steps(cfg, sv.kernel_backend)
        self._serve = {"cfg": cfg, "params": self._params,
                       "prefill": pre_fn, "decode": dec_fn,
                       "cache_dt": cache_dt}

    def _ensure_serve_store(self):
        if self._serve_paged is not None:
            return
        self._ensure_serve()
        sv = self.plan.serve
        layout = cache_lib.make_layout(sv.max_batch, sv.max_len,
                                       page_size=sv.page_size,
                                       max_pages=sv.max_pages)
        pre_fn, dec_fn = _ref_paged_steps(self._serve["cfg"],
                                          sv.kernel_backend)
        self._serve_paged = {"layout": layout, "prefill": pre_fn,
                             "decode": dec_fn}

    def serve_store(self) -> cache_lib.CacheStore:
        """A fresh CacheStore (empty page pool) for this Plan's serve
        shapes on this Engine's device."""
        self._require_serve("serve_store")
        self._ensure_serve_store()
        return cache_lib.CacheStore(self._serve["cfg"],
                                    self._serve_paged["layout"],
                                    dtype=self._serve["cache_dt"],
                                    device=self.device)

    def serve_cache(self):
        """A blank contiguous cache for max_batch requests of up to
        serve.max_len positions."""
        self._require_serve("serve_cache")
        self._ensure_serve()
        sv = self.plan.serve
        return cache_lib.init_cache(self._serve["cfg"], sv.max_batch,
                                    sv.max_len, dtype=self._serve["cache_dt"],
                                    device=self.device)

    def _tokens(self, x, what: str):
        x = torch.as_tensor(x, device=self.device)
        sv = self.plan.serve
        if what and tuple(x.shape[:2]) != (sv.max_batch, sv.prompt_len):
            raise ValueError(
                f"{what} {tuple(x.shape)} disagree with the frozen serve "
                f"shapes [{sv.max_batch}, {sv.prompt_len}] (pad the batch to "
                f"max_batch and short prompts on the right)")
        return x

    def prefill(self, prompts):
        """Prefill a full batch of prompts into a fresh contiguous cache.

        prompts [max_batch, prompt_len] token ids. Returns (last_logits
        [B, vocab] f32, cache)."""
        self._require_serve("prefill")
        self._ensure_serve()
        st, sv = self._serve, self.plan.serve
        prompts = self._tokens(prompts, "prompts")
        cache = self.serve_cache()
        with self.tracer.span("engine", "prefill", batch=sv.max_batch), \
                torch.inference_mode():
            logits, cache = st["prefill"](st["params"], prompts, cache)
            if self.tracer.enabled:      # span measures compute, not enqueue
                self._sync()
        return logits[:, -1], cache

    def prefill_into(self, store, prompts, lens, slots, skip_pages=None):
        """Prefill a batch of (possibly right-padded) prompts directly into
        `store`'s page pool.

        prompts [max_batch, prompt_len] with rows 0..len(slots)-1 carrying
        real requests; lens [max_batch] per-row prompt lengths; slots the
        store slot of each live row. K/V scatter through the block table in
        place. Returns each row's last-real-position logits [max_batch,
        vocab]. skip_pages[j] skips writing row j's first N pages (they
        hold a shared prefix already)."""
        self._require_serve("prefill_into")
        self._ensure_serve_store()
        if not isinstance(store, cache_lib.CacheStore):
            raise TypeError(f"prefill_into writes a CacheStore, got "
                            f"{type(store).__name__}")
        st, pg = self._serve, self._serve_paged
        prompts = self._tokens(prompts, "prompts")
        lens = torch.as_tensor(lens, dtype=torch.int64, device=self.device)
        with self.tracer.span("engine", "prefill", rows=len(slots)), \
                torch.inference_mode():
            logits, out = pg["prefill"](
                st["params"], prompts, lens,
                store.prefill_input(slots, skip_pages=skip_pages))
            store.append_rows(out, [(j, s) for j, s in enumerate(slots)])
            if self.tracer.enabled:
                self._sync()
        return logits[:, -1]

    def decode(self, tokens, cache, pos):
        """One decode position for the whole batch.

        tokens [B, 1] ids; pos a scalar or [B] vector (each row at its own
        depth); cache the contiguous tree from prefill() — updated in place
        — or a CacheStore, which routes through the paged decode. Returns
        (logits [B, vocab] f32, cache)."""
        self._require_serve("decode")
        sv = self.plan.serve
        tokens = self._tokens(tokens, "")
        pos = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        if pos.dim() == 0:
            pos = pos.expand(sv.max_batch)
        if isinstance(cache, cache_lib.CacheStore):
            self._ensure_serve_store()
            fn, tree = self._serve_paged["decode"], cache.tree
        else:
            self._ensure_serve()
            fn, tree = self._serve["decode"], cache
        with self.tracer.span("engine", "decode"), torch.inference_mode():
            logits, out = fn(self._serve["params"], tokens, tree, pos)
            if self.tracer.enabled:
                self._sync()
        if isinstance(cache, cache_lib.CacheStore):
            cache.update(out)
            return logits[:, -1], cache
        return logits[:, -1], out

    def generate(self, prompts=None, *, callback=None) -> ServeReport:
        """Run the Plan's serve scenario on one aligned batch: prefill
        max_batch prompts, then gen greedy/sampled decode positions over
        the contiguous cache. Returns a ServeReport with `tokens` [B, gen].
        Without prompts, ids are drawn from a torch.Generator seeded with
        sample_seed (not the JAX package's draws)."""
        self._require_serve("generate")
        self._ensure_serve()
        plan, sv, cfg = self.plan, self.plan.serve, self.plan.arch
        if prompts is None:
            g = torch.Generator().manual_seed(sv.sample_seed)
            prompts = torch.randint(0, cfg.vocab_size,
                                    (sv.max_batch, sv.prompt_len),
                                    generator=g, dtype=torch.int32)
        report = ServeReport(arch=cfg.name, backend=plan.run.backend,
                             max_batch=sv.max_batch)
        t_tr = self.tracer.now()
        t_start = time.monotonic()
        logits, cache = self.prefill(prompts)
        self._sync()
        report.prefill_s = time.monotonic() - t_start
        report.prefill_calls = 1
        self.tracer.metrics.observe("serve/ttft_s", report.prefill_s)
        tok = _pick(logits, sv.temperature, sample_key(sv.sample_seed, 0))
        toks = [tok]
        if callback is not None:
            callback(0, tok)
        for t in range(1, sv.gen):
            t0 = time.monotonic()
            logits, cache = self.decode(toks[-1][:, None], cache,
                                        sv.prompt_len + t - 1)
            self._sync()
            report.decode_s += time.monotonic() - t0
            report.decode_steps += 1
            tok = _pick(logits, sv.temperature, sample_key(sv.sample_seed, t))
            toks.append(tok)
            if callback is not None:
                callback(t, tok)
        report.tokens = torch.stack(toks, dim=1).cpu().numpy()
        report.wall_s = time.monotonic() - t_start
        self.tracer.add_span("engine", "generate", t_tr, self.tracer.now(),
                             gen=sv.gen, batch=sv.max_batch)
        return self.attach_telemetry(report)


# ---------------------------------------------------------------------------
# serve steps (plain functions; the JAX package jit-compiles its twins)
# ---------------------------------------------------------------------------
def _ref_serve_steps(cfg, kernel_backend="ref"):
    """The non-pipelined forward_ref path over the contiguous cache:
    (prefill_fn, decode_fn). kernel_backend="cuda" routes the attention
    through repro_torch.kernels."""

    def pre_fn(params, prompts, cache):
        hid, cache = lm.forward_ref(cfg, params, prompts, mode="prefill",
                                    cache=cache,
                                    kernel_backend=kernel_backend)
        return lm.logits_ref(cfg, params, hid[:, -1:]), cache

    def dec_fn(params, tokens, cache, pos):
        hid, cache = lm.forward_ref(cfg, params, tokens, mode="decode",
                                    cache=cache, pos=pos,
                                    kernel_backend=kernel_backend)
        return lm.logits_ref(cfg, params, hid), cache

    return pre_fn, dec_fn


def _ref_paged_steps(cfg, kernel_backend="ref"):
    """forward_ref over the paged cache tree: variable-length prefill
    through the block table + per-row-position decode. With the "cuda"
    backend decode walks the block table inside flash_decode_paged."""

    def pre_fn(params, prompts, lens, cache):
        hid, cache = lm.forward_ref(cfg, params, prompts, mode="prefill",
                                    cache=cache, lens=lens,
                                    kernel_backend=kernel_backend)
        idx = (lens - 1).clamp_min(0)
        last = hid[torch.arange(hid.shape[0], device=hid.device), idx]
        return lm.logits_ref(cfg, params, last[:, None]), cache

    dec_fn = _ref_serve_steps(cfg, kernel_backend)[1]
    return pre_fn, dec_fn


def _pick(logits, temperature, seed):
    """Next-token choice over [B, vocab] logits: greedy argmax (first
    index on ties) at temperature 0, else a categorical draw from a
    generator seeded with `seed`."""
    if temperature == 0:
        return logits.argmax(dim=-1).to(torch.int32)
    g = torch.Generator(device=logits.device).manual_seed(seed)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=g)[:, 0].to(torch.int32)
