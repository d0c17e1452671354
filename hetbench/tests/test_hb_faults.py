"""The timed path broken underneath: each fault a cell can have turns
`correct` false. Training: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), the push to the
parameter server (the exchange) left out. Serving: a token altered where
it is picked, a decode step that leaves the cache unchanged, half of the
batch's rows left out."""
import time

import pytest
import torch

from hetbench import harness


def _run(root, cell, hooks, seconds=1.0):
    return harness.run_cell(root, cell, 2 ** 31 + 5, seconds, False,
                            t_process=time.monotonic(), device="cpu",
                            hooks=hooks)


def _unchanged(step):
    def wave(params, opt, x, y):
        d, o, loss = step(params, opt, x, y)
        return {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                    if isinstance(v, dict) else torch.zeros_like(v))
                for k, v in d.items()}, o, loss
    return wave


def _half_batch(step):
    def wave(params, opt, x, y):
        h = x.shape[0] // 2
        return step(params, opt, x[:h], y[:h])
    return wave


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_training_faults(tiny_root, fault):
    out = _run(tiny_root, "tiny-granite-train", {"wave_step": fault})
    assert out["correct"] is False, out["checks"]


def test_training_without_the_exchange(tiny_root, monkeypatch):
    from repro_torch.core import param_server

    def finish(self, pending):
        pending.send.wait()
        pending.applied = True
        self.push_count += 1
        clock = self.clock.complete_wave_if_registered(pending.wid)
        self.push_event.set()
        return clock

    monkeypatch.setattr(param_server.ParameterServer, "finish_push", finish)
    out = _run(tiny_root, "tiny-granite-train", {})
    assert out["correct"] is False, out["checks"]


def _altered_token(eng, sched):
    pick = sched._pick_one
    vocab = eng.plan.arch.vocab_size
    sched._pick_one = lambda row, rid, k: (pick(row, rid, k) + 1) % vocab


def _cache_unchanged(eng, sched):
    decode = eng.decode

    def step(tokens, cache, pos):
        kept = {k: tuple(t.clone() for t in v) if isinstance(v, tuple)
                else v.clone() for k, v in cache.tree.items()}
        out = decode(tokens, cache, pos)
        for k, v in kept.items():
            for dst, src in zip(cache.tree[k] if isinstance(v, tuple)
                                else (cache.tree[k],),
                                v if isinstance(v, tuple) else (v,)):
                dst.copy_(src)
        return out
    eng.decode = step


def _half_rows(eng, sched):
    decode, prefill = eng.decode, eng.prefill_into

    def step(tokens, cache, pos):
        logits, c = decode(tokens, cache, pos)
        logits = logits.clone()
        h = logits.shape[0] // 2
        logits[h:] = logits[:logits.shape[0] - h].clone()
        return logits, c

    def pre(store, prompts, lens, slots, skip_pages=None):
        logits = prefill(store, prompts, lens, slots,
                         skip_pages=skip_pages).clone()
        n = len(slots)
        logits[n // 2:n] = logits[0]
        return logits
    eng.decode, eng.prefill_into = step, pre


@pytest.mark.parametrize("cell", ["tiny-granite-chat", "tiny-rwkv6-rag"])
@pytest.mark.parametrize("fault", [_altered_token, _cache_unchanged,
                                   _half_rows])
def test_serving_faults(tiny_root, cell, fault):
    # a state left unchanged shows from a request's second decode step on:
    # the window holds some tens of steps
    out = _run(tiny_root, cell, {"serve": [fault]}, seconds=3.0)
    assert out["correct"] is False, out["checks"]
