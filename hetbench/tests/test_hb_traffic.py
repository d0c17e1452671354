"""The traffic generators: deterministic from the seed, on their laws."""
import json

import numpy as np

from hetbench import sampling
from hetbench.tests.tiny import HERE
from hetbench.traffic import lm_rows, offline_queue


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def test_quantile_grid_follows_its_law():
    u = sampling.quantiles({"law": "uniform", "lo": 16, "hi": 64}, 48)
    assert u.min() >= 16 and u.max() <= 64 and (np.diff(u) >= 0).all()
    assert abs(u.mean() - 40) < 1
    lg = sampling.quantiles({"law": "loguniform", "lo": 64, "hi": 512}, 64)
    # log-uniform: the median is the geometric mean of the ends
    assert abs(np.median(lg) - np.sqrt(64 * 512)) < 8


def test_every_seed_serves_the_same_lengths_and_prefixes_spread():
    law = {"law": "loguniform", "lo": 128, "hi": 1024}
    a = sampling.spread_lengths(law, 200, 64)
    assert (a[:64] == a[64:128]).all()
    assert sorted(a[:64]) == sorted(sampling.quantiles(law, 64))
    # any 16 consecutive requests cover the law's four quartiles evenly
    q = np.searchsorted(np.sort(a[:64]), a, side="right") - 1
    for k in range(0, 200 - 16, 7):
        counts = np.bincount(q[k:k + 16] // 16, minlength=4)
        assert counts.min() >= 2, counts
    o = sampling.fixed_order(64)
    assert sorted(o) == list(range(64))
    assert abs(np.corrcoef(sampling.spread_order(64), o)[0, 1]) < 0.3


def test_zipf_ids_cover_the_vocabulary_by_rank():
    z = sampling.Zipf(49155, 1.1)
    ids = z.draw(sampling.rng(7), 200_000)
    assert ids.min() >= 0 and ids.max() < 49155
    counts = np.bincount(ids, minlength=49155)
    top = z.ids[:3]
    assert counts[top[0]] > counts[top[1]] > counts[top[2]]
    assert (counts > 0).sum() > 10_000


def test_offline_queue_is_deterministic_and_on_its_laws():
    cfg, mix = _cfg("granite-moe-1b-a400m"), _mix("chat-b128")
    q1 = offline_queue.make(mix, cfg, 2 ** 31 + 11)
    q2 = offline_queue.make(mix, cfg, 2 ** 31 + 11)
    q3 = offline_queue.make(mix, cfg, 5)
    assert len(q1) == mix["requests"]
    assert all((a.prompt == b.prompt).all() and
               a.max_new_tokens == b.max_new_tokens for a, b in zip(q1, q2))
    plen = np.array([len(r.prompt) for r in q1])
    olen = np.array([r.max_new_tokens for r in q1])
    assert plen.min() >= 64 and plen.max() <= mix["prompt_len"]
    assert olen.min() >= 128 and olen.max() <= mix["gen"]
    assert [len(r.prompt) for r in q1] == [len(r.prompt) for r in q3]
    assert [r.max_new_tokens for r in q1] == [r.max_new_tokens for r in q3]
    assert any((a.prompt != b.prompt).any() for a, b in zip(q1, q3))
    w = offline_queue.warmup(mix, cfg, 3)
    assert len(w) == 2 * mix["max_batch"]
    assert all(r.max_new_tokens == 2 for r in w)


def test_lm_rows_are_next_token_pairs_and_all_differ():
    cfg, mix = _cfg("granite-moe-1b-a400m"), _mix("train-wsp")
    src = lm_rows.make(mix, cfg, 2 ** 32 + 1)
    x0, y0 = src.wave(0)
    assert x0.shape == (mix["rows_per_wave"], mix["seq"])
    assert (x0[:, 1:] == y0[:, :-1]).all()
    x1, _ = src.wave(1)
    rows = {r.tobytes() for r in np.concatenate([x0, x1])}
    assert len(rows) == 2 * mix["rows_per_wave"]
    stride = mix["rows_per_wave"] * (mix["seq"] + 1)
    xa, ya = src.window(stride, mix["rows_per_wave"], mix["seq"])
    assert (xa == x1).all()
    assert (lm_rows.make(mix, cfg, 2 ** 32 + 1).wave(0)[0] == x0).all()
