"""The numbers `correct` is decided on."""
from __future__ import annotations

import statistics


def logit_gap(ref_logits, tokens) -> float:
    """Widest gap by which a served token's reference logit lies below the
    reference's best at the same position (0 where every token is the
    reference's argmax). ref_logits [n, V]; tokens [n]."""
    if ref_logits.shape[0] == 0:
        return 0.0
    got = ref_logits.gather(1, tokens.long().view(-1, 1))[:, 0]
    return float((ref_logits.max(1).values - got).max())


def rel_err(prog, ref) -> float:
    """The rms of prog - ref over the rms of ref. An rms and not a largest
    gap: where a routing choice flips between two precisions one token's
    state changes whole, in the sound program and in the control alike,
    and a largest gap would read that flip and nothing else."""
    ref = ref.float()
    scale = ref.square().mean().sqrt().clamp_min(1e-30)
    return float((prog.float() - ref).square().mean().sqrt() / scale)


def worst_leaf(prog: dict, ref: dict, skip=()) -> tuple:
    """Over the leaves of two {leaf: norm} maps: the largest
    |prog - ref| / max(ref, median of ref), and the leaf it is at. Leaves in
    `skip` are left out."""
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def median_leaf(prog: dict, ref: dict, skip=()) -> float:
    """Over the leaves of two {leaf: norm} maps: the median of
    |prog - ref| / max(ref, median of ref)."""
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in names)


def quiet_leaves(g1: dict, frac: float = 1e-3) -> list:
    """Leaves whose first reference gradient is under `frac` of the median
    leaf's: they move by round-off alone and are not compared."""
    med = statistics.median(g1.values())
    return sorted(n for n, g in g1.items() if g < frac * med)


def moved_apart(after_a: dict, after_b: dict, before: dict, step: float
                ) -> float:
    """Share of elements whose change from `before` differs between two
    runs by half an optimizer step or more (AdamW's first step moves every
    element by about lr, whatever the size of its gradient)."""
    n = far = 0
    for k, b in before.items():
        d = (after_a[k].to(b.device).float() - after_b[k].to(b.device).float())
        far += int((d.abs() >= 0.5 * step).sum())
        n += d.numel()
    return far / max(n, 1)


def change_norms(after: dict, before: dict) -> dict:
    return {n: float((after[n].to(before[n].device).float()
                      - before[n].float()).norm()) for n in before}
