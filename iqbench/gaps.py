"""The numbers a check can compare between the program's logits and the
reference's, each relative to the RMS of the reference's logits over the
sample.  A cloud's gap is its widest logit difference.  Near-ties in a kNN
graph break differently under two summation orders, so a few clouds of a
sound run jump (``logit_gap`` swings with them); the median and the
quantiles of the clouds' gaps read the precision of the rest, and
``jumped_share`` counts the clouds that jumped.

A sample with a value that is not finite (NaN, an infinity) on either
side reads infinite in every number, never lost in a median, a quantile or
a maximum, and fails every limit.
"""
from __future__ import annotations

import numpy as np

JUMP = 1e-3         # a cloud whose gap passes this share of the RMS jumped


def _relative(p: np.ndarray, r: np.ndarray):
    """|p - r| over the RMS of r, or None where a value is not finite."""
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        return None
    rms = np.sqrt((r ** 2).mean())
    return np.abs(p - r) / rms if rms > 0 else None


def logit_gaps(program, reference) -> dict:
    lg = np.asarray(program, np.float64)
    lr = np.asarray(reference, np.float64)
    lg, lr = lg.reshape(-1, lg.shape[-1]), lr.reshape(-1, lr.shape[-1])
    names = ("logit_gap", "logit_median_gap", "logit_p90_gap",
             "logit_p99_gap", "logit_rms_gap", "jumped_share")
    diff = _relative(lg, lr)
    if diff is None:
        return dict.fromkeys(names, np.inf)
    per = diff.max(-1)
    return dict(zip(names, map(float, (
        per.max(), np.median(per), np.quantile(per, 0.9),
        np.quantile(per, 0.99), np.sqrt((diff ** 2).mean()),
        (per > JUMP).mean()))))


def value_gaps(program, reference, prefix: str) -> dict:
    """The widest, the RMS and the median gap of a vector of values (a
    pose's Shapley values, one a region), over the RMS reference value."""
    names = (prefix + "_gap", prefix + "_rms_gap", prefix + "_median_gap")
    diff = _relative(np.asarray(program, np.float64),
                     np.asarray(reference, np.float64))
    if diff is None:
        return dict.fromkeys(names, np.inf)
    return dict(zip(names, map(float, (
        diff.max(), np.sqrt((diff ** 2).mean()), np.median(diff)))))
