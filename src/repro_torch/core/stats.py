"""Paper-faithful statistics: medians, bootstrap CIs, CV (paper §5, App D)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def p50(xs: Sequence[float]) -> float:
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def mean(xs: Sequence[float]) -> float:
    return float(np.mean(np.asarray(xs, dtype=np.float64)))


def std(xs: Sequence[float]) -> float:
    return float(np.std(np.asarray(xs, dtype=np.float64), ddof=1)) if len(xs) > 1 else 0.0


def cv(xs: Sequence[float]) -> float:
    """Coefficient of variation (paper reports cross-session CV)."""
    m = mean(xs)
    return std(xs) / m if m else 0.0


def bootstrap_ci_mean(xs: Sequence[float], *, n_resamples: int = 10_000,
                      alpha: float = 0.05, seed: int = 0) -> Tuple[float, float]:
    """Percentile bootstrap CI on the mean (paper: 10000-resample 95% CI).

    Degenerate samples short-circuit instead of feeding the resampler:
    an empty sample has no mean — ``(nan, nan)`` — and a singleton's
    bootstrap distribution is the point itself — ``(x, x)`` — so quick
    benchmark runs with 1 repeat get an honest answer rather than a
    ``rng.integers(0, 0)`` ValueError or a vacuous resample."""
    arr = np.asarray(xs, dtype=np.float64)
    if arr.size == 0:
        return float("nan"), float("nan")
    if arr.size == 1:
        return float(arr[0]), float(arr[0])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(arr), size=(n_resamples, len(arr)))
    means = arr[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


def paired_speedups(baseline: Sequence[float], treated: Sequence[float]) -> np.ndarray:
    """Within-session paired ratios (paper: eager/graphed per session)."""
    b = np.asarray(baseline, dtype=np.float64)
    t = np.asarray(treated, dtype=np.float64)
    assert b.shape == t.shape
    return b / t
