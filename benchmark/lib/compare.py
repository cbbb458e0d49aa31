"""The numbers that decide ``correct``."""

from __future__ import annotations

import math
import statistics

import numpy as np


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict[str, float]:
    """Each leaf's gap between the program's and the reference's norms,
    ``| |p| - |r| | / max(|r|, median leaf |r|)``, over ``keys`` (default:
    all)."""
    keys = list(ref) if keys is None else list(keys)
    p = {k: float(np.linalg.norm(np.asarray(prog[k], np.float64))) for k in keys}
    r = {k: float(np.linalg.norm(np.asarray(ref[k], np.float64))) for k in keys}
    med = statistics.median(r.values())
    out = {}
    for k in keys:
        gap = abs(p[k] - r[k]) / max(r[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_norm_gap(prog: dict, ref: dict, keys=None) -> tuple[float, str]:
    """The worst leaf's :func:`leaf_gaps`, and its name."""
    gaps = leaf_gaps(prog, ref, keys)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moved_leaves(first_grad: dict, floor: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient norm is at least ``floor`` times the
    median leaf's: the others move under Adam by round-off alone."""
    r = {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in first_grad.items()}
    med = statistics.median(r.values())
    return [k for k, v in r.items() if v >= floor * med]


def scalar_gap(prog: list[float], ref: list[float]) -> float:
    """The worst ``|p - r| / max(|r|, median |r|)`` over paired scalars."""
    med = statistics.median(abs(r) for r in ref)
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        gap = abs(p - r) / max(abs(r), med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst

