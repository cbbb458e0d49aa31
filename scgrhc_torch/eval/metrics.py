"""Evaluation metrics (the port's copy of ``scgrhc.eval.metrics``;
reference: waveform_test.py:28-50).

Per segment, the reference computes scipy's ``pearsonr`` with its default
Fisher-z 95% CI, and ``sqrt(mean_squared_error)`` with a t-distribution CI
on ``se = sqrt(rmse / 2n)``.  :func:`segment_scores` computes the same on
torch tensors in float32, batched over segments, on the tensors' device;
:func:`global_scores`, the selection stage's, computes them on the host in
float64.  The CI critical values depend only on the segment length and come
from scipy on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def t_crit_975(df: int) -> float:
    """t.ppf(0.975, df) (reference: waveform_test.py:45-46)."""
    from scipy.stats import t

    return float(t.ppf(0.975, df=df))


# norm.ppf(0.975): scipy pearsonr confidence_interval's z_crit.
Z_CRIT_975 = 1.959963984540054


def pearson_r(x, y, dim=-1):
    """Row-wise Pearson correlation (reference: waveform_test.py:28-36),
    centred accumulation.  NaN for a constant row."""
    x = x - x.mean(dim, keepdim=True)
    y = y - y.mean(dim, keepdim=True)
    return (x * y).sum(dim) / torch.sqrt((x * x).sum(dim) * (y * y).sum(dim))


def pearson_ci95(r, n: int):
    """Fisher-z 95% CI, scipy ``pearsonr(...).confidence_interval(0.95)``'s
    default method (reference: waveform_test.py:34-35)."""
    zr = torch.arctanh(r.clamp(-1.0 + 1e-12, 1.0 - 1e-12))
    se = 1.0 / np.sqrt(n - 3)
    return torch.tanh(zr - Z_CRIT_975 * se), torch.tanh(zr + Z_CRIT_975 * se)


def rmse(x, y, dim=-1):
    """Root mean squared error (reference: waveform_test.py:43)."""
    return torch.sqrt(torch.square(x - y).mean(dim))


def rmse_ci95(rmse_val, n: int):
    """t-distribution CI on se = sqrt(rmse / 2n) (reference:
    waveform_test.py:44-49)."""
    se = torch.sqrt(rmse_val / (2 * n))
    tc = t_crit_975(n - 1)
    return rmse_val - tc * se, rmse_val + tc * se


def segment_scores(x, y) -> dict:
    """The six reference metric columns for a batch of paired waveforms.

    x, y: (B, T) real / predicted, denormalized.  Returns (B,) tensors
    under the reference CSV column names (waveform_test.py:72-85)."""
    n = x.shape[-1]
    r = pearson_r(x, y)
    r_lo, r_hi = pearson_ci95(r, n)
    e = rmse(x, y)
    e_lo, e_hi = rmse_ci95(e, n)
    return {
        "pcc_r": r,
        "pcc_ci95_lower": r_lo,
        "pcc_ci95_upper": r_hi,
        "rmse": e,
        "rmse_ci95_lower": e_lo,
        "rmse_ci95_upper": e_hi,
    }


def global_scores(x, y) -> dict:
    """One global PCC/RMSE over concatenated segments (reference:
    waveform_checkpoint.py:32-39); x, y flat 1-D arrays.  Host float64, so
    the argmax over checkpoints is the reference's (scipy float64) choice."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[-1]
    xc = x - x.mean()
    yc = y - y.mean()
    r = float((xc @ yc) / np.sqrt((xc @ xc) * (yc @ yc)))
    se_z = 1.0 / np.sqrt(n - 3)
    zr = np.arctanh(max(min(r, 1.0 - 1e-15), -1.0 + 1e-15))
    e = float(np.sqrt(np.mean(np.square(x - y))))
    se = np.sqrt(e / (2 * n))
    tc = t_crit_975(n - 1)
    return {
        "pcc_r": r,
        "pcc_ci95_lower": float(np.tanh(zr - Z_CRIT_975 * se_z)),
        "pcc_ci95_upper": float(np.tanh(zr + Z_CRIT_975 * se_z)),
        "rmse": e,
        "rmse_ci95_lower": float(e - tc * se),
        "rmse_ci95_upper": float(e + tc * se),
    }
