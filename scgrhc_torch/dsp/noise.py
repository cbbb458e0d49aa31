"""Noise/artifact gate for RHC pressure segments (the port's copy of the
NumPy part of ``scgrhc.dsp.noise``).

Reproduces the reference gate's decisions (reference:
waveform_noise.py:6-49) as vectorized math:

1. **Flat lines**: a 50-sample (0.1 s at 500 Hz) rolling max − min below
   1e-3 (waveform_noise.py:10-13).  With exactly ONE flat window the
   reference's segment-building loop returns no segments
   (waveform_noise.py:17-24), so the gate fires iff **two or more** windows
   are flat.
2. **Straight line**: OLS R² of the segment against the sample index
   > 0.8 (waveform_noise.py:29-34), in closed form (the squared Pearson
   correlation with the index).  A zero-variance segment counts as
   straight.
3. **Range**: any sample below ``params.min_RHC`` (waveform_noise.py:37-41).

The batched dataset-build gate is :func:`scgrhc_torch.dsp.segment.gate_windows`
(host, float64) and K3 (:mod:`scgrhc_torch.ops.kernels.dsp`, float32).
"""

from __future__ import annotations

import numpy as np

FLAT_THRESHOLD = 1e-3
FLAT_WINDOW_S = 0.1
R2_THRESHOLD = 0.8


def _flat_window_count_np(waveform: np.ndarray, min_samples: int) -> int:
    if waveform.shape[-1] < min_samples:
        return 0
    w = np.lib.stride_tricks.sliding_window_view(waveform, min_samples, axis=-1)
    rng = w.max(axis=-1) - w.min(axis=-1)
    return int(np.count_nonzero(rng < FLAT_THRESHOLD))


def _r_squared_np(waveform: np.ndarray) -> float:
    n = waveform.shape[-1]
    x = np.arange(n, dtype=np.float64)
    y = np.asarray(waveform, dtype=np.float64)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.dot(xc, xc) * np.dot(yc, yc)
    if denom == 0.0:
        return 1.0  # constant segment: degenerate fit, treat as straight
    r = np.dot(xc, yc) / np.sqrt(denom)
    return float(r * r)


def get_flat_lines(
    waveform: np.ndarray,
    threshold: float = FLAT_THRESHOLD,
    min_duration: float = FLAT_WINDOW_S,
    sampling_rate: int = 500,
) -> list[tuple[int, int]]:
    """The reference's flat-segment lister (waveform_noise.py:6-26) without
    pandas: windows indexed by their right edge like pandas ``rolling``,
    and the segment-building loop, quirks included (the in-loop duplicate
    ``(start, last)`` appends, the empty result for one flat window)."""
    min_samples = int(min_duration * sampling_rate)
    n = np.asarray(waveform).shape[-1]
    if n < min_samples:
        return []
    w = np.lib.stride_tricks.sliding_window_view(waveform, min_samples, axis=-1)
    rng_v = w.max(axis=-1) - w.min(axis=-1)
    flat_indices = (np.nonzero(rng_v < threshold)[0] + min_samples - 1).tolist()

    flat_segments: list[tuple[int, int]] = []
    start = None
    for i in range(len(flat_indices) - 1):
        if start is None:
            start = flat_indices[i]
        if flat_indices[i + 1] != flat_indices[i] + 1:
            flat_segments.append((start, flat_indices[i]))
            start = None
        if start is not None:
            flat_segments.append((start, flat_indices[-1]))
    return flat_segments


def has_flat_lines(waveform: np.ndarray, sampling_rate: int = 500) -> bool:
    min_samples = int(FLAT_WINDOW_S * sampling_rate)
    return _flat_window_count_np(waveform, min_samples) >= 2


def is_straight_line(waveform: np.ndarray) -> bool:
    return _r_squared_np(waveform) > R2_THRESHOLD


def in_rhc_range(min_rhc: float, waveform: np.ndarray) -> bool:
    return not bool(np.any(np.asarray(waveform) < min_rhc))


def has_noise(params, waveform: np.ndarray) -> bool:
    """Reference-compatible gate (waveform_noise.py:44-49)."""
    return (
        has_flat_lines(waveform)
        or is_straight_line(waveform)
        or not in_rhc_range(params.min_RHC, waveform)
    )
