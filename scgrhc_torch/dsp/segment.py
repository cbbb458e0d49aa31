"""Sliding-window segmentation of records into paired SCG/RHC segments (the
port's copy of ``scgrhc.dsp.segment``).

Reference semantics (recordutil.py:122-149): for every chamber interval of
every record, slice the configured SCG channels plus ``RHC_pressure``, chop
into non-overlapping windows of ``segment_size * 500`` samples, and drop
windows whose RHC channel fails the noise gate.  ``start_idx``/``stop_idx``
are *interval-relative* window offsets, as in the reference
(recordutil.py:143-144).

``data_backend`` picks the gate: ``"host"`` (default) the float64 NumPy
gate, ``"device"`` K3 (:func:`scgrhc_torch.ops.kernels.dsp.gate_and_normalize`,
float32) on the device the caller names.  Either way the kept windows are
cut from the raw host float64 arrays, and windows holding a NaN are
dropped on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.dsp.noise import FLAT_THRESHOLD, FLAT_WINDOW_S, R2_THRESHOLD
from scgrhc_torch.io.catalog import SAMPLE_FREQ, get_channels, get_record_names, read_record
from scgrhc_torch.io.sidecar import get_chamber_intervals
from scgrhc_torch.ops.kernels.dsp import segment_record_on_device


@dataclass
class Segment:
    """One paired SCG/RHC window (pre-normalization, time-major)."""

    scg: np.ndarray  # (T, C) float64
    rhc: np.ndarray  # (T, 1) float64
    record_name: str
    start_idx: int  # window start, relative to its chamber interval
    stop_idx: int


def gate_windows(rhc_windows: np.ndarray, min_rhc: float) -> np.ndarray:
    """(N, T) RHC windows → (N,) keep-mask (True = clean), vectorized.

    Decision-identical to the reference's per-window ``has_noise``
    (waveform_noise.py:44-49, incl. the >=2-flat-window quirk)."""
    n, t = rhc_windows.shape
    win = int(FLAT_WINDOW_S * SAMPLE_FREQ)
    keep = np.ones(n, dtype=bool)

    if t >= win:
        w = np.lib.stride_tricks.sliding_window_view(rhc_windows, win, axis=-1)
        rng = w.max(axis=-1) - w.min(axis=-1)
        flat = np.count_nonzero(rng < FLAT_THRESHOLD, axis=-1) >= 2
        keep &= ~flat

    x = np.arange(t, dtype=np.float64)
    xc = x - x.mean()
    yc = rhc_windows - rhc_windows.mean(axis=-1, keepdims=True)
    num = yc @ xc
    denom = np.dot(xc, xc) * np.einsum("nt,nt->n", yc, yc)
    r2 = np.where(denom > 0, np.square(num) / np.where(denom > 0, denom, 1.0), 1.0)
    keep &= ~(r2 > R2_THRESHOLD)

    keep &= ~np.any(rhc_windows < min_rhc, axis=-1)
    return keep


def _kept_segments(keep, scg_signal, rhc_signal, segment_samples, record_name):
    """Segments of the kept windows, cut from the raw host arrays, after
    dropping windows that hold a NaN (the WFDB reader maps flagged-missing
    samples to NaN; the reference would crash on them inside sklearn,
    waveform_noise.py:31-33, so dropping is the only useful semantics)."""
    num = keep.shape[0]
    total = num * segment_samples
    keep = keep & ~np.isnan(rhc_signal[:total, 0].reshape(num, segment_samples)).any(axis=-1)
    keep &= ~np.isnan(scg_signal[:total].reshape(num, segment_samples, -1)).any(axis=(1, 2))
    out = []
    for i in np.nonzero(keep)[0]:
        s = int(i) * segment_samples
        e = s + segment_samples
        out.append(Segment(scg_signal[s:e], rhc_signal[s:e], record_name, s, e))
    return out


def segment_interval(
    scg_signal: np.ndarray,
    rhc_signal: np.ndarray,
    segment_samples: int,
    min_rhc: float,
    record_name: str,
) -> list[Segment]:
    """Chop one chamber interval's signals into clean windows (host gate)."""
    num = scg_signal.shape[0] // segment_samples
    if num == 0:
        return []
    rhc_windows = rhc_signal[: num * segment_samples, 0].reshape(num, segment_samples)
    return _kept_segments(gate_windows(rhc_windows, min_rhc), scg_signal, rhc_signal,
                          segment_samples, record_name)


def segment_interval_device(
    scg_signal: np.ndarray,
    rhc_signal: np.ndarray,
    segment_samples: int,
    min_rhc: float,
    record_name: str,
    device,
) -> list[Segment]:
    """:func:`segment_interval` with the gate on ``device``: one K3 launch
    for the interval, of which only ``keep`` comes back.  The Segments are
    those of the host path except for a window within f32 rounding of a
    gate threshold."""
    if scg_signal.shape[0] // segment_samples == 0:
        return []
    keep = segment_record_on_device(scg_signal, rhc_signal[:, 0], segment_samples, min_rhc,
                                    device)[0]
    return _kept_segments(keep.cpu().numpy(), scg_signal, rhc_signal, segment_samples,
                          record_name)


def get_segments(params, record_name: str | None = None, device=None) -> list[Segment]:
    """All clean segments for an experiment (reference: recordutil.py:122-149).
    ``device`` is where K3 runs with ``data_backend: "device"`` (default
    CUDA); the host backend ignores it."""
    if record_name is None:
        segments: list[Segment] = []
        for name in get_record_names():
            segments.extend(get_segments(params, record_name=name, device=device))
        return segments

    segment_samples = int(params.segment_size * SAMPLE_FREQ)
    record = read_record(record_name)
    if getattr(params, "data_backend", "host") == "device":
        dev = resolve_device(device)

        def chop(*args):
            return segment_interval_device(*args, dev)
    else:
        chop = segment_interval
    segments = []
    for start, stop in get_chamber_intervals(record_name, params.chamber):
        scg_signal = get_channels(record, params.in_channels, start, stop)
        rhc_signal = get_channels(record, ["RHC_pressure"], start, stop)
        segments.extend(
            chop(scg_signal, rhc_signal, segment_samples, params.min_RHC, record_name)
        )
    return segments
