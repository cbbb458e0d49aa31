"""Dense segment store, the port's copy of ``scgrhc.data.store`` and its
file format (``scgrhc-store.v1``).

A split is a few dense arrays — ``scg (N, C, T)`` / ``rhc (N, 1, T)``
float32 plus per-segment metadata — so it moves to the device once
(:meth:`SegmentStore.device_arrays`) and the trainer and the evaluation
gather batches there.

Normalization (reference: recordutil.py:41-66): each window's min and max
are taken jointly over its (T, C) signal group (or over the whole dataset
with ``use_global_min_max``) and the window becomes
``(x - min) / (max - min + 1e-4)`` in float64, then (C, T) float32,
zero-padded or truncated on the time axis to ``segment_samples``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from scgrhc_torch.dsp.segment import Segment

NORM_EPS = 1e-4  # reference: recordutil.py:46
FORMAT_TAG = "scgrhc-store.v1"


def minmax_norm(x: np.ndarray, minmax: tuple[float, float]) -> np.ndarray:
    lo, hi = minmax
    return (x - lo) / (hi - lo + NORM_EPS)


def reverse_minmax(x, orig_min, orig_max):
    """Denormalize (reference: waveform_test.py:21-25; no +1e-4: the
    reference's denorm is not the exact inverse)."""
    return x * (orig_max - orig_min) + orig_min


def _pad_or_truncate(x: np.ndarray, t: int) -> np.ndarray:
    """(C, L) → (C, t), zero-padded or truncated on the time axis
    (reference: recordutil.py:30-39)."""
    L = x.shape[-1]
    if L < t:
        return np.pad(x, ((0, 0), (0, t - L)))
    return x[:, :t]


def get_global_minmax_vals(segments):
    """Joint min/max across all segments per signal group
    (reference: recordutil.py:152-169)."""
    scg_min = min(float(np.min(s.scg)) for s in segments)
    scg_max = max(float(np.max(s.scg)) for s in segments)
    rhc_min = min(float(np.min(s.rhc)) for s in segments)
    rhc_max = max(float(np.max(s.rhc)) for s in segments)
    return (scg_min, scg_max), (rhc_min, rhc_max)


@dataclass
class SegmentStore:
    """Dense, padded view of one split."""

    scg: np.ndarray  # (N, C, T) float32, normalized
    rhc: np.ndarray  # (N, 1, T) float32, normalized
    record_names: list[str]
    start_idx: np.ndarray  # (N,) int64, interval-relative
    stop_idx: np.ndarray  # (N,) int64
    minmax_scg: np.ndarray  # (N, 2) float64
    minmax_rhc: np.ndarray  # (N, 2) float64
    segment_samples: int = 750
    _device_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_segments(cls, segments, segment_size: float, minmax_scg: tuple[float, float] | None,
                      minmax_rhc: tuple[float, float] | None,
                      sample_freq: int = 500) -> "SegmentStore":
        """Segments (:class:`scgrhc_torch.dsp.segment.Segment`, time-major
        float64) → a store, each window normalized by ``minmax_*`` or, where
        that is None, by its own min/max (reference: recordutil.py:41-66)."""
        return cls._from_segments(segments, int(segment_size * sample_freq), minmax_scg,
                                  minmax_rhc)

    @classmethod
    def from_windows(cls, scg: np.ndarray, rhc: np.ndarray, record_name: str,
                     start_idx: np.ndarray) -> "SegmentStore":
        """Raw windows of one record, scg (N, T, C) and rhc (N, T, 1) in
        physical units, normalized as :meth:`from_segments` does with local
        min/max."""
        t = scg.shape[1]
        segs = [Segment(scg[i], rhc[i], record_name, int(s), int(s) + t)
                for i, s in enumerate(start_idx)]
        return cls._from_segments(segs, t, None, None)

    @classmethod
    def _from_segments(cls, segments, t: int, minmax_scg, minmax_rhc) -> "SegmentStore":
        n = len(segments)
        c = segments[0].scg.shape[1] if n else 0
        scg = np.zeros((n, c, t), dtype=np.float32)
        rhc = np.zeros((n, 1, t), dtype=np.float32)
        mm_scg = np.zeros((n, 2), dtype=np.float64)
        mm_rhc = np.zeros((n, 2), dtype=np.float64)
        start = np.zeros(n, dtype=np.int64)
        stop = np.zeros(n, dtype=np.int64)
        for i, seg in enumerate(segments):
            local_scg = ((float(np.min(seg.scg)), float(np.max(seg.scg)))
                         if minmax_scg is None else minmax_scg)
            local_rhc = ((float(np.min(seg.rhc)), float(np.max(seg.rhc)))
                         if minmax_rhc is None else minmax_rhc)
            scg[i] = _pad_or_truncate(minmax_norm(seg.scg, local_scg).T.astype(np.float32), t)
            rhc[i] = _pad_or_truncate(minmax_norm(seg.rhc, local_rhc).T.astype(np.float32), t)
            mm_scg[i] = local_scg
            mm_rhc[i] = local_rhc
            start[i] = seg.start_idx
            stop[i] = seg.stop_idx
        return cls(scg, rhc, [seg.record_name for seg in segments], start, stop, mm_scg, mm_rhc,
                   segment_samples=t)

    def __len__(self) -> int:
        return self.scg.shape[0]

    def __getitem__(self, i: int):
        """The reference dataset item (recordutil.py:55-66): (scg, rhc,
        record_name, start, stop, (scg_min, scg_max), (rhc_min, rhc_max))."""
        return (self.scg[i], self.rhc[i], self.record_names[i], int(self.start_idx[i]),
                int(self.stop_idx[i]), tuple(self.minmax_scg[i]), tuple(self.minmax_rhc[i]))

    def device_arrays(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(scg, rhc) on ``device``, uploaded once and reused every epoch."""
        key = str(torch.device(device))
        if key not in self._device_cache:
            self._device_cache[key] = (torch.from_numpy(self.scg).to(device),
                                       torch.from_numpy(self.rhc).to(device))
        return self._device_cache[key]

    def state_dict(self) -> dict:
        return {
            "format": FORMAT_TAG,
            "scg": self.scg,
            "rhc": self.rhc,
            "record_names": self.record_names,
            "start_idx": self.start_idx,
            "stop_idx": self.stop_idx,
            "minmax_scg": self.minmax_scg,
            "minmax_rhc": self.minmax_rhc,
            "segment_samples": self.segment_samples,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "SegmentStore":
        if d.get("format") != FORMAT_TAG:
            raise ValueError(f"not a segment store: {d.get('format')!r}")
        return cls(
            np.asarray(d["scg"], np.float32), np.asarray(d["rhc"], np.float32),
            list(d["record_names"]), np.asarray(d["start_idx"], np.int64),
            np.asarray(d["stop_idx"], np.int64), np.asarray(d["minmax_scg"], np.float64),
            np.asarray(d["minmax_rhc"], np.float64), segment_samples=d["segment_samples"],
        )
