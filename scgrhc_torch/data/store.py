"""Dense segment store, the port's copy of ``scgrhc.data.store``'s read
side and its file format (``scgrhc-store.v1``).

A split is a few dense arrays — ``scg (N, C, T)`` / ``rhc (N, 1, T)``
float32 plus per-segment metadata — so it moves to the device once
(:meth:`SegmentStore.device_arrays`) and the epoch-mode trainer gathers
batches there.

Normalization (reference: recordutil.py:41-66): each window's min and max
are taken jointly over its (T, C) signal group and the window becomes
``(x - min) / (max - min + 1e-4)`` in float64, then (C, T) float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

NORM_EPS = 1e-4  # reference: recordutil.py:46
FORMAT_TAG = "scgrhc-store.v1"


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
    def from_windows(cls, scg: np.ndarray, rhc: np.ndarray, record_name: str,
                     start_idx: np.ndarray) -> "SegmentStore":
        """Raw windows of one record, scg (N, T, C) and rhc (N, T, 1) in
        physical units, each min-max normalized as ``from_segments`` does
        with local min/max (``scgrhc/data/store.py:97-119``)."""
        n, t, _ = scg.shape
        mm_scg = np.stack([scg.reshape(n, -1).min(1), scg.reshape(n, -1).max(1)], 1)
        mm_rhc = np.stack([rhc.reshape(n, -1).min(1), rhc.reshape(n, -1).max(1)], 1)
        mm_scg, mm_rhc = mm_scg.astype(np.float64), mm_rhc.astype(np.float64)

        def norm(x, mm):
            x = x.astype(np.float64)
            return ((x - mm[:, 0, None, None]) / (mm[:, 1, None, None] - mm[:, 0, None, None]
                                                  + NORM_EPS)).transpose(0, 2, 1)

        start = np.asarray(start_idx, np.int64)
        return cls(norm(scg, mm_scg).astype(np.float32), norm(rhc, mm_rhc).astype(np.float32),
                   [record_name] * n, start, start + t, mm_scg, mm_rhc, segment_samples=t)

    def __len__(self) -> int:
        return self.scg.shape[0]

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
