"""Whole-record streaming inference, the PyTorch counterpart of
``scgrhc.parallel.stream``.

A record is (optionally) calibrated from int16 ADC on the device, framed
into windows, and run chunk by chunk: each chunk of at most ``batch``
windows is normalized per window (K4,
:func:`scgrhc_torch.ops.kernels.dsp.normalize_windows`), run through the
U-Net (14 K1f launches) and denormalized, all on the device; the host
reads the predictions back once at the end.  Windows are independent (the
normalization is per window and instance norm per instance), so chunking
changes no value.

With a ``mesh`` (:mod:`scgrhc_torch.parallel.mesh`), each chunk's windows
are split over the ranks: each rank frames and normalizes its block (K4),
runs it through the U-Net on its card, and the blocks are gathered in rank
order to every rank.  :func:`mesh_for_request` decides when: a record of
at most ``STREAM_BATCH`` windows keeps the one-rank path.  The JAX
package pads window counts to buckets to bound XLA recompiles; PyTorch
runs eagerly and needs no bucketing, so a sharded chunk is padded only up
to a multiple of the mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from scgrhc_torch.ops.kernels.dsp import normalize_windows
from scgrhc_torch.parallel.mesh import Mesh, fetch_rows, pad_rows, round_up, row_block

STREAM_BATCH = 512  # windows per chunk


def mesh_for_request(mesh, n_samples: int, segment_samples: int,
                     overlap: int = 0, batch: int = STREAM_BATCH):
    """The mesh :func:`stream_infer` should shard THIS request over, or None.

    The serving and predict mesh policy of ``scgrhc``: records whose window
    count fits one chunk (``n <= batch``) keep the one-rank path; only
    records past it shard their windows.  An out-of-range ``overlap``
    returns None, so that the caller's ``stream_infer`` raises its own
    ValueError."""
    t = segment_samples
    if mesh is None or not 0 <= overlap < t:
        return None
    hop = t - overlap if overlap else t
    n = (n_samples - t) // hop + 1 if n_samples >= t else 0
    return mesh if n > batch else None


def frame_record(x, t: int, hop: int | None = None):
    """(C, L) → (N, C, t) windows (a view), hop defaults to t
    (non-overlapping, truncating the tail — reference: recordutil.py:141-148)."""
    hop = hop or t
    if x.shape[1] < t:
        return x.new_empty((0, x.shape[0], t))
    return x.unfold(1, t, hop).permute(1, 0, 2)


def _frame_norm(x, t: int, hop: int | None = None, start: int = 0,
                stop: int | None = None):
    """Frame windows [start, stop) of the f32 record x and normalize each by
    its joint (C, t) min-max (reference: recordutil.py:41-47) — one K4
    launch on CUDA."""
    return normalize_windows(frame_record(x, t, hop)[start:stop].contiguous())


def calibrate(adc, gain, base, sentinel):
    """int16 ADC (C, L) → physical f32: ``(adc − baseline)/gain``, with the
    format's sentinel value mapped to NaN (WFDB invalid samples)."""
    a = adc.float()
    phys = (a - base[:, None]) / gain[:, None]
    return torch.where(a == sentinel[:, None], torch.full_like(phys, float("nan")), phys)


def eval_windows_denorm(gen, w, lo, hi):
    """Forward + denormalization (reference denorm: waveform_test.py:21-25)
    → (B, t)."""
    p = gen(w)[:, 0, :]
    return p * (hi - lo) + lo


def _chunk(gen, mesh, phys, t: int, hop: int, start: int, stop: int, lo, hi):
    """Windows [start, stop) split over the mesh: this rank's block framed,
    normalized (K4) and predicted, padded with zero windows up to the block
    size (:func:`scgrhc_torch.parallel.mesh.row_block`), and every block
    gathered; returns the (stop − start, t) predictions on every rank.  A
    mesh of one runs every window."""
    n = stop - start
    a, b, k = row_block(mesh, n)
    w = (_frame_norm(phys, t, hop, start + a, start + b) if b > a
         else phys.new_zeros((0, phys.shape[0], t)))
    return fetch_rows(mesh, n, eval_windows_denorm(gen, pad_rows(w, k), lo, hi))[0]


def stream_infer(
    gen,
    record_scg,
    segment_samples: int = 750,
    batch: int = STREAM_BATCH,
    overlap: int = 0,
    rhc_minmax=None,
    calibration=None,
    mesh=None,
):
    """Predict the RHC waveform for one full record on ``gen``'s device.

    record_scg: (C, L) numpy — float32 physical units, or int16 ADC samples
    when ``calibration=(gain, baseline, sentinel)`` per-channel vectors are
    given.  Returns a (L',) float32 numpy waveform: normalized RHC, or
    denormalized when ``rhc_minmax=(min, max)`` is given.  ``overlap`` > 0
    predicts overlapping windows and cross-fades them (:func:`_blend`).
    ``mesh`` splits each chunk's windows over its ranks (``batch`` rounded
    up to a multiple of its size; by default a mesh of one, this process);
    every rank returns the whole waveform.
    """
    t = segment_samples
    if not 0 <= overlap < t:
        # hop = t - overlap must stay positive; reachable from the serve
        # daemon's client-supplied overlap_s, so reject it loudly
        raise ValueError(
            f"overlap must be in [0, segment_samples={t}), got {overlap}"
        )
    hop = t - overlap if overlap else t
    c, L = record_scg.shape
    n = (L - t) // hop + 1 if L >= t else 0
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    dev = next(gen.parameters()).device
    mesh = mesh or Mesh(1, 0)
    batch = round_up(max(1, min(batch, n)), mesh.size)

    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(record_scg)).to(dev)
        if calibration is not None:
            gain, base, sentinel = (
                torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for v in calibration
            )
            phys = calibrate(x, gain, base, sentinel)
        else:
            phys = x.float()
        lo, hi = rhc_minmax if rhc_minmax is not None else (0.0, 1.0)
        lo = torch.tensor(lo, dtype=torch.float32, device=dev)
        hi = torch.tensor(hi, dtype=torch.float32, device=dev)
        preds = []
        for s in range(0, n, batch):
            preds.append(_chunk(gen, mesh, phys, t, hop, s, min(s + batch, n), lo, hi))
        pred = torch.cat(preds).cpu().numpy()

    if overlap:
        return _blend(pred, hop, t)
    return pred.reshape(-1)


def _blend(pred: np.ndarray, hop: int, t: int) -> np.ndarray:
    """Overlap-add with linear cross-fade over the (t - hop) overlap.

    The first window's leading edge and the last window's trailing edge
    have no partner to fade against, so they keep full weight."""
    n = pred.shape[0]
    L = hop * (n - 1) + t
    out = np.zeros(L, dtype=np.float64)
    wsum = np.zeros(L, dtype=np.float64)
    ramp = np.ones(t)
    ov = t - hop
    if ov > 0:
        fade = np.linspace(0.0, 1.0, ov, endpoint=False)
        ramp[:ov] = fade
        ramp[-ov:] = fade[::-1]
    for i in range(n):
        r = ramp
        if ov > 0 and (i == 0 or i == n - 1):
            r = ramp.copy()
            if i == 0:
                r[:ov] = 1.0
            if i == n - 1:
                r[-ov:] = 1.0
        s = i * hop
        out[s : s + t] += pred[i] * r
        wsum[s : s + t] += r
    return (out / np.maximum(wsum, 1e-12)).astype(np.float32)
