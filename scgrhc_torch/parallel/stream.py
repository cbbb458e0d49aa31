"""Whole-record streaming inference on one device, the PyTorch counterpart of
``scgrhc.parallel.stream``.

A record is (optionally) calibrated from int16 ADC on the device, framed
into windows, and run chunk by chunk: each chunk of at most ``batch``
windows is normalized per window (K4,
:func:`scgrhc_torch.ops.kernels.dsp.normalize_windows`), run through the
U-Net (14 K1f launches) and denormalized, all on the device; the host
reads the predictions back once at the end.  Windows are independent (the
normalization is per window and instance norm per instance), so chunking
changes no value.

Not ported yet: the multi-device ``mesh`` sharding and
``mesh_for_request``.  The JAX package pads window counts to buckets to
bound XLA recompiles; PyTorch runs eagerly and needs no bucketing.
"""

from __future__ import annotations

import numpy as np
import torch

from scgrhc_torch.ops.kernels.dsp import normalize_windows

STREAM_BATCH = 512  # windows per chunk


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


def stream_infer(
    gen,
    record_scg,
    segment_samples: int = 750,
    batch: int = STREAM_BATCH,
    overlap: int = 0,
    rhc_minmax=None,
    calibration=None,
):
    """Predict the RHC waveform for one full record on ``gen``'s device.

    record_scg: (C, L) numpy — float32 physical units, or int16 ADC samples
    when ``calibration=(gain, baseline, sentinel)`` per-channel vectors are
    given.  Returns a (L',) float32 numpy waveform: normalized RHC, or
    denormalized when ``rhc_minmax=(min, max)`` is given.  ``overlap`` > 0
    predicts overlapping windows and cross-fades them (:func:`_blend`).
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
    batch = max(1, min(batch, n))

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
            w = _frame_norm(phys, t, hop, s, s + batch)
            preds.append(eval_windows_denorm(gen, w, lo, hi))
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
