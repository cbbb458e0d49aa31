"""Batched whole-split inference (the port's copy of ``scgrhc.eval.infer``).

The split's dense (N, C, T) arrays go to the device once; the generator
runs over chunks of ``eval_batch`` segments (14 K1f launches per chunk),
and the denormalization with each segment's RHC min/max and the scores
run on the device.  The reference evaluates segment by segment at batch 1
on the CPU (waveform_test.py:58-67).

JAX pads each chunk to a static size so that one compiled program serves
them all; PyTorch runs eagerly, so chunks keep their own sizes.  The
chunks are the JAX package's all the same, which the int8 generator needs:
its activation scales span a chunk (:mod:`scgrhc_torch.models.quant`;
JAX's zero-padded windows leave them as they are).  The JAX
package's ``predict_split_multi`` (K checkpoints stacked under ``vmap``)
has no counterpart: ``vmap`` cannot pass through K1f's ctypes launch, and
a loop over checkpoints is :func:`predict_split` once per checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from scgrhc_torch.eval import metrics


def _chunk_scores(gen, scg, rhc, mm_rhc):
    """One chunk: forward → denorm → metrics.  scg (B, C, T), rhc (B, 1, T),
    mm_rhc (B, 2) float32.  Denormalization as waveform_test.py:21-25,64-67,
    in float32 whatever the generator's compute dtype; returns the
    predicted waveforms and the scores (the real waveform stays on the
    host, :func:`host_real`)."""
    pred = gen(scg)
    lo = mm_rhc[:, :1]
    span = mm_rhc[:, 1:] - mm_rhc[:, :1]
    x = rhc[:, 0, :] * span + lo
    y = pred[:, 0, :].float() * span + lo
    return y, metrics.segment_scores(x, y)


def host_real(store) -> np.ndarray:
    """The denormalized real RHC from the store's own arrays,
    ``rhc * (max - min) + min`` in float32 elementwise ops, the arithmetic
    of the device's denormalization on the same inputs."""
    mm32 = np.asarray(store.minmax_rhc, np.float32)
    lo = mm32[:, :1]
    span = mm32[:, 1:] - mm32[:, :1]
    return store.rhc[:, 0, :] * span + lo


def predict_split(gen, store, batch: int = 256):
    """Run the generator (in eval mode, on its device; a ``Generator`` or the
    int8 ``QuantGenerator``) over every segment of a store, ``batch``
    segments at a time.  Returns (real (N, T), pred (N, T), both denormalized
    float32 numpy, and a dict of (N,) numpy score arrays)."""
    n = len(store)
    t = store.segment_samples
    if not n:
        return np.zeros((0, t), np.float32), np.zeros((0, t), np.float32), {}
    dev = next(gen.parameters()).device
    scg_d, rhc_d = store.device_arrays(dev)
    mm = torch.from_numpy(np.asarray(store.minmax_rhc, np.float32)).to(dev)
    batch = max(1, min(batch, n))
    ys, scores = [], []
    with torch.inference_mode():
        for s in range(0, n, batch):
            y, sc = _chunk_scores(gen, scg_d[s:s + batch], rhc_d[s:s + batch], mm[s:s + batch])
            ys.append(y)
            scores.append(sc)
    merged = {k: torch.cat([sc[k] for sc in scores]).cpu().numpy() for k in scores[0]}
    return host_real(store), torch.cat(ys).cpu().numpy(), merged
