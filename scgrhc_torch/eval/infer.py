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

With a ``mesh`` of N ranks (:mod:`scgrhc_torch.parallel.mesh`) each chunk
is rounded up to a multiple of N with zero windows (and (0, 1) for their
min-max), as ``scgrhc`` pads its sharded chunks; each rank runs its block
on its card, and the kept rows of the predictions and scores are gathered
to every rank.  The int8 generator's activation scales then take their
max over the chunk's real windows on every rank
(:meth:`scgrhc_torch.models.quant.QuantGenerator.sharded`), so each
window's output is the one process's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from scgrhc_torch.eval import metrics
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import Mesh, fetch_rows, pad_rows, round_up, row_block


def _chunk_scores(gen, mesh, scg, rhc, mm_rhc):
    """One chunk: forward → denorm → metrics.  scg (B, C, T), rhc (B, 1, T),
    mm_rhc (B, 2) float32.  The rows are split over ``mesh``: this rank's
    block (:func:`scgrhc_torch.parallel.mesh.row_block`, padded with zero
    windows and a (0, 1) min-max) is run, and the real rows of every block
    are gathered in rank order; a mesh of one runs the whole chunk.
    Denormalization as waveform_test.py:21-25,64-67, in float32 whatever
    the generator's compute dtype; returns the predicted waveforms and the
    scores (the real waveform stays on the host, :func:`host_real`)."""
    n = scg.shape[0]
    a, b, k = row_block(mesh, n)
    sharded = getattr(gen, "sharded", None)  # the int8 generator's chunk-wide scales
    with sharded(b - a, comm.all_reduce_max) if sharded else contextlib.nullcontext():
        pred = gen(pad_rows(scg[a:b], k))
    mm = pad_rows(mm_rhc[a:b], k, (0.0, 1.0))
    lo = mm[:, :1]
    span = mm[:, 1:] - mm[:, :1]
    x = pad_rows(rhc[a:b], k)[:, 0, :] * span + lo
    y = pred[:, 0, :].float() * span + lo
    scores = metrics.segment_scores(x, y)
    y, *values = fetch_rows(mesh, n, y, *scores.values())
    return y, dict(zip(scores, values))


def host_real(store) -> np.ndarray:
    """The denormalized real RHC from the store's own arrays,
    ``rhc * (max - min) + min`` in float32 elementwise ops, the arithmetic
    of the device's denormalization on the same inputs."""
    mm32 = np.asarray(store.minmax_rhc, np.float32)
    lo = mm32[:, :1]
    span = mm32[:, 1:] - mm32[:, :1]
    return store.rhc[:, 0, :] * span + lo


def predict_split(gen, store, batch: int = 256, mesh: Mesh | None = None):
    """Run the generator (in eval mode, on its device; a ``Generator`` or the
    int8 ``QuantGenerator``) over every segment of a store, ``batch``
    segments at a time (rounded up to a multiple of the ``mesh``'s size,
    whose ranks split each chunk; by default a mesh of one, this process).
    Returns (real (N, T), pred (N, T), both denormalized float32 numpy, and
    a dict of (N,) numpy score arrays), on every rank."""
    n = len(store)
    t = store.segment_samples
    if not n:
        return np.zeros((0, t), np.float32), np.zeros((0, t), np.float32), {}
    dev = next(gen.parameters()).device
    scg_d, rhc_d = store.device_arrays(dev)
    mm = torch.from_numpy(np.asarray(store.minmax_rhc, np.float32)).to(dev)
    mesh = mesh or Mesh(1, 0)
    batch = round_up(max(1, min(batch, n)), mesh.size)
    ys, scores = [], []
    with torch.inference_mode():
        for s in range(0, n, batch):
            y, sc = _chunk_scores(gen, mesh, scg_d[s:s + batch], rhc_d[s:s + batch],
                                  mm[s:s + batch])
            ys.append(y)
            scores.append(sc)
    merged = {k: torch.cat([sc[k] for sc in scores]).cpu().numpy() for k in scores[0]}
    return host_real(store), torch.cat(ys).cpu().numpy(), merged
