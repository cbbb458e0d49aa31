"""Whole-record SCG→RHC prediction, the PyTorch counterpart of
``scgrhc.pipeline.predict``.

Loads an experiment's checkpoint (``best`` through checkpoint_best.txt,
``last``, or an explicit name), reads the record's SCG channels, and runs
the whole record on the device: windowed
(:func:`scgrhc_torch.parallel.stream.stream_infer`: per-window
normalization as in training, optional overlap-and-blend) or, with
``continuous``, seam-free (:func:`predict_continuous`: one normalization
over the record and one U-Net pass over the whole sequence,
:mod:`scgrhc_torch.models.cp`, time-sharded over the ranks when there are
several and the record's length divides their count).  ``calibrate`` denormalizes the
prediction to the train split's RHC range (:func:`cohort_rhc_minmax`).

Output: ``<dir>/predictions/<record>.npy`` (float32 waveform at 500 Hz)
plus a small JSON sidecar with provenance.

``mesh`` (CLI ``--mesh``) shards the windowed path's windows over the
ranks of the process group (:mod:`scgrhc_torch.parallel.stream`) when the
record is past one chunk (``STREAM_BATCH`` windows); at world size 1 it is
a mesh of one.  Every rank reads the record and computes; only rank 0
writes the files, and the others wait for it.

Checkpoints are read whichever backend wrote them: a name that is an
Orbax directory on disk (``NNN.checkpoint.orbax``) resolves to it
(:mod:`scgrhc_torch.train.orbax_io`).
"""

from __future__ import annotations

import json
import os
from time import time

import numpy as np
import torch

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.data.loaders import load_dataloader
from scgrhc_torch.io.catalog import (
    SAMPLE_FREQ,
    get_channels,
    read_record,
    read_record_digital,
)
from scgrhc_torch.models import cp
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import TIME_AXIS, make_mesh
from scgrhc_torch.parallel.stream import STREAM_BATCH, mesh_for_request, stream_infer
from scgrhc_torch.train import checkpoint as ckpt_io


def resolve_checkpoint(params, which: str) -> str:
    """'best' (checkpoint_best.txt handshake), 'last', or explicit name; a
    bare ``NNN.checkpoint`` that lives on disk as an Orbax directory
    resolves to ``NNN.checkpoint.orbax``."""
    if which == "best":
        with open(os.path.join(params.dir_path, "checkpoint_best.txt")) as f:
            which = f.read().splitlines()[0].split()[1]
    elif which == "last":
        which = ckpt_io.get_last_checkpoint_path(params.checkpoint_dir_path)
        if which is None:
            raise FileNotFoundError(
                f"no complete checkpoint in {params.checkpoint_dir_path}"
            )
    full = os.path.join(params.checkpoint_dir_path, which)
    if not os.path.exists(full) and os.path.isdir(full + ckpt_io.ORBAX_SUFFIX):
        which += ckpt_io.ORBAX_SUFFIX
    return which


def load_generator_params(params, ckpt_name: str, device=None):
    """A checkpoint's generator (pickle or Orbax directory), moved to the
    device once per process (every request then runs against resident
    weights), in eval mode."""
    dev = resolve_device(device)
    ckpt = ckpt_io.load(os.path.join(params.checkpoint_dir_path, ckpt_name))
    return generator_from_state_dict(ckpt["g_state_dict"], dev).eval()


def read_windowed(params, record_name: str):
    """What the windowed path reads of a record: ``(adc, (gain, base,
    sentinel))``, int16 ADC (L, C) with its calibration, when the record
    has a digital representation, else ``(scg, None)``, physical (L, C)."""
    dig = read_record_digital(record_name, params.in_channels)
    if dig is not None:
        adc, gain, base, sentinel = dig
        return adc, (gain, base, sentinel)
    return read_scg(params, record_name), None


def predict_windows(gen, params, rec, overlap: int, rhc_minmax=None,
                    batch: int = STREAM_BATCH, mesh=None) -> np.ndarray:
    """A record read by :func:`read_windowed` through the windowed path: the
    int16 ADC path with on-device calibration, or the float path; its
    windows sharded over ``mesh`` past one chunk (:func:`mesh_for_request`)."""
    t = params.segment_samples
    data, calibration = rec
    if calibration is None:
        data = data.astype(np.float32)
    return stream_infer(
        gen, np.ascontiguousarray(data.T), segment_samples=t, batch=batch,
        overlap=overlap, rhc_minmax=rhc_minmax, calibration=calibration,
        mesh=mesh_for_request(mesh, data.shape[0], t, overlap, batch),
    )


def predict_record(gen, params, record_name: str, overlap: int,
                   rhc_minmax=None, batch: int = STREAM_BATCH, mesh=None) -> np.ndarray:
    """One record through the windowed path (:func:`predict_windows`)."""
    return predict_windows(gen, params, read_windowed(params, record_name), overlap,
                           rhc_minmax, batch, mesh)


def predict_continuous(gen, scg: np.ndarray, rhc_minmax=None) -> np.ndarray:
    """One whole-record pass on ``gen``'s device: scg (L, C) → (L,) float32.
    The record's joint (C, L) min-max normalization (``+1e-4`` in the
    span), on every rank before the split, then
    :func:`scgrhc_torch.models.cp.apply_cp` over the world's ``time`` axis
    when it has more than one rank and L divides by their count, else
    :func:`scgrhc_torch.models.cp.apply_continuous` at (1, C, L) (the rule
    of ``scgrhc.pipeline.predict._predict_continuous``), then the optional
    denormalization to ``rhc_minmax``.  A collective over the ranks."""
    dev = next(gen.parameters()).device
    mesh = make_mesh(axis=TIME_AXIS)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(scg.T, dtype=np.float32)).to(dev)
        lo, hi = x.min(), x.max()
        x = (x - lo) / (hi - lo + 1e-4)
        if mesh.size > 1 and x.shape[1] % mesh.size == 0:
            y = cp.apply_cp(gen, x, mesh)
        else:
            y = cp.apply_continuous(gen, x[None])
        out = y[0, 0].float().cpu().numpy()
    if rhc_minmax is not None:
        rlo, rhi = rhc_minmax
        out = out * (rhi - rlo) + rlo
    return out


def cohort_rhc_minmax(params) -> tuple[float, float]:
    """The calibration range: the joint (min, max) over the stored RHC
    (min, max) of every segment of the experiment's train split, so that a
    prediction on a new record (no RHC) comes out in mmHg through the eval
    stage's reverse min-max (reference: waveform_test.py:21-25)."""
    mm = load_dataloader(params.train_path).dataset.minmax_rhc
    return float(mm[:, 0].min()), float(mm[:, 1].max())


def read_scg(params, record_name: str) -> np.ndarray:
    """The record's SCG channels, (L, C) physical values."""
    record = read_record(record_name)
    return get_channels(record, params.in_channels, 0, record.sig_len)


def run(
    params,
    record_name: str,
    checkpoint: str = "best",
    overlap_s: float = 0.0,
    rhc_minmax: tuple[float, float] | None = None,
    out_dir: str | None = None,
    continuous: bool = False,
    calibrate: bool = False,
    mesh: bool = False,
    device=None,
) -> str:
    """Predict one record's full RHC waveform; returns the .npy path.

    ``continuous`` runs the seam-free whole-record mode; ``calibrate``
    (without an explicit ``rhc_minmax``) denormalizes to the train split's
    RHC range; ``mesh`` shards the windows over the ranks (module doc).
    Every rank returns the path."""
    comm.refuse_lone_rank()
    start_time = time()
    ckpt_name = resolve_checkpoint(params, checkpoint)
    print(
        timelog(
            f"Run waveform_predict for {params.dir_path} | {record_name} | "
            f"{ckpt_name}",
            start_time,
        )
    )
    gen = load_generator_params(params, ckpt_name, device)
    if calibrate and rhc_minmax is None:
        rhc_minmax = cohort_rhc_minmax(params)
        print(
            timelog(
                f"waveform_predict | calibrated to train-cohort RHC range "
                f"[{rhc_minmax[0]:.1f}, {rhc_minmax[1]:.1f}] mmHg",
                start_time,
            )
        )
    overlap = int(overlap_s * SAMPLE_FREQ)
    if continuous:
        pred = predict_continuous(gen, read_scg(params, record_name), rhc_minmax)
    else:
        pred = predict_record(gen, params, record_name, overlap, rhc_minmax,
                              mesh=make_mesh() if mesh else None)

    out_dir = out_dir or os.path.join(params.dir_path, "predictions")
    out_path = os.path.join(out_dir, f"{record_name}.npy")
    comm.on_primary("predict_end", _write, pred, out_dir, out_path, record_name, ckpt_name,
                    params, continuous, overlap, rhc_minmax, start_time)
    return out_path


def _write(pred, out_dir, out_path, record_name, ckpt_name, params, continuous, overlap,
           rhc_minmax, start_time) -> None:
    """The prediction's .npy and its JSON sidecar."""
    t = params.segment_samples
    os.makedirs(out_dir, exist_ok=True)
    np.save(out_path, pred.astype(np.float32))
    with open(os.path.join(out_dir, f"{record_name}.json"), "w") as f:
        json.dump(
            {
                "record": record_name,
                "checkpoint": ckpt_name,
                "in_channels": params.in_channels,
                "mode": "continuous" if continuous else "windowed",
                "segment_samples": t,
                "overlap_samples": overlap,
                "denormalized": rhc_minmax is not None,
                "n_samples": int(pred.shape[0]),
                "sample_freq": SAMPLE_FREQ,
            },
            f,
            indent=2,
        )
    print(
        timelog(
            f"waveform_predict | {record_name} | {pred.shape[0]} samples "
            f"({pred.shape[0] / SAMPLE_FREQ:.1f} s) → {out_path}",
            start_time,
        )
    )
