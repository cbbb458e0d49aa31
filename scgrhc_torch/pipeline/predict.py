"""Whole-record SCG→RHC prediction, the PyTorch counterpart of
``scgrhc.pipeline.predict`` (windowed mode).

Loads an experiment's checkpoint (``best`` through checkpoint_best.txt,
``last``, or an explicit name), reads the record's SCG channels, and runs
:func:`scgrhc_torch.parallel.stream.stream_infer` over the whole record.

Output: ``<dir>/predictions/<record>.npy`` (float32 waveform at 500 Hz)
plus a small JSON sidecar with provenance.

Not yet ported: the continuous mode, cohort calibration, mesh sharding
and Orbax checkpoints; each raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import json
import os
from time import time

import numpy as np

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.io.catalog import (
    SAMPLE_FREQ,
    get_channels,
    read_record,
    read_record_digital,
)
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel.stream import STREAM_BATCH, stream_infer
from scgrhc_torch.train import checkpoint as ckpt_io


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is not yet ported to scgrhc_torch")


def resolve_checkpoint(params, which: str) -> str:
    """'best' (checkpoint_best.txt handshake), 'last', or explicit name."""
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
    if which.endswith(ckpt_io.ORBAX_SUFFIX) or (
        not os.path.exists(full) and os.path.isdir(full + ckpt_io.ORBAX_SUFFIX)
    ):
        raise not_ported("reading Orbax checkpoints")
    return which


def load_generator_params(params, ckpt_name: str, device=None):
    """A checkpoint's generator, moved to the device once per process (every
    request then runs against resident weights), in eval mode."""
    dev = resolve_device(device)
    ckpt = ckpt_io.load(os.path.join(params.checkpoint_dir_path, ckpt_name))
    return generator_from_state_dict(ckpt["g_state_dict"], dev).eval()


def predict_record(gen, params, record_name: str, overlap: int,
                   rhc_minmax=None, batch: int = STREAM_BATCH) -> np.ndarray:
    """One record through the windowed path: the int16 ADC path with
    on-device calibration when the record has a digital representation,
    else the float path."""
    t = params.segment_samples
    dig = read_record_digital(record_name, params.in_channels)
    if dig is not None:
        adc, gain, base, sentinel = dig
        return stream_infer(
            gen, np.ascontiguousarray(adc.T), segment_samples=t, batch=batch,
            overlap=overlap, rhc_minmax=rhc_minmax,
            calibration=(gain, base, sentinel),
        )
    record = read_record(record_name)
    scg = get_channels(record, params.in_channels, 0, record.sig_len)
    return stream_infer(
        gen, scg.T.astype(np.float32), segment_samples=t, batch=batch,
        overlap=overlap, rhc_minmax=rhc_minmax,
    )


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
    """Predict one record's full RHC waveform; returns the .npy path."""
    for flag, feature in ((continuous, "the continuous mode (--continuous)"),
                          (calibrate, "cohort calibration (--calibrate)"),
                          (mesh, "mesh sharding (--mesh)")):
        if flag:
            raise not_ported(feature)
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
    t = params.segment_samples
    overlap = int(overlap_s * SAMPLE_FREQ)
    pred = predict_record(gen, params, record_name, overlap, rhc_minmax)

    out_dir = out_dir or os.path.join(params.dir_path, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{record_name}.npy")
    np.save(out_path, pred.astype(np.float32))
    with open(os.path.join(out_dir, f"{record_name}.json"), "w") as f:
        json.dump(
            {
                "record": record_name,
                "checkpoint": ckpt_name,
                "in_channels": params.in_channels,
                "mode": "windowed",
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
    return out_path
