"""Record catalog: enumerate records and slice named channels (the port's
copy of ``scgrhc.io.catalog``).

Mirrors the reference's record access layer (reference: recordutil.py:19,
82-90, 113-119) on top of the port's WFDB reader.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from scgrhc_torch.core import paths
from scgrhc_torch.io.wfdb import Record, rdrecord, rdrecord_digital, read_header

SAMPLE_FREQ = 500  # Hz (reference: recordutil.py:19)


def get_record_names(processed_dir: str | None = None) -> list[str]:
    """Record stems present in the processed-data directory (any file with a
    ``.dat`` or ``.hea`` extension; reference: recordutil.py:82-90)."""
    base = processed_dir if processed_dir is not None else paths.PROCESSED_DATA_PATH
    names = set()
    for filename in os.listdir(base):
        if filename.endswith(".dat") or filename.endswith(".hea"):
            names.add(Path(filename).stem)
    return sorted(names)


def read_record(record_name: str, processed_dir: str | None = None) -> Record:
    base = processed_dir if processed_dir is not None else paths.PROCESSED_DATA_PATH
    return rdrecord(os.path.join(base, record_name))


def get_channels(
    record: Record, channel_names: list[str], start_idx: int, stop_idx: int
) -> np.ndarray:
    """Slice named channels from a record (reference: recordutil.py:113-119).

    Returns (stop_idx - start_idx, len(channel_names)) float64.
    """
    indexes = [record.sig_name.index(name) for name in channel_names]
    return record.p_signal[start_idx:stop_idx, indexes]


def read_record_digital(record_name: str, channel_names: list[str],
                        processed_dir: str | None = None):
    """Named channels of a record as int16 ADC plus calibration vectors.

    Returns ``(adc (L, C) int16, gain (C,) f32, baseline (C,) f32,
    sentinel (C,) f32)`` or ``None`` when the record has no digital
    representation (:func:`scgrhc_torch.io.wfdb.rdrecord_digital`).
    Serving uploads the int16 array (half the bytes of float32) and
    calibrates on the device."""
    base = processed_dir if processed_dir is not None else paths.PROCESSED_DATA_PATH
    path = os.path.join(base, record_name)
    dig = rdrecord_digital(path)
    if dig is None:
        return None
    d_signal, gains, baselines, sentinels = dig
    _, _, _, specs = read_header(path + ".hea")
    sig_names = [s.sig_name for s in specs]
    idx = [sig_names.index(n) for n in channel_names]
    return (
        d_signal[:, idx],
        gains[idx].astype(np.float32),
        baselines[idx].astype(np.float32),
        sentinels[idx].astype(np.float32),
    )
