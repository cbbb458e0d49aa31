"""Synthetic SCG/RHC database generation (the port's copy of
``scgrhc.utils.synth``).

The reference pipeline expects a directory of WFDB records plus per-record
JSON sidecars at a hard-coded path (reference: pathutil.py:4-6,
recordutil.py:93-119).  The real database is private clinical data, so tests,
demos, and benchmarks here run against synthetic records with the same
on-disk shape: 500 Hz multichannel signals (three patch accelerometer axes +
patch ECG + RHC pressure) and sidecars with ``MacStTime`` / ``MacEndTime`` /
``ChamEvents_in_s`` chamber-event dictionaries.

Waveform morphology is loosely physiological (periodic pressure pulses with
systolic/diastolic structure, SCG bursts at each heartbeat, noise) — enough
to give the noise gate, normalization, and model real structure to work on.
"""

from __future__ import annotations

import json
import os

import numpy as np

from scgrhc_torch.io.wfdb import wrrecord

SCG_CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]
ALL_CHANNELS = SCG_CHANNELS + ["RHC_pressure"]
CHAMBERS = ["PA", "RV", "RA", "PCW"]


def _rhc_pressure(t: np.ndarray, rng: np.random.Generator, chamber_idx: int) -> np.ndarray:
    """Periodic pressure waveform with per-chamber mean/pulse amplitude."""
    hr = rng.uniform(0.9, 1.5)  # beats/sec
    base = [18.0, 22.0, 6.0, 10.0][chamber_idx % 4]
    pulse = [10.0, 18.0, 4.0, 6.0][chamber_idx % 4]
    phase = (t * hr) % 1.0
    systole = np.exp(-((phase - 0.15) ** 2) / 0.006)
    dicrotic = 0.35 * np.exp(-((phase - 0.45) ** 2) / 0.004)
    resp = 1.5 * np.sin(2 * np.pi * 0.25 * t)
    noise = 0.25 * rng.standard_normal(t.shape)
    return base + pulse * (systole + dicrotic) + resp + noise


def _scg_channels(t: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(T, 4) accelerometer x3 + ECG, bursts locked to a heartbeat."""
    hr = rng.uniform(0.9, 1.5)
    phase = (t * hr) % 1.0
    out = np.empty((t.size, 4))
    for j in range(3):
        burst = np.exp(-((phase - 0.1 - 0.02 * j) ** 2) / 0.0004)
        carrier = np.sin(2 * np.pi * (20 + 6 * j) * t + rng.uniform(0, 6.28))
        out[:, j] = 0.02 * burst * carrier + 0.002 * rng.standard_normal(t.size)
    qrs = np.exp(-((phase - 0.05) ** 2) / 0.0001)
    twave = 0.2 * np.exp(-((phase - 0.3) ** 2) / 0.002)
    out[:, 3] = qrs + twave + 0.01 * rng.standard_normal(t.size)
    return out


def make_synthetic_database(
    root: str,
    n_records: int = 2,
    duration_s: float = 120.0,
    fs: int = 500,
    seed: int = 0,
    flatline_in_first: bool = True,
) -> str:
    """Create ``<root>/processed_data`` with synthetic records + sidecars.

    Each record visits all four chambers in sequence, with chamber events at
    known offsets.  When ``flatline_in_first``, a 1-s flat-line artifact is
    injected into the first record's RHC channel (inside the PA interval) so
    the noise gate has something to reject.

    Returns the processed-data directory path.
    """
    processed = os.path.join(root, "processed_data")
    os.makedirs(processed, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(duration_s * fs)
    t = np.arange(n) / fs

    for r in range(n_records):
        name = f"SYN{r:03d}"
        scg = _scg_channels(t, rng)
        # Each chamber gets an equal slice of the record.
        chamber_len = duration_s / len(CHAMBERS)
        rhc = np.empty(n)
        events: dict[str, float] = {}
        for ci, chamber in enumerate(CHAMBERS):
            s = int(ci * chamber_len * fs)
            e = int((ci + 1) * chamber_len * fs) if ci + 1 < len(CHAMBERS) else n
            rhc[s:e] = _rhc_pressure(t[s:e], rng, ci)
            events[f"{chamber}_entry"] = ci * chamber_len
        if flatline_in_first and r == 0:
            s = int(3.0 * fs)
            rhc[s : s + fs] = rhc[s]  # 1-s flat line inside the PA interval
        p_signal = np.concatenate([scg, rhc[:, None]], axis=1)
        wrrecord(
            os.path.join(processed, name),
            fs=fs,
            sig_names=ALL_CHANNELS,
            p_signal=p_signal,
            gain=1000.0,
        )
        sidecar = {
            "MacStTime": "01/01/2020 08:00:00",
            "MacEndTime": "01/01/2020 "
            + f"{8 + int(duration_s) // 3600:02d}:{(int(duration_s) % 3600) // 60:02d}:{int(duration_s) % 60:02d}",
            "ChamEvents_in_s": events,
            # Demographics + maclab measurements, shaped like the clinical
            # sidecars the cohort summary tool consumes (reference:
            # summary.py:22-33).  sbp == -1 means "missing" there.
            "age": int(rng.integers(40, 85)),
            "gender": "Male" if r % 2 == 0 else "Female",
            "weight": float(rng.uniform(55, 110)),
            "height": float(rng.uniform(150, 195)),
            "sbp": -1 if r == 0 else int(rng.integers(95, 160)),
            "dbp": int(rng.integers(55, 95)),
            "NYHAC": int(rng.integers(1, 5)),
            "Missing_MaclabRHC": False,
            "fine_alignment": bool(r % 2),
            "outpatient": True,
            "maclabMeas": {
                " PAS": float(rng.uniform(15, 60)),
                "PAD ": float(rng.uniform(5, 30)),
                "PAM": float(rng.uniform(10, 40)),
                "RVS": "n/a" if r == 0 else float(rng.uniform(15, 60)),
            },
        }
        with open(os.path.join(processed, f"{name}.json"), "w") as f:
            json.dump(sidecar, f)
    return processed
