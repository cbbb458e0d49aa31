"""The port's C WFDB decoder (its own copy of ``scgrhc.native``).

``_wfdbfast.c`` decodes a ``.dat`` signal group and calibrates it in one
pass.  It is built at first use with the host C compiler into
``build/scgrhc_torch/`` at the root of the checkout (the file name carries
a hash of the source and the flags, so a finished build is reused) and
bound with ctypes; no step needs ``nvcc`` or a card.
:func:`scgrhc_torch.io.wfdb.rdrecord` sends every single-frame group in
formats 16/24/32/61/80/160/212 here.  There is no NumPy fallback: a build
that fails raises ``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from scgrhc_torch.ops.kernels._build import BUILD_DIR, Build

SOURCE = Path(__file__).with_name("_wfdbfast.c")
COMPILERS = ("cc", "gcc")  # the first one on PATH builds the library
# No -ffast-math or -Ofast: each value must keep NumPy's bits, (v - base) / gain.
CFLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# raw, len, fmt, n_sig, sig_len, baselines, gains, out, out_stride, cols, avail, total
_ARGTYPES = (_P, _I64, ctypes.c_int, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P)
_BAD_SIZE, _BAD_FORMAT, _SHORT, _NO_MEMORY = 1, 2, 3, 4  # _wfdbfast.c's return codes

_lock = threading.Lock()
_build: Build | None = None


def _compile(out: Path) -> tuple[float, str]:
    """Compile the library to ``out``: written under a name of this
    process's own, then renamed, so processes building at once each load a
    whole file."""
    cc = next(filter(None, map(shutil.which, COMPILERS)), None)
    if cc is None:
        raise RuntimeError(
            f"no C compiler found (looked for {', '.join(COMPILERS)} on PATH): the port's "
            "WFDB decoder is built from source at first use")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cc, *CFLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building the WFDB decoder failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the WFDB decoder failed (rc {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build() -> Build:
    """Compile (once per process, and only if the source or flags changed)
    and load."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        digest = hashlib.sha1(" ".join(CFLAGS).encode() + SOURCE.read_bytes()).hexdigest()
        out = BUILD_DIR / f"libscgrhc_wfdb-{digest[:12]}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            seconds, log = _compile(out)
        lib = ctypes.CDLL(str(out))
        lib.scgrhc_decode_calibrate.argtypes = list(_ARGTYPES)
        lib.scgrhc_decode_calibrate.restype = ctypes.c_int
        _build = Build(lib, out, seconds, log)
        return _build


def decode_calibrate_into(raw, fmt: int, sig_len: int, baselines, gains,
                          out: np.ndarray, cols) -> None:
    """Decode ``raw`` (a ``.dat``'s bytes: ``len(cols)`` interleaved signals
    of ``sig_len`` samples) and write signal ``s``'s physical values,
    ``(adc - baselines[s]) / gains[s]`` (a gain of 0 reads as 200) with
    sentinels as NaN, into column ``cols[s]`` of ``out``, a C-contiguous
    float64 (sig_len, n) array.  Raises ``ValueError`` for an unsupported
    format or a ``.dat`` shorter than ``sig_len`` promises."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    base = np.ascontiguousarray(baselines, dtype=np.float64)
    gain = np.ascontiguousarray(gains, dtype=np.float64)
    n_sig = cols.size
    if n_sig <= 0 or sig_len < 0:
        raise ValueError("n_sig/sig_len out of range")
    if base.shape != (n_sig,) or gain.shape != (n_sig,):
        raise ValueError(f"{n_sig} signals but {base.size} baselines and {gain.size} gains")
    if not (out.dtype == np.float64 and out.ndim == 2 and out.flags.c_contiguous
            and out.flags.writeable and out.shape[0] == sig_len):
        raise ValueError(f"out must be a writable C-contiguous float64 ({sig_len}, n) array, "
                         f"got {out.dtype} {out.shape}")
    if cols.min() < 0 or cols.max() >= out.shape[1]:
        raise ValueError(f"columns {cols.tolist()} out of range for {out.shape[1]}")
    avail, total = ctypes.c_int64(), ctypes.c_int64()
    err = build().lib.scgrhc_decode_calibrate(
        buf.ctypes.data, buf.size, int(fmt), n_sig, sig_len, base.ctypes.data,
        gain.ctypes.data, out.ctypes.data, out.shape[1], cols.ctypes.data,
        ctypes.byref(avail), ctypes.byref(total))
    if err == _BAD_SIZE:
        raise ValueError("n_sig/sig_len out of range")
    if err == _BAD_FORMAT:
        raise ValueError(f"Unsupported WFDB format {fmt}")
    if err == _SHORT:
        raise ValueError(f".dat holds {avail.value} samples but header promises {total.value}")
    if err == _NO_MEMORY:
        raise MemoryError("the WFDB decoder could not allocate its gains")


def decode_calibrate(raw, fmt: int, n_sig: int, sig_len: int, baselines, gains) -> np.ndarray:
    """Decode a WFDB ``.dat`` byte stream and apply baseline/gain
    calibration in one pass -> float64 (sig_len, n_sig), as
    ``scgrhc.native.decode_calibrate``."""
    out = np.empty((sig_len, n_sig), dtype=np.float64)
    decode_calibrate_into(raw, fmt, sig_len, baselines, gains, out, np.arange(n_sig))
    return out
