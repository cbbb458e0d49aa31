"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``scgrhc_torch/csrc/*.cu`` goes into one shared library, compiled by
one ``nvcc`` call for ``sm_90a`` into ``build/scgrhc_torch/`` at the root
of the checkout.  The library's name carries a hash of the sources, headers
and flags, so an edited source builds anew and a finished build is reused.
Each C entry point takes raw pointers, sizes and the CUDA stream, and
returns the launch's ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "scgrhc_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, b, y, n, cin, cout, len, dtype, stream
    "scgrhc_conv_in_relu": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len, nsplit, dtype, stream
    "scgrhc_conv_in_relu_bwd": (_P,) * 9 + (_I,) * 6 + (_P,),
    "scgrhc_conv_in_relu_max_len": (),
    # x, w, b, y, n, cin, cout, len, mode, dtype, stream
    "scgrhc_critic_layer_fwd": (_P,) * 4 + (_I,) * 6 + (_P,),
    # x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len, mode, nsplit, dtype, stream
    "scgrhc_critic_layer_bwd": (_P,) * 9 + (_I,) * 7 + (_P,),
    # w, out, n, m, stream
    "scgrhc_normalize_windows": (_P, _P, _I, _I, _P),
}


@dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when a finished build was reused
    log: str  # nvcc's output, including the -Xptxas -v resource lines


_lock = threading.Lock()
_build: Build | None = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the scgrhc_torch CUDA kernels are built from source at first use"
    )


def build() -> Build:
    """Compile (once per process, and only if the sources changed) and load."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        sources = sorted(CSRC_DIR.glob("*.cu"))
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC_DIR.glob("*.cu*")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        out = BUILD_DIR / f"libscgrhc_kernels-{digest.hexdigest()[:12]}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _build = Build(lib, out, seconds, log)
        return _build


def library() -> ctypes.CDLL:
    return build().lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
