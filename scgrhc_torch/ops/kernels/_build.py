"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``scgrhc_torch/csrc/*.cu`` goes into one shared library for
``sm_90a`` in ``build/scgrhc_torch/`` at the root of the checkout: one
``nvcc`` process per source, all started together, then one link.  The
library's name carries a hash of the sources, headers and flags, so an
edited source builds anew and a finished build is reused.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, b, y, c, ws, n, cin, cout, len, mode, dtype, stream
    "scgrhc_layer_fwd": (_P,) * 6 + (_I,) * 6 + (_P,),
    # x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats, n, cin, cout, len, mode, nsplit,
    # dtype, stream
    "scgrhc_layer_bwd": (_P,) * 12 + (_I,) * 7 + (_P,),
    # x, w, b, c, part, sums, ws, n, cin, cout, len, dtype, stream
    "scgrhc_conv_in_relu_part": (_P,) * 7 + (_I,) * 5 + (_P,),
    # c, sums, y, n, cout, len, count, dtype, stream
    "scgrhc_conv_in_relu_apply": (_P,) * 3 + (_I,) * 5 + (_P,),
    # c, stats, dy, v, dcc, n, cout, len, mode, stream
    "scgrhc_critic_layer_dx_vjp": (_P,) * 5 + (_I,) * 4 + (_P,),
    # n, cin, cout, len, mode, pass, dtype, out (int[12])
    "scgrhc_layer_plan": (_I,) * 7 + (_P,),
    # n, cin, cout, dtype, out (int[3])
    "scgrhc_dw_plan": (_I,) * 4 + (_P,),
    # out (long long[3])
    "scgrhc_dw_copy_launches": (_P,),
    # w, out, n, m, stream
    "scgrhc_normalize_windows": (_P, _P, _I, _I, _P),
    # scg, rhc, scg_out, rhc_out, keep, mm_scg, mm_rhc, n, c, t, win, min_rhc, stream
    "scgrhc_gate_normalize": (_P,) * 7 + (_I,) * 4 + (ctypes.c_float, _P),
    # n, stream: an empty kernel on K3's grid, for the launch floor
    "scgrhc_gate_normalize_floor": (_I, _P),
}


@dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile and link time; 0.0 when a finished build was reused
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


def _run(procs: dict, t0: float) -> str:
    """Wait for every ``nvcc`` process; their output, or raise on a failure."""
    logs, failed = [], []
    for what, (cmd, proc) in procs.items():
        text = proc.communicate()[0]
        logs.append(f"== {what}, done {time.perf_counter() - t0:.1f} s after the start\n{text}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _compile(sources: list[Path], out: Path) -> tuple[float, str]:
    """Compile each source to an object, all at once, then link the shared
    library to ``out`` (written under a temporary name, then renamed)."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{out.stem}.{src.stem}.{tag}.o") for src in sources]
    t0 = time.perf_counter()
    try:
        log = _run({src.name: _start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                    for src, obj in zip(sources, objs)}, t0)
        compiled = time.perf_counter() - t0
        tmp = out.with_name(f"{out.name}.{tag}")
        log += _run({"link": _start([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                     *map(str, objs)])}, t0)
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    return seconds, log + f"== compile {compiled:.1f} s, with link {seconds:.1f} s\n"


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
            seconds, log = _compile(sources, out)
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
