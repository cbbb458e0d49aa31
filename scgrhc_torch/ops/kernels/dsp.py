"""K3 and K4: the DSP kernels over framed windows.

* K3, :func:`gate_and_normalize`, replaces the TPU kernel
  ``scgrhc/ops/pallas/dsp.py::gate_and_normalize`` (its
  ``_gate_norm_kernel``): the data stage's noise gate and per-window min-max
  normalization, one launch per chamber interval (``data_backend:
  "device"``).  CUDA source ``scgrhc_torch/csrc/gate_normalize.cu``.
* K4, :func:`normalize_windows`, replaces ``normalize_windows`` (its
  ``_norm_kernel``): the serving path's joint (C, T) min-max normalization.
  CUDA source ``scgrhc_torch/csrc/normalize_windows.cu``.

Both are bound by bytes and run one block per window, with NaN propagated
explicitly, so that a window holding a sentinel sample normalizes to all
NaN, as the plain versions and the JAX path do.  K3 takes any T (with
C·T < 2³¹): it stages the rhc window in shared memory up to
:func:`gate_stage_max_len` samples and reads longer ones again from global
memory, and holds the scg window in registers up to C·T = 6,144, reading
the rest again.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from scgrhc_torch.dsp.noise import FLAT_THRESHOLD, FLAT_WINDOW_S, R2_THRESHOLD
from scgrhc_torch.io.catalog import SAMPLE_FREQ
from scgrhc_torch.ops.kernels import _build

NORM_EPS = 1e-4  # reference: recordutil.py:46
FLAT_WIN = int(FLAT_WINDOW_S * SAMPLE_FREQ)  # 50 samples
# K3's shared memory (csrc/gate_normalize.cu): the flat scan takes 2048
# positions a tile in four buffers of 2048 + win - 1 floats, beside the
# staged rhc window, within the block's 232,448-byte opt-in less 1 KB for
# the static reduction buffers.
_GATE_TILE, _SMEM_OPTIN, _STATIC_RESERVE = 2048, 232_448, 1024


def gate_stage_max_len(win: int = FLAT_WIN) -> int:
    """The longest rhc window K3 stages in shared memory (49,468 samples at
    win = 50); a longer one is read again from global memory.  Not a limit:
    the kernel takes any T."""
    return (_SMEM_OPTIN - _STATIC_RESERVE - 16 * (_GATE_TILE + win - 1)) // 4


def _minmax_norm(x, dims):
    lo = x.amin(dim=dims, keepdim=True)  # amin/amax propagate NaN
    hi = x.amax(dim=dims, keepdim=True)
    return (x - lo) / (hi - lo + NORM_EPS), lo, hi


def gate_and_normalize_plain(scg_windows, rhc_windows, min_rhc: float):
    """K3's plain version, in float32 like the kernel and the JAX path.

    Decisions as :func:`scgrhc_torch.dsp.segment.gate_windows` (flat: the
    sliding max − min over ``FLAT_WINDOW_S`` is below ``FLAT_THRESHOLD`` at
    two or more positions; straight: OLS r² > ``R2_THRESHOLD``, 1 where
    sxx·syy is not positive; below: any sample < ``min_rhc``)."""
    scg, rhc = scg_windows.float(), rhc_windows.float()
    n, c, t = scg.shape
    if t >= FLAT_WIN:
        w = rhc.unfold(-1, FLAT_WIN, 1)
        flat = ((w.amax(-1) - w.amin(-1)) < FLAT_THRESHOLD).sum(-1) >= 2
    else:
        flat = torch.zeros(n, dtype=torch.bool, device=rhc.device)
    xc = torch.arange(t, dtype=torch.float32, device=rhc.device) - (t - 1) / 2.0
    yc = rhc - rhc.mean(-1, keepdim=True)
    denom = (xc * xc).sum() * (yc * yc).sum(-1)
    num = (yc * xc).sum(-1)
    pos = denom > 0
    r2 = torch.where(pos, num * num / torch.where(pos, denom, torch.ones_like(denom)),
                     torch.ones_like(denom))
    keep = ~(flat | (r2 > R2_THRESHOLD) | (rhc < min_rhc).any(-1))
    rhc_n, r_lo, r_hi = _minmax_norm(rhc, (1,))
    scg_n, s_lo, s_hi = _minmax_norm(scg, (1, 2))
    return (keep, scg_n, rhc_n, torch.cat((s_lo[:, :, 0], s_hi[:, :, 0]), 1),
            torch.cat((r_lo, r_hi), 1))


def gate_and_normalize(scg_windows, rhc_windows, min_rhc: float):
    """scg_windows (N, C, T), rhc_windows (N, T) → (keep (N,) bool,
    scg_norm (N, C, T), rhc_norm (N, T), mm_scg (N, 2), mm_rhc (N, 2)).

    Tensors on the CPU take :func:`gate_and_normalize_plain`.  CUDA tensors
    launch the kernel, which takes contiguous float32 tensors of those
    shapes on one device, with N, C, T > 0 and C·T < 2³¹, and raises on
    anything else."""
    devices = {scg_windows.device.type, rhc_windows.device.type}
    if devices == {"cpu"}:
        return gate_and_normalize_plain(scg_windows, rhc_windows, min_rhc)
    if devices != {"cuda"} or scg_windows.device != rhc_windows.device:
        raise ValueError(f"gate_and_normalize: unsupported devices {scg_windows.device}, "
                         f"{rhc_windows.device}")
    for x, dim in ((scg_windows, 3), (rhc_windows, 2)):
        if x.dtype != torch.float32 or x.dim() != dim or not x.is_contiguous():
            raise ValueError(
                "gate_and_normalize kernel takes contiguous float32 scg (N, C, T) and rhc "
                f"(N, T), got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
            )
    n, c, t = scg_windows.shape
    if tuple(rhc_windows.shape) != (n, t) or min(n, c, t) == 0 or c * t >= 2**31:
        raise ValueError(f"gate_and_normalize: shapes {tuple(scg_windows.shape)} and "
                         f"{tuple(rhc_windows.shape)} (N, C, T > 0, C·T < 2^31)")
    dev = scg_windows.device
    scg_n, rhc_n = torch.empty_like(scg_windows), torch.empty_like(rhc_windows)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    mm_scg = torch.empty(n, 2, dtype=torch.float32, device=dev)
    mm_rhc = torch.empty_like(mm_scg)
    # a device guard only where the launch is not on the current device:
    # entering one costs a few microseconds of host time a call
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _build.library().scgrhc_gate_normalize(
            scg_windows.data_ptr(), rhc_windows.data_ptr(), scg_n.data_ptr(),
            rhc_n.data_ptr(), keep.data_ptr(), mm_scg.data_ptr(), mm_rhc.data_ptr(),
            n, c, t, FLAT_WIN, ctypes.c_float(min_rhc),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "gate_and_normalize")
    gate_and_normalize.launches += 1
    return keep, scg_n, rhc_n, mm_scg, mm_rhc


gate_and_normalize.launches = 0


def frame_windows(scg_signal: np.ndarray, rhc_signal: np.ndarray, segment_samples: int):
    """scg_signal (L, C), rhc_signal (L,) → contiguous float32 windows
    scg (N, C, T) and rhc (N, T), N = L // T (tail truncated).  The samples
    are cast to float32, as ``jnp.asarray`` does with x64 off."""
    num = scg_signal.shape[0] // segment_samples
    total = num * segment_samples
    scg_w = np.ascontiguousarray(
        scg_signal[:total].reshape(num, segment_samples, -1).transpose(0, 2, 1), np.float32)
    rhc_w = np.ascontiguousarray(rhc_signal[:total].reshape(num, segment_samples), np.float32)
    return scg_w, rhc_w


def segment_record_on_device(scg_signal: np.ndarray, rhc_signal: np.ndarray,
                             segment_samples: int, min_rhc: float, device):
    """Frame one interval into non-overlapping windows (tail truncated,
    reference: recordutil.py:136-148) and run K3 on ``device``.

    scg_signal (L, C), rhc_signal (L,) → the returns of
    :func:`gate_and_normalize`, on ``device``, plus the (N,) window starts.
    The samples are framed on the host (:func:`frame_windows`), so the
    device sees one upload and K3."""
    num = scg_signal.shape[0] // segment_samples
    if num == 0:
        z = np.zeros(0)
        return z.astype(bool), z, z, z, z, z.astype(np.int64)
    scg_w, rhc_w = frame_windows(scg_signal, rhc_signal, segment_samples)
    out = gate_and_normalize(torch.from_numpy(scg_w).to(device),
                             torch.from_numpy(rhc_w).to(device), min_rhc)
    return (*out, np.arange(num, dtype=np.int64) * segment_samples)


def normalize_windows_plain(w):
    """``(w − lo) / (hi − lo + NORM_EPS)`` with lo/hi over each window's
    (C, T) values; ``amin``/``amax`` propagate NaN."""
    return _minmax_norm(w, (1, 2))[0]


def normalize_windows(w):
    """w (N, C, T) → (N, C, T).

    A tensor on the CPU takes :func:`normalize_windows_plain`.  A CUDA
    tensor launches the kernel, which takes a contiguous float32 (N, C, T)
    tensor and raises on anything else."""
    if w.device.type == "cpu":
        return normalize_windows_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"normalize_windows: unsupported device {w.device}")
    if w.dtype != torch.float32 or w.dim() != 3 or not w.is_contiguous():
        raise ValueError(
            "normalize_windows kernel takes a contiguous float32 (N, C, T) tensor, "
            f"got {w.dtype} {tuple(w.shape)} contiguous={w.is_contiguous()}"
        )
    n, c, t = w.shape
    if n == 0 or c * t == 0:
        raise ValueError(f"normalize_windows: empty windows {tuple(w.shape)}")
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        err = _build.library().scgrhc_normalize_windows(
            w.data_ptr(), out.data_ptr(), n, c * t,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    _build.check(err, "normalize_windows")
    normalize_windows.launches += 1
    return out


normalize_windows.launches = 0
