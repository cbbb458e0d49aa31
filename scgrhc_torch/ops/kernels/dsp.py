"""K4: per-window joint min-max normalization.

Replaces the TPU kernel ``scgrhc/ops/pallas/dsp.py::normalize_windows``
(its ``_norm_kernel``).  The CUDA source is ``scgrhc_torch/csrc/
normalize_windows.cu``: one block per window, bound by bytes (one read
and one write of the window), with NaN propagated explicitly so that a
window holding a sentinel sample normalizes to all NaN, as the plain
version and the JAX path do.
"""

from __future__ import annotations

import torch

from scgrhc_torch.ops.kernels import _build

NORM_EPS = 1e-4  # reference: recordutil.py:46


def normalize_windows_plain(w):
    """``(w − lo) / (hi − lo + NORM_EPS)`` with lo/hi over each window's
    (C, T) values; ``amin``/``amax`` propagate NaN."""
    lo = w.amin(dim=(1, 2), keepdim=True)
    hi = w.amax(dim=(1, 2), keepdim=True)
    return (w - lo) / (hi - lo + NORM_EPS)


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
