"""Plain versions and launch plumbing of the conv1d(k=3, padding=1) layer
kernels, the Python side of ``scgrhc_torch/csrc/conv3.cuh``.

One layer is ``c = conv1d(x, w, padding=1) + b`` followed by a mode:
``linear`` (``c``), ``relu`` or ``in_relu`` (one-pass instance norm, then
relu).  :mod:`.conv_block` (the generator's layer, always ``in_relu``) and
:mod:`.critic_fused` (the critic's layer in all three modes) wrap the same
kernels and take the same plain versions here, written from the Pallas
kernels' formulas (``scgrhc/ops/pallas/conv_block.py:82-122``,
``critic_fused.py:132-164``):

  * dc: the mode's backward at the conv output, in f32 (f64 for f64 input);
    ``in_relu``: ``dc = rsig·(g − mean_T g − x̂·mean_T(g·x̂))``,
    ``g = dy·(x̂ > 0)``;
  * dx: ``conv3_t(w, dc)``, the adjoint of the conv, in x's dtype;
  * dw, db: summed over samples and steps, in f32.

dx and dw take dc rounded to x's dtype, db the unrounded dc, as the Pallas
kernels do.  Every plain version is differentiable PyTorch, so the critic's
second-order gradient can differentiate it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scgrhc_torch.ops.kernels import _build
from scgrhc_torch.ops.nn import IN_EPS, instance_norm, stats_dtype

MODES = ("linear", "relu", "in_relu")
MODE_CODE = {m: i for i, m in enumerate(MODES)}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# dw's first stage splits the samples so that about this many blocks run
# (two per SM of an H100)
DW_BLOCKS = 264
DW_TILE = 64  # the kernel's output tile, both axes


def conv(x, w, b):
    """``conv1d(x, w, padding=1) + b`` on the inputs upcast to f32 (f64 for
    f64 input)."""
    acc = stats_dtype(x.dtype)
    return F.conv1d(x.to(acc), w.to(acc), padding=1) + b.to(acc)[None, :, None]


def activation(c, mode: str):
    if mode == "in_relu":
        return torch.relu(instance_norm(c))
    if mode == "relu":
        return torch.relu(c)
    return c


def layer_plain(x, w, b, mode: str):
    """The layer's forward, cast to x's dtype."""
    return activation(conv(x, w, b), mode).to(x.dtype)


def dc_from_dy(dy, c, mode: str):
    """The cotangent at the conv output ``c`` for the output cotangent
    ``dy``, both in the statistics dtype."""
    if mode == "linear":
        return dy
    if mode == "relu":
        return dy * (c > 0)
    mean = c.mean(dim=-1, keepdim=True)
    msq = (c * c).mean(dim=-1, keepdim=True)
    rsig = torch.rsqrt(torch.clamp_min(msq - mean * mean, 0.0) + IN_EPS)
    xhat = (c - mean) * rsig
    g = dy * (xhat > 0)
    return rsig * (
        g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True)
    )


def layer_bwd_plain(x, w, b, dy, mode: str, need_dx: bool = True, need_dw: bool = True):
    """``(dx, dw, db)`` of the layer at ``dy``; dx in x's dtype (None unless
    ``need_dx``), dw (O, C, 3) and db (O,) in f32 (None unless ``need_dw``)."""
    acc = stats_dtype(x.dtype)
    x32, w32 = x.to(acc), w.to(acc)
    c = None if mode == "linear" else conv(x, w, b)
    dc = dc_from_dy(dy.to(acc), c, mode)
    dcd = dc.to(x.dtype).to(acc)
    dx = dw = db = None
    if need_dx:
        dx = F.conv_transpose1d(dcd, w32, padding=1).to(x.dtype)
    if need_dw:
        t = x.shape[-1]
        xp = F.pad(x32, (1, 1))
        dw = torch.stack(
            [torch.einsum("not,nit->oi", dcd, xp[..., k:k + t]) for k in range(3)], dim=-1
        )
        db = dc.sum(dim=(0, 2))
    return dx, dw, db


def dw_splits(n: int, cin: int, cout: int) -> int:
    """Sample splits of dw's first stage (the kernel's ``nsplit``)."""
    tiles = -(-cout // DW_TILE) * -(-(3 * cin) // DW_TILE)
    return max(1, min(n, -(-DW_BLOCKS // tiles)))


def check_inputs(what: str, x, w, b, dy=None) -> None:
    """Raise on what the kernels do not take: dtypes other than float32 or
    bfloat16, mixed dtypes or devices, wrong shapes, non-contiguous
    tensors, N or T out of range."""
    ts = (x, w, b) if dy is None else (x, w, b, dy)
    if x.dtype not in DTYPE_CODE or any(t.dtype != x.dtype for t in ts):
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 tensors of one dtype, got "
            f"{[t.dtype for t in ts]}"
        )
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"{what} expects x (N, C_in, T), w (O, C_in, 3), b (O,)")
    n, cin, t = x.shape
    o = w.shape[0]
    if w.shape != (o, cin, 3) or b.shape != (o,) or (dy is not None and dy.shape != (n, o, t)):
        raise ValueError(
            f"{what} shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)}" + ("" if dy is None else f", dy {tuple(dy.shape)}")
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    max_len = _build.library().scgrhc_conv_in_relu_max_len()
    if not (1 <= n <= 65535 and 1 <= t <= max_len):
        raise ValueError(
            f"{what} kernel takes 1 <= N <= 65535 and 1 <= T <= {max_len}, got N={n}, T={t}"
        )


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_fwd(entry: str, what: str, x, w, b, mode: str | None = None):
    """The forward kernel ``entry`` on CUDA tensors → y (N, O, T) in x's
    dtype.  ``mode`` None is the in_relu-only entry point (no mode arg)."""
    check_inputs(what, x, w, b)
    n, cin, t = x.shape
    o = w.shape[0]
    y = torch.empty((n, o, t), dtype=x.dtype, device=x.device)
    extra = () if mode is None else (MODE_CODE[mode],)
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), entry)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, cin, o, t, *extra,
            DTYPE_CODE[x.dtype], _stream(x),
        )
    _build.check(err, what)
    return y


def launch_bwd(entry: str, what: str, x, w, b, dy, mode: str | None, need_dx: bool,
               need_dw: bool):
    """The backward kernel ``entry`` on CUDA tensors → ``(dx, dw, db)`` as
    :func:`layer_bwd_plain` gives them.  The f32 scratch for dc (N, O, T)
    and for dw's per-split partial sums is allocated here."""
    check_inputs(what, x, w, b, dy)
    n, cin, t = x.shape
    o = w.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    dc = torch.empty((n, o, t), **f32)
    dx = torch.empty_like(x) if need_dx else None
    dw = db = part = None
    nsplit = dw_splits(n, cin, o)
    if need_dw:
        dw = torch.empty((o, cin, 3), **f32)
        db = torch.empty((o,), **f32)
        part = torch.empty((nsplit, o, 3 * cin), **f32)
    extra = () if mode is None else (MODE_CODE[mode],)
    ptrs = [None if v is None else v.data_ptr() for v in (x, w, b, dy, dx, dw, db, dc, part)]
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), entry)(
            *ptrs, n, cin, o, t, *extra, nsplit, DTYPE_CODE[x.dtype], _stream(x)
        )
    _build.check(err, what)
    return dx, dw, db


def on_cpu(x, what: str) -> bool:
    """True for a CPU tensor (the plain version runs); False for CUDA (the
    kernel runs); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False
