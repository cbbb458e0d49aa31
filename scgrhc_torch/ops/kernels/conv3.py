"""Plain versions and launch plumbing of the conv1d(k=3, padding=1) layer
kernels, the Python side of ``scgrhc_torch/csrc/conv_layer.cu`` over
``conv3.cuh``.

One layer is ``c = conv1d(x, w, padding=1) + b`` followed by a mode:
``linear`` (``c``), ``relu`` or ``in_relu`` (one-pass instance norm, then
relu).  :mod:`.conv_block` (the generator's layer, always ``in_relu``) and
:mod:`.critic_fused` (the critic's layer in all three modes) launch the
same kernels through :func:`launch_fwd` and :func:`launch_bwd` (the
layer's entry points, ``scgrhc_layer_fwd`` and ``scgrhc_layer_bwd``) and
take the same plain versions here, written from the Pallas
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

Both layers run one set of kernels: the conv passes (forward, the dc
pass's recompute of c, dx) follow :func:`conv_plan`, the dw stage
:func:`dw_plan`.  :data:`path_launches` counts the conv kernels' launches
by path, :data:`dw_path_launches` the dw stage's.  The kernels take any
non-empty shape, but for one limit that :func:`check_inputs` states: below
16 output channels, dw holds one sample's dc in a block's shared memory
(:func:`dw_stream_max_len`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from scgrhc_torch.ops.kernels import _build
from scgrhc_torch.ops.nn import IN_EPS, instance_norm, stats_dtype

MODES = ("linear", "relu", "in_relu")
MODE_CODE = {m: i for i, m in enumerate(MODES)}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# dw's first stage (csrc/conv3.cuh: dw_plan) takes one of three paths by
# dtype and shape.  Below DW_STREAM_BELOW output channels (the critic's
# 512 -> 1 score layer), a stream over x ("stream"), a block per
# DW_STREAM_C input channels, with db's partial sums in one more column of
# the scratch.  Else in f32 the product on Hopper's warpgroup MMA
# ("wgmma"), a block per DW_WG_TILE_O output channels x DW_WG_TILE_C input
# channels (x 3 taps); in bf16 the product on mma.sync ("mma"), a block
# per DW_TILE_O x DW_TILE_C.  Each splits the samples so that at most
# DW_STREAM_BLOCKS (four per SM of an H100, to keep loads in flight),
# DW_WG_BLOCKS (one per SM) or DW_BLOCKS (two per SM) blocks run, one
# wave, as many as the samples allow.
DW_STREAM_BELOW = 16
DW_TILE_O, DW_TILE_C, DW_STREAM_C = 64, 32, 32
DW_WG_TILE_O, DW_WG_TILE_C = 64, 64
DW_BLOCKS, DW_STREAM_BLOCKS, DW_WG_BLOCKS = 264, 528, 132
DW_PATHS = ("mma", "stream", "wgmma")


# The conv passes of both layers (csrc/conv3.cuh: conv_plan).  The forward
# and the dc pass's recompute run the tensor-core product; dx is the
# product over dc with K = 3 O, whose columns are the input channels.  In
# f32 ("wgmma") the product runs over tiles of wg_tile_m(columns) steps x
# wg_tile_n(columns) columns of one sample, which a persistent grid of at
# most WG_BLOCKS blocks (an H100's SMs) walks, from weights split into a
# scratch once a launch (wsplit_numel); in bf16 ("mma") over tiles of
# MMA_TILE_M columns x MMA_TILE_N steps, a block each.  Below
# CONV_STREAM_BELOW output channels (the 512 -> 1 score layer) the
# forward streams over x and dx over dc ("stream"), a block per
# CONV_STREAM_STEPS steps of one sample.  The instance norm, a relu the
# stream kernel cannot apply and the dc formulas go to a row pass, a warp
# per (n, o) row, ROW_WARPS rows a block.  The plan is for n samples; the
# launchers take it for each chunk of at most SAMPLE_CHUNK samples (a grid
# axis's extent).
CONV_STREAM_BELOW = 16
WG_TILE_C, WG_BLOCKS = 8, 132
MMA_TILE_M, MMA_TILE_N, CONV_STREAM_STEPS = 64, 128, 64
ROW_WARPS = 8
SAMPLE_CHUNK = 65535
# The in_relu forward's rows longer than ROW_PIECE steps (the continuous
# mode's whole record) take the row pass in pieces of ROW_PIECE steps, a
# block each, whose (sum, sum of squares) go to the scratch after c and
# are added in a fixed order into one pair a row, after them: row_parts
# pieces a row.
ROW_PIECE = 8192
PASSES = ("fwd", "dc", "dx")
PATHS = ("none", "mma", "stream", "wgmma")

# dw's stream (O < DW_STREAM_BELOW) holds one sample's dc, O x (T + 2)
# f32, in one block's shared memory: the 232,448 bytes a block may take on
# sm_90 (H100) less 6 KB for the kernel's static sums (csrc/conv3.cuh:
# kDwStreamDcBytes).
DW_STREAM_DC_BYTES = 232448 - 6 * 1024


@dataclass(frozen=True)
class ConvPlan:
    path: str  # one of PATHS; "none" for the linear dc pass (dc = dy)
    grid: tuple[int, int, int]  # the conv kernel's blocks (x, y, z)
    row_blocks: int  # blocks of the row pass after it (a warp a row), 0 for none
    scratch: tuple[int, int, int] | None  # the forward's f32 c, allocated by the wrapper
    row_parts: int = 0  # pieces a row where the row pass runs in pieces, else 0
    # the "wgmma" path's (step tiles, column tiles, samples), which its
    # persistent grid walks; None elsewhere (a block a tile)
    tiles: tuple[int, int, int] | None = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wg_tile_n(cols: int) -> int:
    """The f32 core's tile width for a product of ``cols`` columns: the
    least of 8, 16, 32, 64 and 128 that holds them, else 128."""
    return next((bn for bn in (8, 16, 32, 64) if cols <= bn), 128)


def wg_tile_m(cols: int) -> int:
    """The f32 core's steps a tile for a product of ``cols`` columns: 256
    (two m64 tiles a consumer warpgroup) at tile widths of 16 and less,
    else 128."""
    return 256 if wg_tile_n(cols) <= 16 else 128


def wsplit_numel(kdim: int, cols: int) -> int:
    """The f32 elements of the split weights the f32 core reads for a
    product of ``cols`` columns over ``kdim`` source channels: a big and a
    small plane of 3 taps for each tile of columns and each WG_TILE_C
    source channels (csrc/conv3.cuh: wsplit_numel)."""
    bn = wg_tile_n(cols)
    return _cdiv(cols, bn) * _cdiv(kdim, WG_TILE_C) * 2 * 3 * bn * WG_TILE_C


def conv_plan(n: int, cin: int, cout: int, t: int, mode: str, pass_: str = "fwd",
              dtype=torch.float32) -> ConvPlan:
    """The launch plan of one conv pass of the layer for x (n, cin, t) in
    ``dtype`` and cout output channels, as the C launchers take it."""
    if pass_ not in PASSES or mode not in MODES or dtype not in DTYPE_CODE:
        raise ValueError(f"conv_plan: pass {pass_!r}, mode {mode!r}, dtype {dtype}")
    if pass_ == "dc" and mode == "linear":
        return ConvPlan("none", (0, 0, 0), 0, None)
    cols = cin if pass_ == "dx" else cout
    stream = cout < CONV_STREAM_BELOW
    tiles = None
    if stream:
        path, grid = "stream", (_cdiv(t, CONV_STREAM_STEPS), n, 1)
    elif dtype == torch.float32:
        path = "wgmma"
        tiles = (_cdiv(t, wg_tile_m(cols)), _cdiv(cols, wg_tile_n(cols)), n)
        grid = (min(tiles[0] * tiles[1] * tiles[2], WG_BLOCKS), 1, 1)
    else:
        path, grid = "mma", (_cdiv(t, MMA_TILE_N), _cdiv(cols, MMA_TILE_M), n)
    if pass_ == "dx":
        return ConvPlan(path, grid, 0, None, tiles=tiles)
    row = mode == "in_relu" or (mode == "relu" and (stream or pass_ == "dc"))
    pieces = pass_ == "fwd" and mode == "in_relu" and t > ROW_PIECE
    rows = _cdiv(n * cout, ROW_WARPS) if row and not pieces else 0
    return ConvPlan(path, grid, rows, (n, cout, t) if pass_ == "fwd" and row else None,
                    _cdiv(t, ROW_PIECE) if pieces else 0, tiles)


def bwd_wsplit_numel(n: int, cin: int, cout: int, t: int, mode: str, need_dx: bool,
                     dtype=torch.float32) -> int:
    """The f32 elements of the backward's split-weight scratch: the larger
    of what the dc pass's recompute and dx read on the f32 core (one
    scratch, in turn), 0 where neither runs there."""
    dc = conv_plan(n, cin, cout, t, mode, "dc", dtype).path == "wgmma"
    dx = need_dx and conv_plan(n, cin, cout, t, mode, "dx", dtype).path == "wgmma"
    return max(wsplit_numel(cin, cout) if dc else 0, wsplit_numel(cout, cin) if dx else 0)


# The conv kernels' launches by path (PATHS but "none"), one a pass and
# chunk of samples, as the wrappers make them: a run can show that every
# f32 conv of the training step went through the warpgroup-MMA core.
path_launches = {"wgmma": 0, "mma": 0, "stream": 0}


def count_launches(plan: ConvPlan, n: int) -> None:
    """Add a pass's conv-kernel launches for n samples to :data:`path_launches`."""
    if plan.path != "none":
        path_launches[plan.path] += _cdiv(n, SAMPLE_CHUNK)


# The dw stage's launches by path (DW_PATHS), one a backward with dw, as
# the wrappers make them: a run can show that every f32 dw from
# DW_STREAM_BELOW output channels went through the warpgroup MMA.
dw_path_launches = {"wgmma": 0, "mma": 0, "stream": 0}

# How the warpgroup-MMA dw stage's launches copied their rows
# (dw_copy_launches): by the TMA unit's tensor-map boxes; by cp.async where
# no map fits (odd T, an odd channel count where T = 2 mod 4, tensors not
# 16-byte aligned); by cp.async where a map fits but the driver could not
# make it, which runs at less than half the rate.
DW_COPIES = ("tma", "cp.async", "cp.async, no map made")


def dw_copy_launches() -> dict[str, int]:
    """The warpgroup-MMA dw stage's launches since the library was loaded,
    by how their rows were copied (DW_COPIES), as the C launchers count
    them (``scgrhc_dw_copy_launches``)."""
    out = (ctypes.c_longlong * len(DW_COPIES))()
    _build.library().scgrhc_dw_copy_launches(out)
    return dict(zip(DW_COPIES, out))


def scratch_numel(plan: ConvPlan) -> int:
    """The f32 elements of the forward's scratch: c, then, where the row
    pass runs in pieces, two partial sums a piece from the next even
    element and two row sums a row (csrc/conv3.cuh: launch_layer_fwd)."""
    n, cout, t = plan.scratch
    c = n * cout * t
    return c + c % 2 + 2 * n * cout * (plan.row_parts + 1) if plan.row_parts else c


def c_plan(n: int, cin: int, cout: int, t: int, mode: str, pass_: str = "fwd",
           dtype=torch.float32) -> tuple[ConvPlan, int, int]:
    """The C launchers' own plan (``scgrhc_layer_plan``) and split-weight
    sizes (of the forward's product and of dx's), for holding
    :func:`conv_plan` and :func:`wsplit_numel` to them."""
    out = (ctypes.c_int * 12)()
    _build.library().scgrhc_layer_plan(n, cin, cout, t, MODE_CODE[mode], PASSES.index(pass_),
                                       DTYPE_CODE[dtype], out)
    path, gx, gy, gz, rows, scratch, parts, tx, ty, tz, ws_fwd, ws_dx = out
    plan = ConvPlan(PATHS[path], (gx, gy, gz), rows, (n, cout, t) if scratch else None, parts,
                    (tx, ty, tz) if PATHS[path] == "wgmma" else None)
    return plan, ws_fwd, ws_dx


@dataclass(frozen=True)
class DwPlan:
    path: str  # one of DW_PATHS
    nsplit: int  # the kernels' sample splits, 1 <= nsplit <= N
    part_shape: tuple[int, int, int]  # the f32 scratch of per-split partial sums


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


def dw_plan(n: int, cin: int, cout: int, dtype=torch.float32) -> DwPlan:
    """The path, sample splits and scratch shape of dw's first stage for x
    (n, cin, T) in ``dtype`` and cout output channels, as the kernels take
    them."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"dw_plan: dtype {dtype}")
    if cout < DW_STREAM_BELOW:
        path, tiles, blocks, cols = "stream", -(-cin // DW_STREAM_C), DW_STREAM_BLOCKS, 3 * cin + 1
    elif dtype == torch.float32:
        path, blocks, cols = "wgmma", DW_WG_BLOCKS, 3 * cin
        tiles = -(-cout // DW_WG_TILE_O) * -(-cin // DW_WG_TILE_C)
    else:
        path, blocks, cols = "mma", DW_BLOCKS, 3 * cin
        tiles = -(-cout // DW_TILE_O) * -(-cin // DW_TILE_C)
    nsplit = max(1, min(n, blocks // tiles))
    return DwPlan(path, nsplit, (nsplit, cout, cols))


def c_dw_plan(n: int, cin: int, cout: int, dtype=torch.float32) -> DwPlan:
    """The C launchers' own dw plan (``scgrhc_dw_plan``), for holding
    :func:`dw_plan` to it."""
    out = (ctypes.c_int * 3)()
    _build.library().scgrhc_dw_plan(n, cin, cout, DTYPE_CODE[dtype], out)
    path, nsplit, cols = out
    return DwPlan(PATHS[path], nsplit, (nsplit, cout, cols))


def dw_split_bounds(n: int, nsplit: int) -> list[tuple[int, int]]:
    """The samples ``[begin, end)`` of each split, as the kernels take them."""
    return [(n * z // nsplit, n * (z + 1) // nsplit) for z in range(nsplit)]


def dw_stream_max_len(cout: int) -> int | None:
    """The longest T that dw's first stage takes at ``cout`` output
    channels: below DW_STREAM_BELOW it holds one sample's dc, cout x (T + 2)
    f32, in DW_STREAM_DC_BYTES of shared memory: 56,574 steps at O = 1,
    3,769 at O = 15.  None: no limit."""
    if cout >= DW_STREAM_BELOW:
        return None
    return DW_STREAM_DC_BYTES // (4 * cout) - 2


def check_inputs(what: str, x, w, b, dy=None, need_dw: bool = False) -> None:
    """Raise on what the kernels do not take: dtypes other than float32 or
    bfloat16, mixed dtypes or devices, wrong or empty shapes,
    non-contiguous tensors, and, where the backward computes dw
    (``need_dw``), a T past :func:`dw_stream_max_len` below 16 output
    channels.  Any N and any other T are taken; b None: no bias."""
    ts = tuple(t for t in (x, w, b, dy) if t is not None)
    if x.dtype not in DTYPE_CODE or any(t.dtype != x.dtype for t in ts):
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 tensors of one dtype, got "
            f"{[t.dtype for t in ts]}"
        )
    if x.dim() != 3 or w.dim() != 3 or (b is not None and b.dim() != 1):
        raise ValueError(f"{what} expects x (N, C_in, T), w (O, C_in, 3), b (O,)")
    n, cin, t = x.shape
    o = w.shape[0]
    if (w.shape != (o, cin, 3) or (b is not None and b.shape != (o,))
            or (dy is not None and dy.shape != (n, o, t))):
        raise ValueError(
            f"{what} shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {None if b is None else tuple(b.shape)}"
            + ("" if dy is None else f", dy {tuple(dy.shape)}")
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if min(n, cin, o, t) < 1:
        raise ValueError(f"{what} kernel takes no empty shape, got N={n}, C_in={cin}, O={o}, "
                         f"T={t}")
    max_len = dw_stream_max_len(o) if need_dw else None
    if max_len is not None and t > max_len:
        raise ValueError(
            f"{what}: below {DW_STREAM_BELOW} output channels the weight gradient holds one "
            f"sample's dc, O x (T + 2) float32, in a block's shared memory ({DW_STREAM_DC_BYTES} "
            f"bytes on sm_90), so at O={o} it takes T <= {max_len}, got T={t}"
        )


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_fwd(what: str, x, w, b, mode: str):
    """The layer's forward (``scgrhc_layer_fwd``) on CUDA tensors → y (N, O,
    T) in x's dtype, with the f32 scratch that :func:`conv_plan` asks for
    (:func:`scratch_numel`; or null) and the split weights where it takes
    the f32 core (:func:`wsplit_numel`; or null).  b None: no bias (the
    conv kernels add none for a null bias)."""
    check_inputs(what, x, w, b)
    n, cin, t = x.shape
    o = w.shape[0]
    y = torch.empty((n, o, t), dtype=x.dtype, device=x.device)
    plan = conv_plan(n, cin, o, t, mode, "fwd", x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    c = None if plan.scratch is None else torch.empty(scratch_numel(plan), **f32)
    ws = torch.empty(wsplit_numel(cin, o), **f32) if plan.path == "wgmma" else None
    with torch.cuda.device(x.device):
        err = _build.library().scgrhc_layer_fwd(
            *(None if v is None else v.data_ptr() for v in (x, w, b, y, c, ws)), n, cin, o, t,
            MODE_CODE[mode], DTYPE_CODE[x.dtype], _stream(x),
        )
    _build.check(err, what)
    count_launches(plan, n)
    return y


def launch_bwd(what: str, x, w, b, dy, mode: str, need_dx: bool, need_dw: bool,
               keep: bool = False):
    """The layer's backward (``scgrhc_layer_bwd``) on CUDA tensors →
    ``(dx, dw, db)`` as :func:`layer_bwd_plain` gives them.  The f32
    scratch for dc (N, O, T), for dw's per-split partial sums
    (:func:`dw_plan`) and for the split weights (:func:`bwd_wsplit_numel`)
    is allocated here.  ``keep`` (relu and in_relu): ``(dx, dw, db, c, dc,
    stats)``, with what the dc pass made kept for the GP's second order: c
    (N, O, T) f32, dc (N, O, T) f32 and, in the in_relu mode, each row's
    (mean, E[c²] − mean²) before the clamp, (N, O, 2) f32 (None in relu)."""
    check_inputs(what, x, w, b, dy, need_dw)
    if keep and mode == "linear":
        raise ValueError(f"{what}: keep takes the relu or in_relu mode, got {mode!r}")
    n, cin, t = x.shape
    o = w.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    dc = torch.empty((n, o, t), **f32)
    dx = torch.empty_like(x) if need_dx else None
    dw = db = part = None
    plan = dw_plan(n, cin, o, x.dtype)
    if need_dw:
        dw = torch.empty((o, cin, 3), **f32)
        db = torch.empty((o,), **f32)
        part = torch.empty(plan.part_shape, **f32)
    ws_numel = bwd_wsplit_numel(n, cin, o, t, mode, need_dx, x.dtype)
    ws = torch.empty(ws_numel, **f32) if ws_numel else None
    c = torch.empty((n, o, t), **f32) if keep else None
    stats = torch.empty((n, o, 2), **f32) if keep and mode == "in_relu" else None
    ptrs = [None if v is None else v.data_ptr()
            for v in (x, w, b, dy, dx, dw, db, dc, part, ws, c, stats)]
    with torch.cuda.device(x.device):
        err = _build.library().scgrhc_layer_bwd(
            *ptrs, n, cin, o, t, MODE_CODE[mode], plan.nsplit, DTYPE_CODE[x.dtype], _stream(x)
        )
    _build.check(err, what)
    count_launches(conv_plan(n, cin, o, t, mode, "dc", x.dtype), n)
    if need_dx:
        count_launches(conv_plan(n, cin, o, t, mode, "dx", x.dtype), n)
    if need_dw:
        dw_path_launches[plan.path] += 1
    return (dx, dw, db, c, dc, stats) if keep else (dx, dw, db)


def on_cpu(x, what: str) -> bool:
    """True for a CPU tensor (the plain version runs); False for CUDA (the
    kernel runs); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False
