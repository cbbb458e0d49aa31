"""The port's kernel modules: K1f (conv_in_relu), K4 (normalize_windows),
the plan of the conv layer's dw stage (conv3.dw_plan) and of its conv
passes (conv3.conv_plan), shared by the generator and the critic, and the
shapes the layer kernels take (conv3.check_inputs), and the length up to
which K3 stages a window in shared memory (dsp.gate_stage_max_len).

Each plain version against the JAX Pallas kernel it stands beside
(interpret mode, as the JAX package's own tests run it), and the wrappers'
CPU dispatch.  The CUDA kernels against their plain versions are in
tests/test_torch_gpu.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.ops.pallas.conv_block import conv_in_relu as jax_conv_in_relu
from scgrhc.ops.pallas.dsp import normalize_windows as jax_normalize_windows
from scgrhc_torch.ops.kernels import conv3
from scgrhc_torch.ops.kernels import conv_block as k1f
from scgrhc_torch.ops.kernels import dsp as k4

# the tolerance of tests/test_conv_block_kernel.py (f32 reassociation)
K1F_ATOL = 2e-5
K4_ATOL = 1e-6


def _conv_inputs(n, ci, o, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ci, t)).astype(np.float32)
    bound = 1.0 / np.sqrt(ci * 3)
    w = rng.uniform(-bound, bound, (o, ci, 3)).astype(np.float32)
    b = rng.uniform(-bound, bound, o).astype(np.float32)
    return x, w, b


def _windows(seed=0, n=6, c=4, t=750, nan_window=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, c, t)) * rng.uniform(0.1, 50, (n, 1, 1))
         + rng.uniform(-10, 10, (n, 1, 1))).astype(np.float32)
    if nan_window is not None:
        w[nan_window, c // 2, t // 3] = np.nan
    return w


@pytest.mark.parametrize(
    "ci,o,t", [(3, 64, 750), (64, 128, 750), (256, 512, 750), (4, 64, 747)]
)
def test_conv_in_relu_plain_matches_pallas(ci, o, t):
    x, w, b = _conv_inputs(2, ci, o, t)
    want = np.asarray(jax_conv_in_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = k1f.conv_in_relu_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, o, t)
    np.testing.assert_allclose(got, want, atol=K1F_ATOL)


def test_conv_in_relu_cpu_takes_plain_path():
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(2, 8, 16, 90))
    k1f.conv_in_relu.launches = 0
    got = k1f.conv_in_relu(x, w, b)
    assert k1f.conv_in_relu.launches == 0
    assert torch.equal(got, k1f.conv_in_relu_plain(x, w, b))


def test_conv_in_relu_plain_bf16_accumulates_in_f32():
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(2, 64, 64, 750, seed=3))
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    got = k1f.conv_in_relu_plain(xb, wb, bb)
    assert got.dtype == torch.bfloat16
    want = k1f.conv_in_relu_plain(xb.float(), wb.float(), bb.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("nan_window", [None, 2])
def test_normalize_windows_plain_matches_pallas(nan_window):
    w = _windows(nan_window=nan_window)
    want = np.asarray(jax_normalize_windows(jnp.asarray(w)))
    got = k4.normalize_windows_plain(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if nan_window is not None:
        assert np.isnan(got[nan_window]).all()
        assert not np.isnan(np.delete(got, nan_window, axis=0)).any()
    np.testing.assert_allclose(got, want, atol=K4_ATOL, equal_nan=True)


def test_normalize_windows_cpu_takes_plain_path():
    w = torch.from_numpy(_windows())
    k4.normalize_windows.launches = 0
    got = k4.normalize_windows(w)
    assert k4.normalize_windows.launches == 0
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(k4.normalize_windows_plain(w)))


# (N, C_in, O) of the main path's dw launches: the critic's five layers and
# the generator's at N = 32, and narrow or ragged ones
DW_SHAPES = [(32, 5, 64), (32, 64, 128), (32, 128, 256), (32, 256, 512), (32, 512, 1),
             (32, 4, 64), (32, 512, 512), (32, 128, 64), (1, 3, 5), (33, 100, 24),
             (33, 7, 5), (1, 3, 17), (1, 64, 1), (65535, 512, 15), (2, 1, 16)]


@pytest.mark.parametrize("n,cin,cout", DW_SHAPES)
def test_dw_plan_path_and_scratch(n, cin, cout):
    plan = conv3.dw_plan(n, cin, cout)  # f32
    stream = cout < conv3.DW_STREAM_BELOW
    assert plan.path == ("stream" if stream else "wgmma")
    assert 1 <= plan.nsplit <= n
    # the streaming path carries db's partial sums in one more column
    assert plan.part_shape == (plan.nsplit, cout, 3 * cin + stream)
    if stream:
        tiles, blocks = -(-cin // conv3.DW_STREAM_C), conv3.DW_STREAM_BLOCKS
    else:
        tiles = -(-cout // conv3.DW_WG_TILE_O) * -(-cin // conv3.DW_WG_TILE_C)
        blocks = conv3.DW_WG_BLOCKS
    # one wave of blocks, as full as the samples allow
    assert tiles * plan.nsplit <= blocks or plan.nsplit == 1
    assert tiles * (plan.nsplit + 1) > blocks or plan.nsplit == n
    assert conv3.dw_plan(n, cin, cout) == plan  # a pure function of the shape


def test_dw_plan_main_path():
    # the score layer streams one sample a block; the widest critic layer
    # splits its 32 samples four ways over 32 warpgroup-MMA tiles (128
    # blocks), and in bf16 four ways over 64 mma.sync tiles (256 blocks)
    assert conv3.dw_plan(32, 512, 1) == conv3.DwPlan("stream", 32, (32, 1, 1537))
    assert conv3.dw_plan(32, 256, 512) == conv3.DwPlan("wgmma", 4, (4, 512, 768))
    assert conv3.dw_plan(32, 256, 512, torch.bfloat16) == conv3.DwPlan("mma", 4, (4, 512, 768))


# (C_in, O) of every dw launch of a WGAN-GP step of waveform_06 (3 SCG
# channels): the generator's 14 layers (K1b), the critic's five (K2dw) and
# the linear dw of K2dx's closed-form vjp (64 -> 128, 128 -> 256, 256 -> 512)
def _step_dw_shapes(in_channels=3):
    from scgrhc_torch.models.critic import LAYER_MODES, NDF
    from scgrhc_torch.models.generator import BLOCKS

    gen = []
    for _, cin, cout in BLOCKS:
        cin = in_channels if cin is None else cin
        gen += [(cin, cout), (cout, cout)]
    widths = [in_channels + 1, NDF, 2 * NDF, 4 * NDF, 8 * NDF, 1]
    critic = [(widths[i], widths[i + 1]) for i in range(len(LAYER_MODES))]
    return gen + critic + [(64, 128), (128, 256), (256, 512)]


STEP_DW_SHAPES = _step_dw_shapes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", sorted(set(STEP_DW_SHAPES)))
def test_dw_plan_path_by_dtype_and_shape(cin, cout, dtype):
    """At training's N = 64: f32 takes the warpgroup MMA at every layer
    shape of both models, the first layers' 3 and 4 input channels too,
    but the score layer (the stream); bf16 keeps mma.sync, and the stream
    at the score layer."""
    plan = conv3.dw_plan(64, cin, cout, dtype)
    if cout == 1:
        want = "stream"
    elif dtype == torch.float32:
        want = "wgmma"
    else:
        want = "mma"
    assert plan.path == want
    assert plan.path in conv3.DW_PATHS


@pytest.mark.parametrize("n,cin,cout,dtype,want", [
    # the widest critic layer and the generator's widest at N = 64: 32 and
    # 64 tiles of 64 x 64, four and two splits (128 blocks each)
    (64, 256, 512, torch.float32, conv3.DwPlan("wgmma", 4, (4, 512, 768))),
    (64, 512, 512, torch.float32, conv3.DwPlan("wgmma", 2, (2, 512, 1536))),
    # one tile at 64 -> 64: a split a sample; two at 64 -> 128
    (64, 64, 64, torch.float32, conv3.DwPlan("wgmma", 64, (64, 64, 192))),
    (64, 64, 128, torch.float32, conv3.DwPlan("wgmma", 64, (64, 128, 192))),
    # the first layers, one tile: a split a sample; bf16 on mma.sync at
    # 256 -> 512 (64 tiles of 64 x 32) and at 4 -> 64
    (64, 3, 64, torch.float32, conv3.DwPlan("wgmma", 64, (64, 64, 9))),
    (64, 4, 64, torch.float32, conv3.DwPlan("wgmma", 64, (64, 64, 12))),
    (64, 256, 512, torch.bfloat16, conv3.DwPlan("mma", 4, (4, 512, 768))),
    (64, 4, 64, torch.bfloat16, conv3.DwPlan("mma", 64, (64, 64, 12))),
    # fewer samples than a wave would split: every sample its own split
    (3, 256, 512, torch.float32, conv3.DwPlan("wgmma", 3, (3, 512, 768))),
    (1, 512, 512, torch.float32, conv3.DwPlan("wgmma", 1, (1, 512, 1536))),
    # past one wave of tiles (1024 -> 1024: 256 tiles): one split
    (64, 1024, 1024, torch.float32, conv3.DwPlan("wgmma", 1, (1, 1024, 3072))),
])
def test_dw_plan_nsplit_and_scratch(n, cin, cout, dtype, want):
    assert conv3.dw_plan(n, cin, cout, dtype) == want


def test_dw_plan_rejects_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        conv3.dw_plan(4, 64, 64, torch.float64)


def test_dw_path_launches_keys_and_cpu_dispatch():
    """The dw counter has one key a path; the CPU's plain versions count
    nothing."""
    from scgrhc_torch.ops.kernels import critic_fused as k2

    assert set(conv3.dw_path_launches) == set(conv3.DW_PATHS) == {"wgmma", "mma", "stream"}
    before = dict(conv3.dw_path_launches)
    x, w, b = (torch.randn(s) for s in ((2, 16, 8), (16, 16, 3), (16,)))
    k2.critic_layer_bwd_dwdb(x, w, b, torch.randn(2, 16, 8), "relu")
    assert conv3.dw_path_launches == before


@pytest.mark.parametrize("n", [1, 2, 5, 32, 33, 1000])
def test_dw_splits_cover_every_sample_once_in_order(n):
    for nsplit in sorted({1, 2, 3, 5, 17, 32, n} & set(range(1, n + 1))):
        bounds = conv3.dw_split_bounds(n, nsplit)
        assert len(bounds) == nsplit
        assert [s for lo, hi in bounds for s in range(lo, hi)] == list(range(n))
        assert all(hi > lo for lo, hi in bounds)  # no split is empty


# (C_in, O, mode) of the critic's five layers; N = 32, T = 750 on the main path
CRITIC_LAYERS = [(5, 64, "relu"), (64, 128, "in_relu"), (128, 256, "in_relu"),
                 (256, 512, "in_relu"), (512, 1, "linear")]


def _core_plan(dtype, n, cols, t):
    """(path, grid, tiles) of the tensor-core core for a product of cols
    columns over n samples of t steps: f32 on the warpgroup-MMA core's
    (wg_tile_m steps x wg_tile_n columns) tiles, walked by a persistent
    grid of at most 132 blocks; bf16 a block per (64 columns x 128 steps)
    tile."""
    if dtype == torch.float32:
        bn = conv3.wg_tile_n(cols)
        tiles = (-(-t // (256 if bn <= 16 else 128)), -(-cols // bn), n)
        return "wgmma", (min(tiles[0] * tiles[1] * tiles[2], 132), 1, 1), tiles
    return "mma", (-(-t // 128), -(-cols // 64), n), None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pass_", conv3.PASSES)
@pytest.mark.parametrize("cin,cout,mode", CRITIC_LAYERS)
def test_conv_plan_at_critic_layers(cin, cout, mode, pass_, dtype):
    n, t = 32, 750
    plan = conv3.conv_plan(n, cin, cout, t, mode, pass_, dtype)
    if pass_ == "dx":
        # the score layer's dx (K = 3) streams over dc, every other layer
        # takes the tensor-core product with C_in columns
        if cout == 1:
            assert plan == conv3.ConvPlan("stream", (12, n, 1), 0, None)
        else:
            path, grid, tiles = _core_plan(dtype, n, cin, t)
            assert plan == conv3.ConvPlan(path, grid, 0, None, tiles=tiles)
        return
    if pass_ == "dc" and mode == "linear":
        assert plan == conv3.ConvPlan("none", (0, 0, 0), 0, None)  # dc = dy
        return
    if cout == 1:
        assert (plan.path, plan.grid, plan.tiles) == ("stream", (12, n, 1), None)
    else:
        assert (plan.path, plan.grid, plan.tiles) == _core_plan(dtype, n, cout, t)
    # in_relu's statistics, and the dc pass's relu mask, go through the row
    # pass; the forward's relu and linear modes end in the conv's epilogue
    row = mode == "in_relu" or (mode == "relu" and pass_ == "dc")
    assert plan.row_blocks == (n * cout // 8 if row else 0)
    assert plan.scratch == ((n, cout, t) if row and pass_ == "fwd" else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [1, 2, 5, 15, 16, 17])
@pytest.mark.parametrize("mode", conv3.MODES)
def test_conv_plan_streams_below_16_output_channels(cout, mode, dtype):
    n, cin, t = 3, 40, 130
    fwd = conv3.conv_plan(n, cin, cout, t, mode, "fwd", dtype)
    dx = conv3.conv_plan(n, cin, cout, t, mode, "dx", dtype)
    if cout < conv3.CONV_STREAM_BELOW:
        assert fwd.path == "stream" and fwd.grid == (3, n, 1)
        assert dx.path == "stream" and dx.grid == (3, n, 1)
        # the stream kernel has no relu epilogue: relu goes through c and the row pass
        assert (fwd.scratch is not None) == (mode != "linear")
    else:
        core = "wgmma" if dtype == torch.float32 else "mma"
        assert fwd.path == core and dx.path == core
        assert (fwd.scratch is not None) == (mode == "in_relu")


def _tiles(plan, m_rows, t):
    """The (sample, row, step) entries the conv kernel's blocks write."""
    gx, gy, gz = plan.grid
    if plan.path == "wgmma":
        # block b walks the tiles b, b + gx, ...: the step tile fastest,
        # then the column tile, then the sample
        tx, ty, tz = plan.tiles
        bm, bn = conv3.wg_tile_m(m_rows), conv3.wg_tile_n(m_rows)
        assert (gy, gz) == (1, 1) and ty == -(-m_rows // bn)
        walked = [i for b in range(gx) for i in range(b, tx * ty * tz, gx)]
        assert sorted(walked) == list(range(tx * ty * tz))  # every tile once
        return [(i // (tx * ty), m, s) for i in walked
                for m in range(i // tx % ty * bn, min((i // tx % ty + 1) * bn, m_rows))
                for s in range(i % tx * bm, min((i % tx + 1) * bm, t))]
    if plan.path == "mma":
        bm, bn = conv3.MMA_TILE_M, conv3.MMA_TILE_N
        blocks = [(z, y, x) for z in range(gz) for y in range(gy) for x in range(gx)]
        return [(z, m, s) for z, y, x in blocks
                for m in range(y * bm, min((y + 1) * bm, m_rows))
                for s in range(x * bn, min((x + 1) * bn, t))]
    assert plan.path == "stream"
    bn = conv3.CONV_STREAM_STEPS
    return [(y, m, s) for y in range(gy) for x in range(gx) for m in range(m_rows)
            for s in range(x * bn, min((x + 1) * bn, t))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pass_", conv3.PASSES)
@pytest.mark.parametrize("n,cin,cout,t", [(2, 5, 64, 750), (1, 3, 24, 1), (3, 24, 5, 7),
                                          (2, 70, 129, 129), (1, 17, 1, 1023), (1, 8, 16, 8),
                                          (3, 4, 40, 300), (70, 16, 16, 129)])
def test_conv_plan_grids_cover_every_tile_once(n, cin, cout, t, pass_, dtype):
    plan = conv3.conv_plan(n, cin, cout, t, "in_relu", pass_, dtype)
    m_rows = cin if pass_ == "dx" else cout
    got = _tiles(plan, m_rows, t)
    assert len(got) == len(set(got)) == n * m_rows * t  # each (n, row, step) once
    # no block or tile lies wholly outside the tensors
    gx, gy, gz = plan.grid
    if plan.path == "mma":
        assert (gx - 1) * conv3.MMA_TILE_N < t and (gy - 1) * conv3.MMA_TILE_M < m_rows
        assert gz == n
    if plan.path == "wgmma":
        tx, ty, tz = plan.tiles
        assert (tx - 1) * conv3.wg_tile_m(m_rows) < t
        assert (ty - 1) * conv3.wg_tile_n(m_rows) < m_rows
        assert tz == n and gx == min(tx * ty * tz, conv3.WG_BLOCKS)
    if plan.row_blocks:
        assert (plan.row_blocks - 1) * conv3.ROW_WARPS < n * cout <= plan.row_blocks * 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pass_", conv3.PASSES)
def test_conv_plan_has_no_length_limit(pass_, dtype):
    """The tensor-core core and the row pass tile T and never hold a whole
    row: a plan at T = 4096 covers it, and one at T = 900,000 (a whole
    1800-s record, N = 1)."""
    n, cin, cout, t = 32, 256, 512, 4096
    plan = conv3.conv_plan(n, cin, cout, t, "in_relu", pass_, dtype)
    cols = cin if pass_ == "dx" else cout
    assert (plan.path, plan.grid, plan.tiles) == _core_plan(dtype, n, cols, t)
    if dtype == torch.float32:
        assert plan.tiles == (32, cols // 128, n) and plan.grid == (132, 1, 1)
    else:
        assert plan.grid == (32, cols // 64, n)
    whole = conv3.conv_plan(1, 512, 512, 900_000, "in_relu", pass_, dtype)
    assert (whole.path, whole.grid, whole.tiles) == _core_plan(dtype, 1, 512, 900_000)
    stream = conv3.conv_plan(n, 512, 1, t, "linear", "fwd", dtype)
    assert stream.path == "stream" and stream.grid == (64, n, 1)


def test_conv_plan_rejects_unknown_pass_and_mode():
    with pytest.raises(ValueError):
        conv3.conv_plan(1, 4, 16, 8, "in_relu", "dw")
    with pytest.raises(ValueError):
        conv3.conv_plan(1, 4, 16, 8, "gelu")
    with pytest.raises(ValueError):
        conv3.conv_plan(1, 4, 16, 8, "in_relu", "fwd", torch.float64)


# (C_in, O, T) of the generator's 14 layers at T = 750 (models/generator.py)
GENERATOR_LAYERS = [(4, 64, 750), (64, 64, 750), (64, 128, 748), (128, 128, 748),
                    (128, 256, 746), (256, 256, 746), (256, 512, 744), (512, 512, 744),
                    (512, 256, 746), (256, 256, 746), (256, 128, 748), (128, 128, 748),
                    (128, 64, 750), (64, 64, 750)]


@pytest.mark.parametrize("n", [512, 32])
@pytest.mark.parametrize("pass_", conv3.PASSES)
@pytest.mark.parametrize("cin,cout,t", sorted(set(GENERATOR_LAYERS)))
def test_conv_plan_at_generator_layers(cin, cout, t, pass_, n):
    """K1f (serving's N = 512, training's N = 32) and K1b's dc and dx
    passes take the tensor-core core (f32: the warpgroup-MMA core, 6 step
    tiles a window), with c through the scratch and the row pass in the
    forward, and dc in place in the dc pass."""
    plan = conv3.conv_plan(n, cin, cout, t, "in_relu", pass_)
    rows = cin if pass_ == "dx" else cout
    assert plan.path == "wgmma"
    # 64 columns: one tile of 64; dx's 4 columns (the first layer's, which
    # training never asks for): one of 8 columns x 256 steps
    assert plan.tiles == ((3, 1, n) if rows == 4 else (6, -(-rows // 128), n))
    assert plan.grid == (min(plan.tiles[0] * plan.tiles[1] * n, 132), 1, 1)
    assert conv3.conv_plan(n, cin, cout, t, "in_relu", pass_, torch.bfloat16).grid == (
        6, -(-rows // 64), n)
    assert plan.row_blocks == (0 if pass_ == "dx" else n * cout // 8)
    assert plan.scratch == ((n, cout, t) if pass_ == "fwd" else None)


@pytest.mark.parametrize("cols,bn", [(1, 8), (4, 8), (5, 8), (8, 8), (9, 16), (17, 32),
                                     (64, 64), (65, 128), (128, 128), (512, 128)])
def test_wg_tile_n_follows_the_columns(cols, bn):
    """The f32 core's tile width is the least of 8 .. 128 that holds the
    product's columns (the 4- and 5-channel dx, the 64 -> 64 layers fill
    their tiles), and 128 past it; the narrowest tiles take 256 steps."""
    assert conv3.wg_tile_n(cols) == bn
    assert conv3.wg_tile_m(cols) == (256 if bn <= 16 else 128)
    assert conv3.wsplit_numel(16, cols) == -(-cols // bn) * 2 * 2 * 3 * bn * 8


@pytest.mark.parametrize("cin,cout,mode",
                         CRITIC_LAYERS + [(4, 64, "in_relu"), (512, 512, "in_relu")])
@pytest.mark.parametrize("need_dx", [False, True])
def test_bwd_wsplit_numel(cin, cout, mode, need_dx):
    """The backward's split weights hold the dc pass's recompute and dx in
    turn: the larger of the two products' sizes, 0 where neither runs on
    the f32 core (the score layer streams; bf16 runs mma.sync)."""
    n, t = 32, 750
    got = conv3.bwd_wsplit_numel(n, cin, cout, t, mode, need_dx)
    dc = conv3.wsplit_numel(cin, cout) if mode != "linear" and cout >= 16 else 0
    dx = conv3.wsplit_numel(cout, cin) if need_dx and cout >= 16 else 0
    assert got == max(dc, dx)
    assert conv3.bwd_wsplit_numel(n, cin, cout, t, mode, need_dx, torch.bfloat16) == 0
    if (cin, cout) == (256, 512):  # 4 column tiles x 32 stages x 2 planes x 3 taps x 128 x 8
        assert conv3.wsplit_numel(cin, cout) == 4 * 32 * 2 * 3 * 128 * 8


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n,t", [(32, 1500), (1, 4096), (70_000, 750), (70_000, 4096)])
def test_check_inputs_takes_any_length_and_batch(n, t):
    """No length or batch limit: past the 1024 steps and 65535 samples the
    card once refused (the launchers walk N in chunks of 65535 samples)."""
    for cin, o in ((4, 64), (512, 512), (512, 1), (7, 15)):
        x, w, b, dy = _meta(n, cin, t), _meta(o, cin, 3), _meta(o), _meta(n, o, t)
        conv3.check_inputs("fwd", x, w, b)
        conv3.check_inputs("dx", x, w, b, dy)
        if o >= conv3.DW_STREAM_BELOW or t <= conv3.dw_stream_max_len(o):
            conv3.check_inputs("bwd", x, w, b, dy, need_dw=True)


def test_check_inputs_refuses_what_the_kernels_do_not_take():
    x, w, b, dy = _meta(2, 4, 8), _meta(16, 4, 3), _meta(16), _meta(2, 16, 8)
    with pytest.raises(TypeError):
        conv3.check_inputs("k", x.double(), w.double(), b.double())
    with pytest.raises(TypeError):
        conv3.check_inputs("k", x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="shape mismatch"):
        conv3.check_inputs("k", x, _meta(16, 5, 3), b)
    with pytest.raises(ValueError, match="shape mismatch"):
        conv3.check_inputs("k", x, w, b, _meta(2, 16, 9))
    with pytest.raises(ValueError, match="expects"):
        conv3.check_inputs("k", _meta(4, 8), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv3.check_inputs("k", _meta(2, 8, 4).transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="one device"):
        conv3.check_inputs("k", x, torch.empty(16, 4, 3), b)
    for shape in ((0, 4, 8), (2, 4, 0)):
        with pytest.raises(ValueError, match="empty"):
            conv3.check_inputs("k", _meta(*shape), w, b)


@pytest.mark.parametrize("o,max_len", [(1, 56_574), (5, 11_313), (15, 3_769)])
def test_check_inputs_states_the_dw_stream_limit(o, max_len):
    """Below 16 output channels the backward's dw holds one sample's dc,
    O x (T + 2) f32, in a block's shared memory: the one limit left, named
    in the message, and only where dw is computed."""
    assert conv3.dw_stream_max_len(o) == max_len
    n, cin = 2, 512
    for t, ok in ((max_len, True), (max_len + 1, False)):
        x, w, b, dy = _meta(n, cin, t), _meta(o, cin, 3), _meta(o), _meta(n, o, t)
        conv3.check_inputs("fwd", x, w, b)
        conv3.check_inputs("dx", x, w, b, dy)  # the input gradient alone has no limit
        if ok:
            conv3.check_inputs("dw", x, w, b, dy, need_dw=True)
        else:
            with pytest.raises(ValueError, match=f"shared memory.*T <= {max_len}, got T={t}"):
                conv3.check_inputs("dw", x, w, b, dy, need_dw=True)
    assert conv3.dw_stream_max_len(conv3.DW_STREAM_BELOW) is None


def test_gate_stage_max_len_mirrors_the_source():
    """K3 stages the rhc window in shared memory up to gate_stage_max_len
    samples, and holds up to 6,144 scg values of a window in registers,
    from the constants of csrc/gate_normalize.cu."""
    src = (Path(k4.__file__).resolve().parents[2] / "csrc" / "gate_normalize.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kTilePositions"], const["kSmemOptin"], const["kStaticReserve"]) == (
        k4._GATE_TILE, k4._SMEM_OPTIN, k4._STATIC_RESERVE)
    assert "6144 / kThreads" in src and const["kThreads"] == 256
    assert k4.gate_stage_max_len() == 49_468
    assert 4 * k4.gate_stage_max_len() + 16 * (2048 + 49) <= 232_448 - 1024


@pytest.mark.parametrize("t", [conv3.ROW_PIECE, conv3.ROW_PIECE + 1, 300_000, 900_000])
def test_conv_plan_cuts_long_in_relu_rows_into_pieces(t):
    """Past ROW_PIECE steps (the continuous mode's whole record) the
    in_relu forward's row pass runs in pieces, a block each, and the
    scratch holds their partial sums after c, then one pair a row; the
    backward's dc pass and the other modes keep a warp a row."""
    n, cin, cout = 1, 512, 512
    fwd = conv3.conv_plan(n, cin, cout, t, "in_relu")
    parts = -(-t // conv3.ROW_PIECE) if t > conv3.ROW_PIECE else 0
    assert fwd.row_parts == parts and fwd.scratch == (n, cout, t)
    assert fwd.row_blocks == (0 if parts else n * cout // conv3.ROW_WARPS)
    c = n * cout * t
    assert conv3.scratch_numel(fwd) == (c + c % 2 + 2 * n * cout * (parts + 1) if parts else c)
    dc = conv3.conv_plan(n, cin, cout, t, "in_relu", "dc")
    assert dc.row_parts == 0 and dc.row_blocks == n * cout // conv3.ROW_WARPS
    assert conv3.conv_plan(n, cin, 5, t, "relu").row_parts == 0
    # an odd element count of c: the partial sums start at the next even element
    odd = conv3.conv_plan(1, 3, 17, 8193, "in_relu")
    assert odd.row_parts == 2 and conv3.scratch_numel(odd) == 17 * 8193 + 1 + 2 * 17 * 3
