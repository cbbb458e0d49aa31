"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
machine with the card has no JAX, so this file imports neither JAX nor
``scgrhc``, and it runs there without the repo's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: f32 1e-4 absolute (the kernel and cuDNN sum the 3·C_in
products in different orders; outputs are instance-normalized, O(1));
bf16 3e-2 absolute plus 1e-2 relative against the f32 plain version on
the same bf16-rounded inputs (the kernel's only extra rounding is the bf16
store, 2^-9 relative); K4 1e-6 (it performs the plain version's exact
f32 operations).  K3: ``keep`` and the (lo, hi) pairs equal (min, max and
the flat count are exact, the other tests away from their thresholds), the
normalized windows within 1e-6 (the plain version's exact f32
operations), NaN in the same places, at any T.

The backward kernels (K1b, K2dx, K2dw, and K2dx's closed-form vjp, the
gradient penalty's second order) and the critic's forward (K2f) are
held by the relative L2 error ``|got - want| / |want|``: 1e-4 for forward
outputs in f32; 1e-3 for backward outputs in f32, where a relu mask can
flip at an x̂ within f32 rounding of 0 and move one dc element by
rsig·dy; 3e-2 in bf16 (bf16 inputs, dc rounded to bf16 for dx and dw, and
more mask flips).  The bias gradient of an ``in_relu`` layer is held to
the scale of its sum, ``|Σ|dc||``: after an instance norm it is zero up to
rounding.  In ``relu`` and ``linear`` modes it is held by its own norm.
Every conv pass runs one tensor-core core, which sums in another order
than cuDNN, so a relu mask can flip between a kernel and the plain f32
version where c or x̂ lies within f32 rounding of 0: the backward kernels
are held to the plain backward in float64 on the forward kernel's own
masks, and those masks to the plain version's within MASK_FLIP_SHARE.

The time axis on one card: K1f's two time-sharded phases against their
plain versions, over a record cut in two blocks with each other's edge
columns, and against the whole-record layer; one block's phases equal the
one-launch layer bit for bit, and ``apply_cp`` over NCCL at world size 1
equals ``apply_continuous`` bit for bit.

The data axis on one card: the comm helpers on CUDA tensors over NCCL and
over gloo in a world of one rank (a ``file://`` store), data-parallel steps
over NCCL equal bit for bit to the steps with no process group, and two
processes building the kernels at once into one empty build directory.

The training step: its phase spans timed on the card, its dw launches by
path, and the whole step at n_critic 5 against the same step on the CPU,
with the dropout masks and eps pinned through the step's seams.
"""

import numpy as np
import pytest
import torch

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.models.critic import LAYER_MODES, Critic
from scgrhc_torch.models.generator import Generator, fused_block, plain_block
from scgrhc_torch.ops.kernels import conv_block as k1f
from scgrhc_torch.ops.kernels import critic_fused as k2
from scgrhc_torch.ops.kernels import dsp as k4
from scgrhc_torch.ops.nn import instance_norm
from scgrhc_torch.train import wgan

FWD_TOL, BWD_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2
# The dw product alone (K2dw, and K1b's dw stage) in f32: 3xTF32 on the
# tensor cores sits within f32 rounding of the plain product (about 1e-6);
# one TF32 pass would read about 5e-4, which BWD_TOL would let through.
DW_F32_TOL = 1e-5
# A whole generator's weight gradients in f32 against float64: f32
# rounding flips a few relu masks among the U-Net's 8.4 M activations, and
# each flip moves the weight gradients by up to a few 1e-3; on an H100 the
# plain f32 block itself reads 2.0e-3 from float64 and the kernel path
# 4.0e-3 (the test prints both).  Two f32 paths can sit that far apart, so
# they are each held to float64, not to each other.
GEN_GRAD_TOL = 1e-2

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    """The card as the port's entry points set it up: TF32 off, and cuDNN
    held to deterministic algorithms (without, its convolution backward
    sums in an order that changes from run to run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return resolve_device("cuda")


def _conv_inputs(n, ci, o, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ci, t)).astype(np.float32)
    bound = 1.0 / np.sqrt(ci * 3)
    w = rng.uniform(-bound, bound, (o, ci, 3)).astype(np.float32)
    b = rng.uniform(-bound, bound, o).astype(np.float32)
    return x, w, b


def _windows(n, c, t, nan_window, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, c, t)) * rng.uniform(0.1, 50, (n, 1, 1))
         + rng.uniform(-10, 10, (n, 1, 1))).astype(np.float32)
    w[nan_window, c // 2, t // 3] = np.nan
    return w


# (C_in, O, T) of the generator's 14 layers at T = 750, 11 distinct
# (models/generator.py), run at training's N = 64
GENERATOR_SHAPES = [(4, 64, 750), (64, 64, 750), (64, 128, 748), (128, 128, 748),
                    (128, 256, 746), (256, 256, 746), (256, 512, 744), (512, 512, 744),
                    (512, 256, 746), (256, 128, 748), (128, 64, 750)]


@pytest.mark.parametrize(
    "n,ci,o,t", [(3, 4, 64, 750), (3, 2, 64, 96), (3, 64, 128, 748), (3, 512, 512, 744),
                 (3, 256, 128, 747), (3, 100, 24, 1024), (3, 7, 5, 1), (3, 4, 8, 750),
                 (3, 1, 17, 129), (3, 3, 40, 1500), (1, 12, 20, 65_600)]
    + [(64, ci, o, t) for ci, o, t in GENERATOR_SHAPES]
)
def test_conv_in_relu_kernel_f32(cuda, n, ci, o, t):
    """K1f against its plain version, at the generator's layers at N = 64
    and at ragged shapes (C_in = 1, 3; O and C_in off multiples of 8; T =
    1, 129, 1500 and past 65,536); O = 8 is enc1's shard at tensor
    parallelism 8 (``parallel.tp``), below the conv core's 16 rows: the
    streaming conv then the row pass.  Every f32 conv from 16 output
    channels takes the warpgroup-MMA core (``conv3.path_launches``)."""
    from scgrhc_torch.ops.kernels import conv3

    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(n, ci, o, t))
    before, paths = k1f.conv_in_relu.launches, dict(conv3.path_launches)
    got = k1f.conv_in_relu(x, w, b)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu.launches == before + 1
    core = "wgmma" if o >= 16 else "stream"
    assert {k: conv3.path_launches[k] - v for k, v in paths.items()} == {
        p: int(p == core) for p in paths}
    want = k1f.conv_in_relu_plain(x, w, b)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ci,o,t", [(4, 64, 750), (512, 256, 746)])
def test_conv_in_relu_kernel_bf16(cuda, ci, o, t):
    x, w, b = (torch.from_numpy(a).to(cuda).bfloat16() for a in _conv_inputs(3, ci, o, t))
    got = k1f.conv_in_relu(x, w, b)
    assert got.dtype == torch.bfloat16
    want = k1f.conv_in_relu_plain(x.float(), w.float(), b.float())
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=1e-2)


def test_conv_in_relu_kernel_propagates_nan(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 750))
    x[1, 2, 100] = float("nan")
    got = k1f.conv_in_relu(x, w, b)
    assert torch.isnan(got[1]).all() and not torch.isnan(got[0]).any()


def test_conv_in_relu_kernel_rejects(cuda):
    """The kernels refuse other dtypes and layouts, and take windows past
    1024 steps: K1f and K1b at T = 1025, 1500 and 4096 against the plain
    version (K1b on the kernel's own relu masks, in float64)."""
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 750))
    with pytest.raises(TypeError):
        k1f.conv_in_relu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        k1f.conv_in_relu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    for t in (1025, 1500, 4096):
        _hold_k1(*_bwd_inputs(cuda, 2, 64, 128, t, seed=t), need_dx=True)


@pytest.mark.parametrize("n,c,t", [(512, 4, 750), (3, 1, 5)])
def test_normalize_windows_kernel(cuda, n, c, t):
    w = torch.from_numpy(_windows(n, c, t, nan_window=n // 2)).to(cuda)
    before = k4.normalize_windows.launches
    got = k4.normalize_windows(w)
    torch.cuda.synchronize()
    assert k4.normalize_windows.launches == before + 1
    want = k4.normalize_windows_plain(w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[n // 2]).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0, equal_nan=True)


def _gate_windows(n, c, t, seed=0, edge_windows=True):
    """Pressure-like windows away from the gate's thresholds; with n > 11
    and edge_windows, window 3 flat, 5 a ramp, 7 dipping below -50 and 11
    holding a NaN."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 500.0
    rhc = 20 + 10 * np.sin(2 * np.pi * rng.uniform(0.9, 1.5, (n, 1)) * tt) + rng.standard_normal((n, t))
    scg = rng.standard_normal((n, c, t)) * rng.uniform(0.01, 2, (n, 1, 1))
    if n > 11 and edge_windows:
        rhc[3] = 7.25
        rhc[5] = np.linspace(0, 30, t) + 0.01 * rng.standard_normal(t)
        rhc[7, t // 7] = -80.0
        rhc[11, t // 3] = np.nan
        scg[11, 0, t // 2] = np.nan
    return scg.astype(np.float32), rhc.astype(np.float32)


def _hold_k3(scg, rhc):
    """One K3 launch held to the plain version: keep and the (lo, hi) pairs
    equal, NaN in the same places, the normalized windows within 1e-6; a
    repeat launch equal bit for bit.  Returns the launch's outputs."""
    before = k4.gate_and_normalize.launches
    got = k4.gate_and_normalize(scg, rhc, -50.0)
    torch.cuda.synchronize()
    assert k4.gate_and_normalize.launches == before + 1
    want = k4.gate_and_normalize_plain(scg, rhc, -50.0)
    assert got[0].dtype == torch.bool and torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    for g, w in zip(got[3:], want[3:]):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, equal_nan=True)
    again = k4.gate_and_normalize(scg, rhc, -50.0)
    assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(g)) for a, g in zip(again, got))
    return got


@pytest.mark.parametrize("n,c,t", [(300, 4, 750), (300, 1, 750), (37, 4, 750), (1, 2, 750),
                                   (13, 3, 32)])
def test_gate_and_normalize_kernel(cuda, n, c, t):
    scg, rhc = (torch.from_numpy(a).to(cuda) for a in _gate_windows(n, c, t))
    got = _hold_k3(scg, rhc)
    if n > 11:
        assert not got[0][[3, 5, 7, 11]].any()
        # at T = 32 (64 ms) a sine window reads as a straight line
        assert t < 50 or int(got[0].sum()) == n - 4
        assert torch.isnan(got[2][11]).all() and torch.isnan(got[1][11]).all()


def _flat_run_offsets(t, win=k4.FLAT_WIN):
    """Where a flat run starts: the window's first sample, win - 1, win, the
    last start a run of win + 1 samples fits (T - win - 1), and runs whose
    positions straddle the flat scan's tiles of 2048 positions."""
    offsets = [0, win - 1, win, t // 2, t - win - 1]
    for edge in range(2048, t - win, 2048):
        offsets += [edge - win, edge - 1, edge]
    return offsets


@pytest.mark.parametrize("t", [750, 5000])
def test_gate_flat_runs_of_win_and_win_plus_one(cuda, t):
    """A flat run of exactly win samples is one flat position (kept); of
    win + 1 samples, two (dropped), wherever it lies in the window."""
    win = k4.FLAT_WIN
    offsets = _flat_run_offsets(t)
    scg, rhc = _gate_windows(2 * len(offsets), 4, t, seed=t, edge_windows=False)
    for i, o in enumerate(offsets):
        for j, length in enumerate((win, win + 1)):
            rhc[2 * i + j, o:o + length] = rhc[2 * i + j, o]
    got = _hold_k3(*(torch.from_numpy(a).to(cuda) for a in (scg, rhc)))
    assert got[0].tolist() == [True, False] * len(offsets)


@pytest.mark.parametrize("t", [750, 1500])
def test_gate_and_normalize_nan_at_the_window_edges(cuda, t):
    """A NaN at sample 0 or T - 1 of rhc (window 0, 1) or of scg (2, 3)."""
    scg, rhc = _gate_windows(5, 4, t, seed=3)
    rhc[0, 0] = rhc[1, -1] = np.nan
    scg[2, 0, 0] = scg[3, -1, -1] = np.nan
    got = _hold_k3(*(torch.from_numpy(a).to(cuda) for a in (scg, rhc)))
    assert got[0].tolist() == [False, False, True, True, True]
    assert torch.isnan(got[2][:2]).all() and torch.isnan(got[1][2:4]).all()


@pytest.mark.parametrize("t", [1500, 12_289, 40_000, k4.gate_stage_max_len(),
                               k4.gate_stage_max_len() + 1])
def test_gate_and_normalize_long_windows(cuda, t):
    """K3 takes any T: past 12,288 samples (refused until the redesign),
    past the scg values its registers hold (C·T > 6,144), and at and
    one sample past the longest rhc window it stages in shared memory."""
    scg, rhc = _gate_windows(13, 4, t, seed=t)
    rhc[0, t - 60:t - 10] = rhc[0, t - 60]  # one flat position: kept
    got = _hold_k3(*(torch.from_numpy(a).to(cuda) for a in (scg, rhc)))
    assert got[0][0] and not got[0][[3, 5, 7, 11]].any()


def test_gate_and_normalize_kernel_rejects(cuda):
    scg, rhc = (torch.from_numpy(a).to(cuda) for a in _gate_windows(4, 2, 750))
    with pytest.raises(ValueError):
        k4.gate_and_normalize(scg.double(), rhc.double(), -50.0)
    with pytest.raises(ValueError):
        k4.gate_and_normalize(scg.transpose(1, 2).contiguous().transpose(1, 2), rhc, -50.0)
    with pytest.raises(ValueError):
        k4.gate_and_normalize(scg, rhc[:, ::2], -50.0)
    with pytest.raises(ValueError):
        k4.gate_and_normalize(scg, rhc.cpu(), -50.0)
    with pytest.raises(ValueError):
        k4.gate_and_normalize(scg, rhc[:3], -50.0)


def test_generator_fused_matches_plain_block(cuda):
    """The whole U-Net: 14 K1f launches against the plain block, same weights."""
    gen = Generator(4, torch.Generator().manual_seed(3)).to(cuda).eval()
    x = torch.rand(8, 4, 750, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = k1f.conv_in_relu.launches
    with torch.inference_mode():
        got = gen(x)
        want = gen(x, block=plain_block)
    assert k1f.conv_in_relu.launches == before + 14
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def _hold_k1(x, w, b, dy, need_dx):
    """K1f against the plain version (FWD_TOL absolute, and its relu masks
    within MASK_FLIP_SHARE of the plain version's), and K1b against the
    plain backward in float64 on K1f's masks (the kernels' own: K1b's dc
    pass recomputes c on the same core), BWD_TOL relative; each counted
    once."""
    counts = (k1f.conv_in_relu.launches, k1f.conv_in_relu_bwd.launches)
    y = k1f.conv_in_relu(x, w, b)
    got = k1f.conv_in_relu_bwd(x, w, b, dy, need_dx)
    torch.cuda.synchronize()
    assert (k1f.conv_in_relu.launches, k1f.conv_in_relu_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    want_y = k1f.conv_in_relu_plain(x, w, b)
    torch.testing.assert_close(y, want_y, atol=FWD_TOL, rtol=0)
    _masks_agree(y, want_y)
    _, want_dx = _bwd_f64_with_masks(x, w, b, dy, "in_relu", y > 0)
    want_dw, want_db = _dwdb_f64_with_masks(x, w, b, dy, "in_relu", y > 0)
    assert (got[0] is None) == (not need_dx)
    if need_dx:
        assert got[0].shape == x.shape and _rel(got[0], want_dx) <= BWD_TOL
    assert _rel(got[1], want_dw) <= BWD_TOL
    assert _rel(got[2], want_db, _db_scale(x, w, b, dy, "in_relu")) <= BWD_TOL


def _rel(got, want, floor: float = 1e-30) -> float:
    """|got - want| / max(|want|, floor), L2 norms."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), floor, 1e-30))


def _db_scale(x, w, b, dy, mode) -> float:
    """The floor under a bias gradient's relative error: in ``in_relu``
    mode |Σ_{n,t} |dc[n, o, t]||, the magnitude it sums to zero; else none."""
    from scgrhc_torch.ops.kernels import conv3

    if mode != "in_relu":
        return 1e-30
    dc = conv3.dc_from_dy(dy.float(), conv3.conv(x, w, b), mode)
    return float(dc.abs().sum(dim=(0, 2)).norm())


def _grads_close(got, want, names) -> None:
    """All gradients together within BWD_TOL; each weight on its own too
    (a bias before an instance norm has a zero gradient up to rounding)."""
    flat = [torch.cat([g.flatten() for g in gs]) for gs in (got, want)]
    assert _rel(*flat) <= BWD_TOL
    for n, g, r in zip(names, got, want):
        if g.dim() > 1:
            assert _rel(g, r) <= BWD_TOL, n


def _bwd_inputs(cuda, n, ci, o, t, seed=0, dtype=torch.float32):
    x, w, b = (torch.from_numpy(a).to(cuda).to(dtype) for a in _conv_inputs(n, ci, o, t, seed))
    dy = torch.from_numpy(
        np.random.default_rng(seed + 1).standard_normal((n, o, t)).astype(np.float32)
    ).to(cuda).to(dtype)
    return x, w, b, dy


@pytest.mark.parametrize(
    "n,ci,o,t,need_dx", [(3, 4, 64, 750, False), (3, 64, 128, 748, True),
                         (3, 512, 512, 744, True), (3, 256, 128, 747, True), (3, 7, 5, 1, True),
                         (3, 100, 24, 1024, True), (3, 1, 17, 129, True), (3, 3, 40, 7, True),
                         (2, 12, 20, 65_600, True)]
    + [(64, ci, o, t, ci != 4) for ci, o, t in GENERATOR_SHAPES]
)
def test_conv_in_relu_bwd_kernel_f32(cuda, n, ci, o, t, need_dx):
    """K1b against the plain backward in float64 on K1f's relu masks (the
    kernels' own: K1b recomputes c on the same tensor-core core, which sums
    in another order than cuDNN), and those masks against the plain
    version's within MASK_FLIP_SHARE: at the generator's layers at N = 64
    (dx but at the first, whose input needs none) and at ragged shapes."""
    x, w, b, dy = _bwd_inputs(cuda, n, ci, o, t)
    before = k1f.conv_in_relu_bwd.launches
    got = k1f.conv_in_relu_bwd(x, w, b, dy, need_dx)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu_bwd.launches == before + 1
    y = k1f.conv_in_relu(x, w, b)
    _masks_agree(y, k1f.conv_in_relu_plain(x, w, b))
    plain = k1f.conv_in_relu_bwd_plain(x, w, b, dy, need_dx)
    _, dx64 = _bwd_f64_with_masks(x, w, b, dy, "in_relu", y > 0)
    want = (dx64 if need_dx else None, *_dwdb_f64_with_masks(x, w, b, dy, "in_relu", y > 0))
    assert (got[0] is None) == (not need_dx)
    floors = (1e-30, 1e-30, _db_scale(x, w, b, dy, "in_relu"))
    for g, p, r, floor in zip(got, plain, want, floors):
        if r is not None:
            assert g.dtype == p.dtype and g.shape == p.shape
            assert _rel(g, r, floor) <= BWD_TOL
    again = k1f.conv_in_relu_bwd(x, w, b, dy, need_dx)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])  # deterministic


def test_conv_in_relu_bwd_kernel_bf16(cuda):
    x, w, b, dy = _bwd_inputs(cuda, 3, 256, 512, 744, dtype=torch.bfloat16)
    got = k1f.conv_in_relu_bwd(x, w, b, dy)
    want = k1f.conv_in_relu_bwd_plain(x.float(), w.float(), b.float(), dy.float())
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    floors = (1e-30, 1e-30, _db_scale(x, w, b, dy, "in_relu"))
    for g, r, floor in zip(got, want, floors):
        assert _rel(g, r, floor) <= BF16_TOL


def test_conv_in_relu_bwd_kernel_propagates_nan(cuda):
    x, w, b, dy = _bwd_inputs(cuda, 2, 4, 64, 750)
    dy[1, 3, 100] = float("nan")
    dx, dw, db = k1f.conv_in_relu_bwd(x, w, b, dy)
    assert torch.isnan(dx[1]).any() and not torch.isnan(dx[0]).any()
    assert torch.isnan(db[3]) and not torch.isnan(db[4])


@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("ci,o,t", [(5, 64, 750), (64, 128, 750), (512, 1, 750), (3, 17, 300)])
def test_critic_layer_kernels_f32(cuda, mode, ci, o, t):
    x, w, b, dy = _bwd_inputs(cuda, 4, ci, o, t)
    counts = (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches,
              k2.critic_layer_bwd_dwdb.launches)
    y = k2.critic_layer(x, w, b, mode)
    dx = k2.critic_layer_bwd_dx(x, w, b, dy, mode)
    dw, db = k2.critic_layer_bwd_dwdb(x, w, b, dy, mode)
    torch.cuda.synchronize()
    assert (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches,
            k2.critic_layer_bwd_dwdb.launches) == tuple(c + 1 for c in counts)
    assert _rel(y, k2.critic_layer_plain(x, w, b, mode)) <= FWD_TOL
    assert _rel(dx, k2.critic_layer_bwd_dx_plain(x, w, b, dy, mode)) <= BWD_TOL
    want_dw, want_db = k2.critic_layer_bwd_dwdb_plain(x, w, b, dy, mode)
    assert _rel(dw, want_dw) <= BWD_TOL
    assert _rel(db, want_db, _db_scale(x, w, b, dy, mode)) <= BWD_TOL


@pytest.mark.parametrize("mode", k2.MODES)
def test_critic_layer_kernels_bf16(cuda, mode):
    x, w, b, dy = _bwd_inputs(cuda, 4, 128, 256, 750, dtype=torch.bfloat16)
    f = [v.float() for v in (x, w, b, dy)]
    assert _rel(k2.critic_layer(x, w, b, mode), k2.critic_layer_plain(*f[:3], mode)) <= BF16_TOL
    assert _rel(k2.critic_layer_bwd_dx(x, w, b, dy, mode),
                k2.critic_layer_bwd_dx_plain(*f, mode)) <= BF16_TOL
    floors = (1e-30, _db_scale(*f, mode))
    for g, r, floor in zip(k2.critic_layer_bwd_dwdb(x, w, b, dy, mode),
                           k2.critic_layer_bwd_dwdb_plain(*f, mode), floors):
        assert _rel(g, r, floor) <= BF16_TOL


# The generator's biases that feed an instance norm: their gradient is zero
# up to rounding, so its sign, and Adam's first move of them, is noise.
G_IN_BIASES = frozenset(
    {f"{blk}.{i}.bias" for blk in ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1")
     for i in (0, 3)}
    | {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g", "psi")})


def test_generator_backward_reaches_every_parameter(cuda):
    """Through ConvInReLU (K1f forward, K1b backward) every generator
    parameter gets a finite gradient on the card, nonzero for every weight
    and for every bias not followed by an instance norm (those are zero up
    to rounding); the same backward again gives the same bits; and the
    gradients sit within the f32 envelope of the plain block's in float64,
    as the plain block's own f32 gradients do (both readings printed)."""
    gen = Generator(4, torch.Generator().manual_seed(5)).to(cuda)
    x = torch.rand(4, 4, 750, generator=torch.Generator().manual_seed(6)).to(cuda)
    names = [n for n, _ in gen.named_parameters()]

    def grads(module, block, inputs):
        module.zero_grad()
        module(inputs, block=block, rng=torch.Generator(device=cuda).manual_seed(0),
               train=True).square().mean().backward()
        return [p.grad.clone() for p in module.parameters()]

    before = k1f.conv_in_relu_bwd.launches
    got = grads(gen, fused_block, x)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu_bwd.launches == before + 14
    for name, g in zip(names, got):
        assert torch.isfinite(g).all(), name
        if name not in G_IN_BIASES:
            assert g.abs().max() > 0, name
    assert all(torch.equal(a, b) for a, b in zip(grads(gen, fused_block, x), got))
    plain32 = grads(gen, plain_block, x)
    g64 = Generator(4, torch.Generator().manual_seed(5)).to(cuda, torch.float64)
    want = grads(g64, plain_block, x.double())
    worst = {}
    for what, gs in (("kernel path", got), ("plain f32", plain32)):
        rels = {n: _rel(g, r) for n, g, r in zip(names, gs, want) if g.dim() > 1}
        worst[what] = max(rels.items(), key=lambda kv: kv[1])
        print(f"generator weight gradients, {what} against float64: worst {worst[what]}")
        assert worst[what][1] <= GEN_GRAD_TOL, (what, worst[what])


def test_critic_gradient_penalty_matches_float64_plain(cuda):
    """The GP and its parameter gradient (second order through BwdDx) on the
    kernels, in f32, against the same critic through the plain formulas in
    float64 on the card, on the kernel path's relu masks: K2f's, which
    K2dx's dc pass recomputes bit for bit, for the layers, their first-order
    gradients and the second order (BwdDx's closed-form vjp differentiates
    the masks K2dx applied).  A mask that flips between f32 and float64
    moves these gradients by about 2e-3 (on an H100 the f32 plain path sat
    2.4e-3 from float64's own masks, one flip at 256 -> 512), so the kernel
    path is held on its own masks, and its masks to float64's own within
    MASK_FLIP_SHARE."""
    critic = Critic(4, torch.Generator().manual_seed(7)).to(cuda)
    g = torch.Generator().manual_seed(8)
    scg, rhc, pred = (torch.rand(4, c, 750, generator=g).to(cuda) for c in (4, 1, 1))
    eps = torch.rand(4, 1, 1, generator=g).to(cuda)
    before = k2.critic_layer_bwd_dx.launches

    def gp_and_grads(module, fn, *inputs):
        # the score's bias does not reach the input gradient: its gradient is 0
        params = list(module.parameters())
        gp = wgan.gradient_penalty_from_eps(fn, *inputs)
        grads = torch.autograd.grad(gp, params, allow_unused=True)
        return float(gp.detach()), [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(params, grads)]

    gp_k, grads_k = gp_and_grads(critic, critic, scg, rhc, pred, eps)
    assert k2.critic_layer_bwd_dx.launches > before
    c64 = Critic(4, torch.Generator().manual_seed(7)).to(cuda, torch.float64)
    # the interpolant as gradient_penalty_from_eps forms it, through each path
    x = torch.cat((scg, eps * rhc + (1.0 - eps) * pred), dim=1)
    masks, h, h64 = [], x, x.double()
    with torch.no_grad():
        for conv, conv64, mode in zip(critic.model.values(), c64.model.values(), LAYER_MODES):
            y = k2.critic_layer(h, conv.weight, conv.bias, mode)
            y64 = k2.critic_layer_plain(h64, conv64.weight, conv64.bias, mode)
            masks.append(y > 0)
            if mode != "linear":
                _masks_agree(y, y64)
            h, h64 = y, y64
    gp_p, grads_p = gp_and_grads(c64, _critic_f64_on_masks(c64, masks),
                                 *(v.double() for v in (scg, rhc, pred, eps)))
    assert abs(gp_k - gp_p) <= FWD_TOL * abs(gp_p)
    names = [n for n, _ in critic.named_parameters()]
    rels = {n: _rel(g, r) for n, g, r in zip(names, grads_k, grads_p) if g.dim() > 1}
    print(f"critic weight gradients of the GP against float64: worst "
          f"{max(rels.items(), key=lambda kv: kv[1])}")
    _grads_close(grads_k, grads_p, names)


def _layer_f64_with_mask(x, w, b, mode, mask):
    """The plain layer (conv3.layer_plain) in float64 with the relu mask
    given in place of its own sign test; differentiable."""
    from scgrhc_torch.ops.kernels import conv3

    c = conv3.conv(x.double(), w.double(), b.double())
    if mode == "linear":
        return c
    return (instance_norm(c) if mode == "in_relu" else c) * mask.double()


class _BwdDxF64(torch.autograd.Function):
    """BwdDx in float64: the input gradient on the masks ``mask`` (K2dx's:
    K2f's), and its own gradient on the same masks (those BwdDx's
    closed-form vjp differentiates)."""

    @staticmethod
    def forward(ctx, x, w, b, dy, mode, mask):
        ctx.save_for_backward(x, w, b, dy)
        ctx.mode, ctx.mask = mode, mask
        return _bwd_f64_with_masks(x, w, b, dy, mode, mask)[1]

    @staticmethod
    def backward(ctx, ct):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = _bwd_f64_with_masks(*ins, ctx.mode, ctx.mask)[1]
            grads = torch.autograd.grad(out, ins, ct, allow_unused=True)
        return (*grads, None, None)


def _critic_f64_on_masks(c64, masks):
    """A critic function (as Critic.forward with ``ct``) for the float64
    critic ``c64`` on the relu masks of each layer."""

    def forward(x, ct):
        layers = list(zip(c64.model.values(), LAYER_MODES))
        inputs, h = [], x
        for (conv, mode), mask in zip(layers, masks):
            inputs.append(h)
            h = _layer_f64_with_mask(h, conv.weight, conv.bias, mode, mask)
        g = ct
        for (conv, mode), h_in, mask in reversed(list(zip(layers, inputs, masks))):
            g = _BwdDxF64.apply(h_in, conv.weight, conv.bias, g, mode, mask)
        return h, g

    return forward


CRITIC_LAYERS = [(5, 64, "relu"), (64, 128, "in_relu"), (128, 256, "in_relu"),
                 (256, 512, "in_relu"), (512, 1, "linear")]
GENERATOR_LAYERS = [(4, 64, 750), (64, 64, 750), (64, 128, 748), (128, 128, 748),
                    (128, 256, 746), (256, 256, 746), (256, 512, 744), (512, 512, 744),
                    (512, 256, 746), (256, 128, 748), (128, 64, 750)]


def _dw_paths(x, w, b, dy, mode):
    """(name, kernel, plain) for the two dw launches of a layer: K2dw in
    ``mode`` and K1b's dw stage (in_relu), each → (dw, db)."""
    return (
        ("K2dw", lambda *v: k2.critic_layer_bwd_dwdb(*v, mode),
         lambda *v: k2.critic_layer_bwd_dwdb_plain(*v, mode)),
        ("K1b", lambda *v: k1f.conv_in_relu_bwd(*v, need_dx=False)[1:],
         lambda *v: k1f.conv_in_relu_bwd_plain(*v, need_dx=False)[1:]),
    )


def _hold_dw(x, w, b, dy, mode, paths=("K2dw", "K1b")):
    """Each path's dw within DW_F32_TOL and db within DW_F32_TOL of its
    reference (db over its scale in in_relu mode), and a repeated launch
    equal bit for bit.  Both dc passes run the tensor-core conv core, whose
    f32 sums differ from cuDNN's, so a relu mask can flip between the two
    (one flip at N = 8 moves dw by about 1e-3): the reference is the plain
    backward in float64 on the forward kernel's relu masks (K2f's for K2dw,
    K1f's for K1b), and those masks are held to the plain version's within
    MASK_FLIP_SHARE."""
    for name, kern, _ in _dw_paths(x, w, b, dy, mode):
        if name not in paths:
            continue
        m = mode if name == "K2dw" else "in_relu"
        dw, db = kern(x, w, b, dy)
        if name == "K2dw":
            y, want = k2.critic_layer(x, w, b, mode), k2.critic_layer_plain(x, w, b, mode)
        else:
            y, want = k1f.conv_in_relu(x, w, b), k1f.conv_in_relu_plain(x, w, b)
        if m != "linear":
            _masks_agree(y, want)
        want_dw, want_db = _dwdb_f64_with_masks(x, w, b, dy, m, y > 0)
        assert dw.shape == want_dw.shape and db.shape == want_db.shape, name
        assert _rel(dw, want_dw) <= DW_F32_TOL, (name, _rel(dw, want_dw))
        assert _rel(db, want_db, _db_scale(x, w, b, dy, m)) <= DW_F32_TOL, name
        again = kern(x, w, b, dy)
        assert torch.equal(again[0], dw) and torch.equal(again[1], db), name


@pytest.mark.parametrize("ci,o,mode", CRITIC_LAYERS)
def test_critic_dw_f32_within_rounding(cuda, ci, o, mode):
    _hold_dw(*_bwd_inputs(cuda, 8, ci, o, 750), mode, paths=("K2dw",))


@pytest.mark.parametrize("ci,o,t", GENERATOR_LAYERS)
def test_conv_in_relu_dw_f32_within_rounding(cuda, ci, o, t):
    _hold_dw(*_bwd_inputs(cuda, 8, ci, o, t), "in_relu", paths=("K1b",))


@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("ci,o,t", [(512, 1, 750), (64, 1, 33), (3, 5, 1), (100, 24, 1024),
                                    (7, 5, 1), (3, 17, 300)])
def test_dw_narrow_and_ragged(cuda, n, ci, o, t):
    """O = 1 and 5 stream; O = 17 and 24 take ragged tensor-core tiles;
    T = 1, 33 and 1024 ragged slices; N = 1 a single split.  K2dw in the
    linear mode (dc = dy), K1b in its in_relu mode."""
    _hold_dw(*_bwd_inputs(cuda, n, ci, o, t), "linear")


def test_dw_bf16_at_widest_critic_layer(cuda):
    x, w, b, dy = _bwd_inputs(cuda, 4, 256, 512, 750, dtype=torch.bfloat16)
    f = [v.float() for v in (x, w, b, dy)]
    for name, kern, plain in _dw_paths(x, w, b, dy, "in_relu"):
        got, want = kern(x, w, b, dy), plain(*f)
        assert got[0].dtype == torch.float32
        assert _rel(got[0], want[0]) <= BF16_TOL, name
        assert _rel(got[1], want[1], _db_scale(*f, "in_relu")) <= BF16_TOL, name
        again = kern(x, w, b, dy)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]), name


# Every dw launch of a train.w06 step at its N = 64: the generator's 11
# distinct layer shapes (K1b, in_relu) and its first layer at train.w06's
# 3 SCG channels, the critic's four from 16 output channels (K2dw in their
# modes) and its first layer at 4 channels, and the linear dw of K2dx's
# closed-form vjp at 64 -> 128, 128 -> 256 and 256 -> 512 (K2dw, linear);
# in f32 each takes the warpgroup MMA (conv3.dw_plan).
STEP_DW = ([("K1b", ci, o, t, "in_relu") for ci, o, t in [(3, 64, 750)] + GENERATOR_LAYERS]
           + [("K2dw", ci, o, 750, mode)
              for ci, o, mode in [(4, 64, "relu")] + CRITIC_LAYERS if o >= 16]
           + [("K2dw", ci, o, 750, "linear") for ci, o in ((64, 128), (128, 256), (256, 512))])


def _dw_counts(fn):
    """fn(), the dw launches it made by path (conv3.dw_path_launches) and
    the warpgroup-MMA launches by how their rows were copied
    (conv3.dw_copy_launches), each without the zero counts."""
    from scgrhc_torch.ops.kernels import conv3

    paths, copies = dict(conv3.dw_path_launches), conv3.dw_copy_launches()
    out = fn()
    new_copies = conv3.dw_copy_launches()
    return (out,
            {k: v - paths[k] for k, v in conv3.dw_path_launches.items() if v != paths[k]},
            {k: v - copies[k] for k, v in new_copies.items() if v != copies[k]})


def _dw_copy(ci, o, t):
    """How the warpgroup-MMA dw stage copies its rows for x (N, ci, t) and
    dc (N, o, t), both 16-byte aligned: tensor-map boxes where T is even
    and, with T = 2 (mod 4), the row pairs hold whole channels."""
    tma = t % 4 == 0 or (t % 2 == 0 and ci % 2 == 0 and o % 2 == 0)
    return "tma" if tma else "cp.async"


@pytest.mark.parametrize("path,ci,o,t,mode", STEP_DW)
def test_dw_f32_at_every_step_shape_n64(cuda, path, ci, o, t, mode):
    """The f32 dw stage at the main path's batch, N = 64, on each shape a
    step runs: within DW_F32_TOL of float64 on the kernels' relu masks,
    the same bits on a repeat, on the warpgroup MMA, its rows copied as
    the shape allows."""
    from scgrhc_torch.ops.kernels import conv3

    ins = _bwd_inputs(cuda, 64, ci, o, t)
    _, paths, copies = _dw_counts(lambda: _hold_dw(*ins, mode, paths=(path,)))
    assert conv3.dw_plan(64, ci, o).path == "wgmma"
    assert paths == {"wgmma": 2}  # the kernel and its repeat
    assert copies == {_dw_copy(ci, o, t): 2}


# Ragged cases of the warpgroup-MMA dw stage, K2dw in the linear mode (dc
# = dy): odd T (4-byte copies), T past and short of a 32-step stage, N not
# divisible by the splits (63 at 256 -> 512: 4 splits), N = 1 (one split),
# N = 65 at 64 -> 64 (65 splits of one tile), more tiles than the
# persistent grid has blocks (1040 -> 1100: 306), and C_in and O that fill
# part of a 64 x 64 tile (16, 17, 100, 129, 200).  Row pairs (T = 2 mod
# 4, even channel counts): a partial channel tile whose boxes read into
# the next sample's rows (100 -> 70, 64 -> 130, 18 -> 66), T shorter than
# a stage (6) and than two (130), N the splits do not divide (63, 3, 5).
@pytest.mark.parametrize("n,ci,o,t", [
    (64, 256, 512, 745), (63, 256, 512, 744), (1, 512, 512, 744), (1, 16, 16, 1),
    (65, 64, 64, 33), (2, 1040, 1100, 40), (5, 17, 129, 7), (33, 100, 24, 1024),
    (3, 200, 70, 1500), (2, 64, 128, 31), (64, 128, 256, 749),
    (63, 100, 70, 746), (3, 200, 24, 6), (2, 64, 130, 130), (5, 18, 66, 750)])
def test_dw_wgmma_ragged(cuda, n, ci, o, t):
    from scgrhc_torch.ops.kernels import conv3

    ins = _bwd_inputs(cuda, n, ci, o, t)
    _, paths, copies = _dw_counts(lambda: _hold_dw(*ins, "linear", paths=("K2dw",)))
    assert conv3.dw_plan(n, ci, o).path == "wgmma" and paths == {"wgmma": 2}
    assert copies == {_dw_copy(ci, o, t): 2}


@pytest.mark.parametrize("ci,o", [(256, 512), (64, 64)])
def test_dw_wgmma_propagates_nan(cuda, ci, o):
    """A NaN in dc reaches every dw entry of its output channel and no
    other; db likewise."""
    x, w, b, dy = _bwd_inputs(cuda, 8, ci, o, 750)
    dy[5, 3, 100] = float("nan")
    dw, db = k2.critic_layer_bwd_dwdb(x, w, b, dy, "linear")
    assert torch.isnan(dw[3]).all() and not torch.isnan(dw[torch.arange(o) != 3]).any()
    assert torch.isnan(db[3]) and not torch.isnan(db[torch.arange(o) != 3]).any()


def test_dw_plan_mirrors_the_c_launcher(cuda):
    """conv3.dw_plan against the C launchers' own (scgrhc_dw_plan), at every
    step shape and N = 1, 3, 32, 64, in both dtypes."""
    from scgrhc_torch.ops.kernels import conv3

    shapes = {(ci, o) for _, ci, o, _, _ in STEP_DW} | {(4, 64), (5, 64), (512, 1), (17, 129)}
    for n in (1, 3, 32, 64):
        for ci, o in sorted(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                assert conv3.c_dw_plan(n, ci, o, dtype) == conv3.dw_plan(n, ci, o, dtype)


# The critic's conv passes (K2f, K2dx): (N, C_in, O, T).  The five critic
# layers, and the first at waveform_06's 4 channels (a 4-column dx); a tiny
# case for the fragment layouts (one tile, one channel stage, one step
# tile); ragged O (17, 20, 24, 129: parts of a column tile), C_in (1, 3, 5,
# 7: parts of an 8-channel stage) and T (1, 7, 129, 1023, 1024, 1500 and
# past 65,536: ragged and odd step tiles) and N (1, 33, and 64 over
# more tiles than the persistent grid has blocks); and the streaming
# forward with O = 3, 5.
CONV_SHAPES = [(4, 5, 64, 750), (4, 64, 128, 750), (4, 128, 256, 750), (4, 256, 512, 750),
               (4, 512, 1, 750), (1, 8, 16, 8), (1, 3, 24, 1), (33, 5, 24, 7),
               (1, 3, 24, 1023), (33, 5, 24, 1024), (33, 24, 5, 7), (1, 24, 3, 1023),
               (4, 4, 64, 750), (2, 1, 16, 129), (2, 7, 17, 1500), (2, 70, 129, 129),
               (1, 16, 20, 65_600), (64, 64, 64, 750)]


# The share of relu masks (c > 0, or x̂ > 0) on which the kernels and the
# f32 plain version may disagree: the tensor-core core sums in another order
# than cuDNN, and either sits a few 1e-7 from float64, so a mask flips where
# c or x̂ lies within that of 0 (a few in a million; one flip at N = 4 moves
# dx by about 1e-3 relative, the whole of BWD_TOL).
MASK_FLIP_SHARE = 1e-5


def _masks_agree(y, want):
    """The relu masks of a kernel output ``y`` against the plain output's."""
    flips = int(((y > 0) != (want > 0)).sum())
    assert flips <= MASK_FLIP_SHARE * y.numel(), (flips, y.numel())


def _bwd_f64_with_masks(x, w, b, dy, mode, mask):
    """The plain backward (conv3.layer_bwd_plain's formulas) in float64,
    with the relu mask given (the kernels' own, read from K2f's output)
    instead of its own sign test: dc, and dx = conv3_t(w, dc rounded to x's
    dtype).  Differentiable."""
    import torch.nn.functional as F

    from scgrhc_torch.ops.kernels import conv3

    x64, w64, b64, dy64 = (v.double() for v in (x, w, b, dy))
    mask = mask.double()
    if mode == "linear":
        dc = dy64
    elif mode == "relu":
        dc = dy64 * mask
    else:
        c = conv3.conv(x64, w64, b64)
        mean = c.mean(dim=-1, keepdim=True)
        rsig = torch.rsqrt(torch.clamp_min((c * c).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
                           + conv3.IN_EPS)
        xhat = (c - mean) * rsig
        g = dy64 * mask
        dc = rsig * (g - g.mean(dim=-1, keepdim=True)
                     - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    return dc, F.conv_transpose1d(dc.to(x.dtype).double(), w64, padding=1)


def _dwdb_f64_with_masks(x, w, b, dy, mode, mask):
    """dw (the product over dc rounded to x's dtype) and db of the plain
    backward in float64 on the relu mask given."""
    dc, _ = _bwd_f64_with_masks(x, w, b, dy, mode, mask)
    dw = torch.nn.grad.conv1d_weight(x.double(), w.shape, dc.to(x.dtype).double(), padding=1)
    return dw, dc.sum(dim=(0, 2))


@pytest.mark.parametrize("ci,o,mode", CRITIC_LAYERS)
def test_bwd_dx_vjp_against_float64(cuda, ci, o, mode):
    """BwdDx's backward, K2dx's closed-form vjp (the GP's second order), on
    the card at the critic's layers, T = 750, against the vjp of the plain
    input gradient in float64 on the kernels' own relu masks (K2f's, which
    K2dx's dc pass recomputes bit for bit): each gradient within BWD_TOL,
    an in_relu bias gradient over |Σ_{n,t} |d_c|| (it sums to zero), None
    where the gradient is zero (x and b outside in_relu); one launch of the
    vjp a node, no cuDNN conv, and the same bits on a repeat."""
    import torch.nn.functional as F

    from scgrhc_torch.ops.kernels import conv3

    x, w, b, dy = _bwd_inputs(cuda, 4, ci, o, 750, seed=ci + o)
    u = torch.from_numpy(np.random.default_rng(ci + 7).standard_normal(x.shape)
                         .astype(np.float32)).to(cuda)

    def vjp():
        ins = [t.clone().requires_grad_() for t in (x, w, b, dy)]
        return torch.autograd.grad(k2.fused_layer_bwd_dx(*ins, mode), ins, u,
                                   allow_unused=True)

    before = (k2.critic_layer_bwd_dx.launches, k2.critic_layer_bwd_dx_vjp.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = vjp()
        torch.cuda.synchronize()
    assert (k2.critic_layer_bwd_dx.launches, k2.critic_layer_bwd_dx_vjp.launches) == (
        before[0] + 1, before[1] + 1)
    names = [e.key for e in prof.key_averages()]
    assert any("dw_" in n for n in names), names  # the profiler saw the kernels
    assert not [n for n in names if "xmma" in n or "cudnn" in n], names
    y = k2.critic_layer(x, w, b, mode)
    if mode != "linear":
        _masks_agree(y, k2.critic_layer_plain(x, w, b, mode))
    ins64 = [t.double().requires_grad_() for t in (x, w, b, dy)]
    want = torch.autograd.grad(_bwd_f64_with_masks(*ins64, mode, y > 0)[1], ins64,
                               u.double(), allow_unused=True)
    floor = 1e-30
    if mode == "in_relu":
        x64, w64, b64, dy64 = (t.detach() for t in ins64)
        c64 = conv3.conv(x64, w64, b64)
        v64 = F.conv1d(u.double(), w64, padding=1)
        d_c = k2.dx_vjp_row_plain(c64, k2.row_stats_plain(c64), dy64, v64, mode)[1]
        floor = float(d_c.abs().sum(dim=(0, 2)).norm())
    for name, g, r in zip(("x", "w", "b", "dy"), got, want):
        assert (g is None) == (r is None) == (mode != "in_relu" and name in "xb"), name
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == r.shape, name
            rel = _rel(g, r, floor if name == "b" else 1e-30)
            assert rel <= BWD_TOL, (name, rel)
    again = vjp()
    assert all(a is None if g is None else torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("mode", k2.MODES)
def test_bwd_dx_bf16_keeps_the_plain_vjp(cuda, mode):
    """In bf16 BwdDx's backward is the plain version's vjp (``_plain_vjp``),
    chosen by the dtype: the same bits as calling it, and no launch of the
    f32 closed form."""
    import types

    x, w, b, dy = _bwd_inputs(cuda, 4, 128, 256, 750, dtype=torch.bfloat16)
    u = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    ins = [t.clone().requires_grad_() for t in (x, w, b, dy)]
    before = k2.critic_layer_bwd_dx_vjp.launches
    got = torch.autograd.grad(k2.fused_layer_bwd_dx(*ins, mode), ins, u, allow_unused=True)
    assert k2.critic_layer_bwd_dx_vjp.launches == before
    ctx = types.SimpleNamespace(saved_tensors=(x, w, b, dy), needs_input_grad=(True,) * 4,
                                mode=mode)
    want = k2._plain_vjp(ctx, k2.critic_layer_bwd_dx_plain, (u,))[:4]
    assert all(g is None if r is None else torch.equal(g, r) for g, r in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("n,ci,o,t", CONV_SHAPES)
def test_critic_conv_core(cuda, n, ci, o, t, mode, dtype):
    """K2f and K2dx on the tensor-core core (stream below 16 output
    channels): y against the plain version, its relu masks against the
    plain version's, dx against the plain backward in float64 on those
    masks, and a repeat launch equal bit for bit."""
    from scgrhc_torch.ops.kernels import conv3

    x, w, b, dy = _bwd_inputs(cuda, n, ci, o, t, seed=o + t, dtype=dtype)
    f = [v.float() for v in (x, w, b, dy)]
    counts = (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches)
    paths = dict(conv3.path_launches)
    y = k2.critic_layer(x, w, b, mode)
    dx = k2.critic_layer_bwd_dx(x, w, b, dy, mode)
    torch.cuda.synchronize()
    assert (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches) == (
        counts[0] + 1, counts[1] + 1)
    # the forward, the dc pass's recompute (but in the linear mode) and dx:
    # on the f32 core in f32, mma.sync in bf16, streams below 16 channels
    core = "stream" if o < 16 else "wgmma" if dtype == torch.float32 else "mma"
    passes = 3 if mode != "linear" else 2
    assert {k: conv3.path_launches[k] - v for k, v in paths.items()} == {
        p: passes * int(p == core) for p in paths}
    assert y.dtype == dtype and y.shape == (n, o, t) and dx.dtype == dtype and dx.shape == x.shape
    fwd_tol, bwd_tol = (FWD_TOL, BWD_TOL) if dtype == torch.float32 else (BF16_TOL, BF16_TOL)
    want = k2.critic_layer_plain(*f[:3], mode)
    assert _rel(y, want) <= fwd_tol
    if mode != "linear":
        _masks_agree(y, want)
    _, want_dx = _bwd_f64_with_masks(x, w, b, dy, mode, y > 0)
    assert _rel(dx, want_dx) <= bwd_tol
    assert torch.equal(k2.critic_layer(x, w, b, mode), y)
    assert torch.equal(k2.critic_layer_bwd_dx(x, w, b, dy, mode), dx)


@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("ci,o", [(64, 128), (512, 1), (4, 64), (256, 512)])
def test_critic_conv_core_propagates_nan(cuda, mode, ci, o):
    """A NaN in one sample's x reaches that sample's y only; a NaN in one
    sample's dy reaches that sample's dx only."""
    x, w, b, dy = _bwd_inputs(cuda, 2, ci, o, 750)
    xn, dyn = x.clone(), dy.clone()
    xn[1, 2, 100] = float("nan")
    dyn[1, 0, 100] = float("nan")
    y = k2.critic_layer(xn, w, b, mode)
    assert torch.isnan(y[1]).any() and not torch.isnan(y[0]).any()
    dx = k2.critic_layer_bwd_dx(x, w, b, dyn, mode)
    assert torch.isnan(dx[1]).any() and not torch.isnan(dx[0]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("pass_", ["fwd", "dc", "dx"])
def test_conv_plan_mirrors_the_c_launcher(cuda, mode, pass_, dtype):
    """conv3.conv_plan and conv3.wsplit_numel, which the CPU tests hold,
    are the plan and the split-weight sizes the C launchers take."""
    from scgrhc_torch.ops.kernels import conv3

    for n, ci, o, t in CONV_SHAPES + [(32, 256, 512, 750), (65535, 7, 15, 4096),
                                      (70_000, 4, 16, 8), (1, 512, 512, 900_000)]:
        plan, ws_fwd, ws_dx = conv3.c_plan(n, ci, o, t, mode, pass_, dtype)
        assert conv3.conv_plan(n, ci, o, t, mode, pass_, dtype) == plan
        assert (conv3.wsplit_numel(ci, o), conv3.wsplit_numel(o, ci)) == (ws_fwd, ws_dx)


@pytest.mark.parametrize("ci,o,mode", CRITIC_LAYERS)
def test_critic_layers_at_1500_steps(cuda, ci, o, mode):
    """The critic's five layers at a 3-s window (T = 1500): K2f against the
    plain version, and K2dx and K2dw against the plain backward in float64
    on K2f's relu masks (dw within DW_F32_TOL, as at T = 750)."""
    x, w, b, dy = _bwd_inputs(cuda, 4, ci, o, 1500, seed=ci)
    y = k2.critic_layer(x, w, b, mode)
    dx = k2.critic_layer_bwd_dx(x, w, b, dy, mode)
    dw, db = k2.critic_layer_bwd_dwdb(x, w, b, dy, mode)
    torch.cuda.synchronize()
    want = k2.critic_layer_plain(x, w, b, mode)
    assert _rel(y, want) <= FWD_TOL
    if mode != "linear":
        _masks_agree(y, want)
    _, want_dx = _bwd_f64_with_masks(x, w, b, dy, mode, y > 0)
    assert _rel(dx, want_dx) <= BWD_TOL
    want_dw, want_db = _dwdb_f64_with_masks(x, w, b, dy, mode, y > 0)
    assert _rel(dw, want_dw) <= DW_F32_TOL
    assert _rel(db, want_db, _db_scale(x, w, b, dy, mode)) <= DW_F32_TOL


@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("ci", [3, 24, 512])
@pytest.mark.parametrize("o", [1, 5, 15])
def test_dx_below_16_output_channels(cuda, o, ci, mode):
    """dx below 16 output channels (the score layer's 512 -> 1 and its
    neighbours), a stream over dc, against the plain backward in float64
    on K2f's relu masks, and a repeat launch equal bit for bit."""
    x, w, b, dy = _bwd_inputs(cuda, 4, ci, o, 750, seed=o * ci)
    before = k2.critic_layer_bwd_dx.launches
    dx = k2.critic_layer_bwd_dx(x, w, b, dy, mode)
    torch.cuda.synchronize()
    assert k2.critic_layer_bwd_dx.launches == before + 1
    y = k2.critic_layer(x, w, b, mode)
    if mode != "linear":
        _masks_agree(y, k2.critic_layer_plain(x, w, b, mode))
    _, want = _bwd_f64_with_masks(x, w, b, dy, mode, y > 0)
    assert dx.shape == x.shape and _rel(dx, want) <= BWD_TOL
    assert torch.equal(k2.critic_layer_bwd_dx(x, w, b, dy, mode), dx)


@pytest.mark.parametrize("o", [16, 1])
def test_past_65535_samples(cuda, o):
    """A narrow layer (C_in 4, T 8) at N = 65,543, past a grid axis's 65535
    blocks, so the launchers walk the samples in two chunks: K1f and K1b
    (O = 16), and K2f, K2dx, K2dw in every mode (O = 16 on the core, O = 1
    on the streams), against the plain versions (the backward in float64
    on the kernels' own relu masks)."""
    x, w, b, dy = _bwd_inputs(cuda, 65_543, 4, o, 8)
    if o >= 16:
        _hold_k1(x, w, b, dy, need_dx=True)
    for mode in k2.MODES:
        y = k2.critic_layer(x, w, b, mode)
        want = k2.critic_layer_plain(x, w, b, mode)
        assert _rel(y, want) <= FWD_TOL
        if mode != "linear":
            _masks_agree(y, want)
        _, want_dx = _bwd_f64_with_masks(x, w, b, dy, mode, y > 0)
        assert _rel(k2.critic_layer_bwd_dx(x, w, b, dy, mode), want_dx) <= BWD_TOL
        want_dw, want_db = _dwdb_f64_with_masks(x, w, b, dy, mode, y > 0)
        dw, db = k2.critic_layer_bwd_dwdb(x, w, b, dy, mode)
        assert _rel(dw, want_dw) <= BWD_TOL
        assert _rel(db, want_db, _db_scale(x, w, b, dy, mode)) <= BWD_TOL


@pytest.mark.parametrize("o", [1, 15])
def test_dw_stream_at_its_shared_memory_limit(cuda, o):
    """Below 16 output channels dw holds one sample's dc in a block's shared
    memory: at conv3.dw_stream_max_len the kernel launches and agrees with
    the plain version; one step more is refused with the limit named."""
    from scgrhc_torch.ops.kernels import conv3

    t = conv3.dw_stream_max_len(o)
    x, w, b, dy = _bwd_inputs(cuda, 2, 3, o, t)
    dw, db = k2.critic_layer_bwd_dwdb(x, w, b, dy, "linear")
    want_dw, want_db = k2.critic_layer_bwd_dwdb_plain(x, w, b, dy, "linear")
    assert _rel(dw, want_dw) <= DW_F32_TOL and _rel(db, want_db) <= DW_F32_TOL
    x, w, b, dy = _bwd_inputs(cuda, 2, 3, o, t + 1)
    with pytest.raises(ValueError, match="shared memory"):
        k2.critic_layer_bwd_dwdb(x, w, b, dy, "linear")
    k2.critic_layer_bwd_dx(x, w, b, dy, "linear")  # dx alone has no limit


def test_trace_records_k1f_on_the_card(cuda, tmp_path):
    """``core.trace.trace`` on the card: one K1f launch inside the block
    shows in the Chrome trace as the conv core and the row pass, with
    device times."""
    import json

    from scgrhc_torch.core import trace

    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(4, 64, 128, 750))
    k1f.conv_in_relu(x, w, b)  # the first-use build stays outside the trace
    torch.cuda.synchronize()
    before = k1f.conv_in_relu.launches
    with trace.trace("k1f", out_dir=str(tmp_path), device=cuda):
        k1f.conv_in_relu(x, w, b)
        torch.cuda.synchronize()
    assert k1f.conv_in_relu.launches == before + 1
    files = list((tmp_path / "k1f").iterdir())
    assert len(files) == 1
    with open(files[0]) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    names = [e["name"] for e in kernels]
    assert sum("conv_mma_kernel" in n for n in names) >= 1, names
    assert sum("row_kernel" in n for n in names) >= 1, names
    assert all(e["dur"] > 0 for e in kernels)


def test_bench_kernels_mode_on_the_card(cuda):
    """``python -m scgrhc_torch.bench --mode kernels`` prints one line, with
    the card's name, from K3 and K4 on the card."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "scgrhc_torch.bench", "--mode", "kernels"],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "cuda_gate_normalize" and line["value"] > 0
    assert line["device"] == torch.cuda.get_device_name(0) and line["power_limit"]
    assert line["vs_baseline"] > 0 and line["stream_norm_speedup"] > 0


# ---- whole records (models/cp.py) and int8 (models/quant.py) ---------------------

# The continuous mode's length on an 1800-s record, and the factor within
# which the kernel path must stay of the plain f32 path's distance from
# float64 (both on the card).
T_RECORD = 900_000
ENVELOPE_FACTOR = 2.0


@pytest.mark.parametrize("n,ci,o,t", [(1, 256, 512, 8193), (2, 64, 128, 20_000),
                                      (1, 512, 512, T_RECORD)])
def test_conv_in_relu_row_pieces_against_float64(cuda, n, ci, o, t):
    """Past 8192 steps K1f's row pass runs in pieces (row_part_kernel,
    row_apply_kernel): against the layer in float64, the kernel stays within
    ENVELOPE_FACTOR times the plain f32 version's distance, at inputs in
    [0, 1) like the continuous mode's normalized record."""
    from scgrhc_torch.ops.kernels import conv3

    assert conv3.conv_plan(n, ci, o, t, "in_relu").row_parts > 0
    gen = torch.Generator(device=cuda).manual_seed(t)
    bound = 1.0 / np.sqrt(ci * 3)
    x = torch.rand(n, ci, t, device=cuda, generator=gen)
    w = (torch.rand(o, ci, 3, device=cuda, generator=gen) * 2 - 1) * bound
    b = (torch.rand(o, device=cuda, generator=gen) * 2 - 1) * bound
    got = k1f.conv_in_relu(x, w, b)
    plain = k1f.conv_in_relu_plain(x, w, b)
    ref = k1f.conv_in_relu_plain(x.double(), w.double(), b.double())
    kernel_err = float((got - ref).abs().max())
    plain_err = float((plain - ref).abs().max())
    print(f"\nK1f rows of {t} steps, {ci}->{o}: kernel vs f64 {kernel_err:.3g}, plain f32 "
          f"vs f64 {plain_err:.3g}")
    assert kernel_err <= ENVELOPE_FACTOR * plain_err
    gb = k1f.conv_in_relu(x.bfloat16(), w.bfloat16(), b.bfloat16()).float()
    wantb = k1f.conv_in_relu_plain(x.bfloat16().float(), w.bfloat16().float(),
                                   b.bfloat16().float())
    torch.testing.assert_close(gb, wantb, atol=BF16_TOL, rtol=1e-2)


def test_continuous_forward_against_float64_at_a_whole_record(cuda):
    """``models.cp.apply_continuous`` over 900,000 steps (an 1800-s record,
    normalized to [0, 1)): 14 K1f launches, and the kernel path within
    ENVELOPE_FACTOR times the plain f32 path's distance from float64."""
    from scgrhc_torch.models.cp import apply_continuous

    gen = Generator(4, torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(1, 4, T_RECORD, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = k1f.conv_in_relu.launches
    with torch.inference_mode():
        got = apply_continuous(gen, x)
        torch.cuda.synchronize()
        assert k1f.conv_in_relu.launches == before + 14
        plain = apply_continuous(gen, x, block=plain_block)
        ref = apply_continuous(gen.double(), x.double(), block=plain_block)
    assert got.shape == (1, 1, T_RECORD) and torch.isfinite(got).all()
    kernel_err = float((got - ref).abs().max())
    plain_err = float((plain - ref).abs().max())
    print(f"\ncontinuous forward at T={T_RECORD}: kernel path vs f64 {kernel_err:.3g}, plain "
          f"f32 vs f64 {plain_err:.3g}")
    assert kernel_err <= ENVELOPE_FACTOR * plain_err


@pytest.mark.parametrize("n,ci,t,o,pad", [(2, 4, 750, 64, 1), (3, 3, 750, 64, 1),
                                          (2, 512, 744, 256, 2), (1, 64, 5, 64, 1),
                                          (4, 512, 744, 512, 1), (1, 5, 3, 7, 2)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, n, ci, t, o, pad):
    """``models.quant.int8_conv`` (``torch._int_mm``, cuBLASLt on the card)
    equals the same product on the CPU in int32, bit for bit, at channel
    counts that are no multiple of 8 and at 16 rows or fewer too."""
    from scgrhc_torch.models.quant import int8_conv

    g = torch.Generator().manual_seed(n * ci + t)
    xq = torch.randint(-127, 128, (n, ci, t), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, ci, 3), generator=g, dtype=torch.int8)
    got = int8_conv(xq.to(cuda), wq.to(cuda), pad)
    assert got.dtype == torch.int32 and got.shape == (n, o, t + 2 * pad - 2)
    assert torch.equal(got.cpu(), int8_conv(xq, wq, pad))


def test_int8_generator_on_the_card(cuda):
    """The quantized generator on the card launches no K1f, and each
    window's output is correlated with the f32 forward's above 0.9 (uniform
    inputs, random weights, as tests/test_quant.py)."""
    gen = Generator(4, torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(8, 4, 750, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    q = gen.cast(torch.int8)
    before = k1f.conv_in_relu.launches
    with torch.inference_mode():
        yq = q(x)[:, 0].double().cpu().numpy()
        assert k1f.conv_in_relu.launches == before
        y = gen(x)[:, 0].double().cpu().numpy()
    assert np.isfinite(yq).all()
    assert min(np.corrcoef(a, b)[0, 1] for a, b in zip(y, yq)) > 0.9


# ---- the data axis on one card ------------------------------------------------

def _world_of_one(tmp_path, device):
    """A process group of one rank: NCCL for ``device`` None (one card per
    rank), gloo for ``cuda:0`` (ranks pinned to a card they may share)."""
    from scgrhc_torch.parallel import comm

    assert comm.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device=device)
    return comm


@pytest.mark.parametrize("device,backend", [(None, "nccl"), ("cuda:0", "gloo")])
def test_collectives_on_cuda_tensors(cuda, tmp_path, device, backend):
    """Every helper of ``parallel.comm`` on CUDA tensors: NCCL runs them on
    the card, gloo stages them through the host (the list form of
    ``all_gather``, ``broadcast_object_list``)."""
    comm = _world_of_one(tmp_path, device)
    try:
        assert torch.distributed.get_backend() == backend
        x = torch.arange(6.0, device=cuda)
        assert torch.equal(comm.all_reduce_sum(x.clone()), x)
        assert torch.equal(comm.all_reduce_max(x.clone()), x)
        assert torch.equal(comm.all_reduce_mean(x.clone()), x)
        assert torch.equal(comm.all_gather(x.clone()), x)
        assert torch.equal(comm.broadcast(x.clone()), x)
        assert comm.on_primary("x", lambda: 3) == 3
        with pytest.raises(OSError, match="disk full"):
            comm.on_primary("x", lambda: (_ for _ in ()).throw(OSError("disk full")))
        comm.barrier("test")
    finally:
        comm.destroy()


@pytest.mark.parametrize("b,n_critic,steps", [(4, 2, 2), (32, 5, 3)])
def test_dp_steps_over_nccl_equal_the_steps_with_no_group(cuda, tmp_path, b, n_critic, steps):
    """WGAN-GP steps through ``DataParallelTrainer`` in a world of one rank
    over NCCL (the gradient buckets all-reduced on the card) equal the same
    steps with no process group, bit for bit (weights, Adam state, losses),
    and launch the kernels that ``wgan.launches_per_step`` counts; at B 4
    and n_critic 2, and at ``chip_smoke.py``'s training configuration (B 32,
    n_critic 5)."""
    from scgrhc_torch.parallel.dp import DataParallelTrainer
    from scgrhc_torch.parallel.mesh import make_mesh

    cfg = wgan.TrainConfig(n_critic=n_critic)
    g = torch.Generator(cuda).manual_seed(3)
    scg, rhc = torch.rand(b, 4, 750, device=cuda, generator=g), torch.rand(b, 1, 750,
                                                                           device=cuda, generator=g)
    wrappers = {f.__name__: f for f in (k1f.conv_in_relu, k1f.conv_in_relu_bwd, k2.critic_layer,
                                        k2.critic_layer_bwd_dx, k2.critic_layer_bwd_dwdb,
                                        k2.critic_layer_bwd_dx_vjp)}

    def run(trainer):
        st = wgan.init_state(0, 4, cfg, cuda)
        if trainer is not None:
            trainer.place_state(st)
        before = {k: f.launches for k, f in wrappers.items()}
        out = []
        for i in range(steps):
            rng = wgan.step_rng(0, 0, i, cuda)
            d, gl = (wgan.train_step(st, scg, rhc, rng, cfg) if trainer is None
                     else trainer.step(st, scg, rhc, torch.arange(b, device=cuda), rng, cfg))
            out += [d, gl[None]]
        launches = {k: f.launches - before[k] for k, f in wrappers.items()}
        adam = [v for opt in (st.g_opt, st.d_opt) for s in opt.state.values()
                for v in s.values() if torch.is_tensor(v)]
        return [*st.generator.parameters(), *st.critic.parameters(), *adam, *out], launches

    plain, _ = run(None)
    comm = _world_of_one(tmp_path, None)
    try:
        dp, launches = run(DataParallelTrainer(make_mesh()))
    finally:
        comm.destroy()
    assert len(dp) == len(plain) and all(torch.equal(x, y) for x, y in zip(plain, dp))
    assert launches == {k: v * steps for k, v in wgan.launches_per_step(cfg).items()}


_BUILD_RANK = r"""
import sys, time
from pathlib import Path
import torch
from scgrhc_torch.ops.kernels import _build, conv_block
_build.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():  # both processes start their builds at once
    time.sleep(0.01)
b = _build.build()
g = torch.Generator("cuda").manual_seed(int(sys.argv[3]))
x = torch.rand(2, 4, 750, device="cuda", generator=g)
w = torch.rand(64, 4, 3, device="cuda", generator=g) - 0.5
bias = torch.rand(64, device="cuda", generator=g)
err = (conv_block.conv_in_relu(x, w, bias) - conv_block.conv_in_relu_plain(x, w, bias)).abs()
torch.cuda.synchronize()
print("BUILT", b.path.name, b.seconds > 0, conv_block.conv_in_relu.launches, float(err.max()))
"""


def test_two_ranks_build_the_kernels_at_once_on_one_card(cuda, tmp_path):
    """Two processes on the card that find no built library compile it at
    once into one build directory (``_build``: per-process temporary names,
    then one ``os.replace`` each), as two ranks of a first run do: both
    load a library and launch K1f, within FWD_TOL of its plain version, and
    one library is left with no temporary file."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RANK, str(tmp_path / "build"),
                               str(tmp_path / "go"), str(r)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    (tmp_path / "go").touch()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    names = set()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        _, name, built, launches, err = next(
            line for line in out.splitlines() if line.startswith("BUILT")).split()
        assert built == "True" and launches == "1" and float(err) <= FWD_TOL
        names.add(name)
    assert len(names) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(names)


# ---- the time axis on one card ------------------------------------------------

def _two_blocks(x):
    """The record x (N, C, 2k) as two ranks hold it: each block of k steps
    with its neighbour's edge column and a zero column at the record's end."""
    k = x.shape[-1] // 2
    z = torch.zeros_like(x[..., :1])
    return (torch.cat((z, x[..., :k], x[..., k:k + 1]), -1),
            torch.cat((x[..., k - 1:k], x[..., k:], z), -1))


@pytest.mark.parametrize("n,ci,o,k", [(1, 256, 512, 150_000), (1, 64, 128, 5_000),
                                      (2, 4, 64, 750), (3, 64, 8, 300), (1, 7, 5, 1)])
def test_conv_in_relu_time_sharded_phases(cuda, n, ci, o, k):
    """K1f's two phases over a record of 2k steps cut in two blocks (each
    with the other's edge column: non-zero halos), their sums added as the
    all-reduce adds them: each phase against its plain version, and the two
    blocks together against the whole-record layer, f32 within FWD_TOL; at
    150,000 steps a block (a 600-s record over two ranks) and below 8,192,
    at O = 8 (the streaming conv) and at one step a block; bf16 within
    BF16_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    bound = 1.0 / np.sqrt(ci * 3)
    x = torch.rand(n, ci, 2 * k, device=cuda, generator=gen)
    w = (torch.rand(o, ci, 3, device=cuda, generator=gen) * 2 - 1) * bound
    b = (torch.rand(o, device=cuda, generator=gen) * 2 - 1) * bound
    for dtype, tol in ((torch.float32, FWD_TOL), (torch.bfloat16, BF16_TOL)):
        xd, wd, bd = (a.to(dtype) for a in (x, w, b))
        before = (k1f.conv_in_relu_part.launches, k1f.conv_in_relu_apply.launches)
        parts = [k1f.conv_in_relu_part(xh, wd, bd) for xh in _two_blocks(xd)]
        plains = [k1f.conv_in_relu_part_plain(xh.float(), wd.float(), bd.float())
                  for xh in _two_blocks(xd)]
        for (c, sums), (pc, psums) in zip(parts, plains):
            assert c.dtype == sums.dtype == torch.float32 and c.shape == (n, o, k + 2)
            torch.testing.assert_close(c[..., 1:-1], pc[..., 1:-1], atol=tol, rtol=1e-2)
            scale = pc[..., 1:-1].abs().sum(-1).reshape(-1)
            assert float(((sums[:, 0] - psums[:, 0]).abs() / scale).max()) <= tol
        total = parts[0][1] + parts[1][1]
        got = torch.cat([k1f.conv_in_relu_apply(c, total, 2 * k, dtype) for c, _ in parts], -1)
        torch.cuda.synchronize()
        assert (k1f.conv_in_relu_part.launches, k1f.conv_in_relu_apply.launches) == (
            before[0] + 2, before[1] + 2)
        assert got.dtype == dtype and got.shape == (n, o, 2 * k)
        ptotal = plains[0][1] + plains[1][1]
        plain = torch.cat([k1f.conv_in_relu_apply_plain(pc, ptotal, 2 * k, torch.float32)
                           for pc, _ in plains], -1)
        whole = k1f.conv_in_relu_plain(xd.float(), wd.float(), bd.float())
        torch.testing.assert_close(plain, whole, atol=FWD_TOL, rtol=0)
        torch.testing.assert_close(got.float(), plain, atol=tol, rtol=1e-2 if tol > FWD_TOL
                                   else 0)


def test_conv_in_relu_time_sharded_phases_propagate_nan(cuda):
    """A NaN in one block makes its sample's rows NaN on both blocks (the
    summed statistics), and leaves the other sample finite."""
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 1000))
    x[1, 2, 100] = float("nan")
    parts = [k1f.conv_in_relu_part(xh, w, b) for xh in _two_blocks(x)]
    total = parts[0][1] + parts[1][1]
    got = [k1f.conv_in_relu_apply(c, total, 1000, x.dtype) for c, _ in parts]
    for y in got:
        assert torch.isnan(y[1]).all() and not torch.isnan(y[0]).any()


def test_one_block_of_the_phases_equals_the_one_launch_layer(cuda):
    """At one block (zero halos, count = its length), the two phases are the
    one-launch layer's row pieces: equal bit for bit past 8,192 steps."""
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(1, 64, 128, 20_000))
    c, sums = k1f.conv_in_relu_part(torch.nn.functional.pad(x, (1, 1)), w, b)
    assert torch.equal(k1f.conv_in_relu_apply(c, sums, 20_000, x.dtype),
                       k1f.conv_in_relu(x, w, b))


def test_conv_in_relu_time_sharded_phases_reject(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(1, 4, 64, 100))
    with pytest.raises(ValueError, match="block"):
        k1f.conv_in_relu_part(x[..., :2].contiguous(), w, b)
    c, sums = k1f.conv_in_relu_part(x, w, b)
    with pytest.raises(ValueError, match="count"):
        k1f.conv_in_relu_apply(c, sums, 97, x.dtype)
    with pytest.raises(ValueError):
        k1f.conv_in_relu_apply(c, sums[:10].contiguous(), 98, x.dtype)


@pytest.mark.parametrize("length", [30_000, 300_000])
def test_apply_cp_over_nccl_world_one_equals_apply_continuous(cuda, tmp_path, length):
    """``models.cp.apply_cp`` in a world of one rank over NCCL (its 43
    all-reduces and gathers on the card) equals ``apply_continuous`` bit for
    bit, with 14 launches of each K1f phase, on a 30,000-step record and on
    a 600-s one (300,000 steps at 500 Hz)."""
    from scgrhc_torch.models.cp import apply_continuous, apply_cp
    from scgrhc_torch.parallel.mesh import TIME_AXIS, make_mesh

    gen = Generator(4, torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(4, length, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    comm = _world_of_one(tmp_path, None)
    try:
        before = (k1f.conv_in_relu_part.launches, k1f.conv_in_relu_apply.launches)
        with torch.inference_mode():
            got = apply_cp(gen, x, make_mesh(axis=TIME_AXIS))
            want = apply_continuous(gen, x[None])
        torch.cuda.synchronize()
        assert (k1f.conv_in_relu_part.launches, k1f.conv_in_relu_apply.launches) == (
            before[0] + 14, before[1] + 14)
    finally:
        comm.destroy()
    assert got.shape == (1, 1, length) and torch.equal(got, want)


def test_orbax_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A state on the card with Adam moments, saved as an Orbax directory
    (in the background, then waited for) and loaded back onto the card:
    every weight and moment equal bit for bit."""
    from scgrhc_torch.train import orbax_io

    cfg = wgan.TrainConfig(n_critic=1)
    st = wgan.init_state(5, 4, cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    wgan.train_step(st, torch.rand(2, 4, 750, generator=g, device=cuda),
                    torch.rand(2, 1, 750, generator=g, device=cuda),
                    torch.Generator(device=cuda).manual_seed(1), cfg)
    path = str(tmp_path / "000.checkpoint")
    orbax_io.save(path, start_time=1.0, epoch=0, g_losses=[0.5], d_losses=[0.25], state=st,
                  block=False)
    orbax_io.wait()
    ckpt, back = orbax_io.load(path + orbax_io.ORBAX_SUFFIX, cfg, 4, cuda)
    assert ckpt["epoch"] == 0 and ckpt["g_losses"] == [0.5]
    for a, b in ((st.generator, back.generator), (st.critic, back.critic)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert w.device.type == "cuda" and torch.equal(v, w), k
    for a, b in ((st.g_opt, back.g_opt), (st.d_opt, back.d_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            assert float(sa[i]["step"]) == float(sb[i]["step"]) == 1.0
            for k in ("exp_avg", "exp_avg_sq"):
                assert sb[i][k].device.type == "cuda" and torch.equal(sa[i][k], sb[i][k])


def test_step_phases_timed_on_the_card(cuda):
    """Three steps at B 64, T 750 under a profiler with CUDA activity: every
    phase span of the step records device time, the GP's second order lies
    inside the critic's gradient, and the top-level phases cover 95-101 % of
    ``train_step``'s device time (the rest: the batch gather and the
    losses' stacking)."""
    from scgrhc_torch.core import trace
    from scgrhc_torch.parallel.dp import DataParallelTrainer
    from scgrhc_torch.parallel.mesh import make_mesh

    cfg = wgan.TrainConfig(n_critic=2)
    st = wgan.init_state(0, 3, cfg, cuda)
    g = torch.Generator(cuda).manual_seed(4)
    scg, rhc = (torch.rand(128, 3, 750, device=cuda, generator=g),
                torch.rand(128, 1, 750, device=cuda, generator=g))
    trainer = DataParallelTrainer(make_mesh())

    def step(i):
        idx = torch.arange(64 * (i % 2), 64 * (i % 2 + 1), device=cuda)
        trainer.step(st, scg, rhc, idx, wgan.step_rng(0, 0, i, cuda), cfg)

    step(0)  # loads the kernels and warms cuDNN
    torch.cuda.synchronize()
    trace.reset_phases()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for i in range(1, 4):
            step(i)
        torch.cuda.synchronize()
    tot = trace.phase_totals()
    trace.reset_phases()
    top = ("critic_loss", "critic_grad", "adam", "generator_loss", "generator_grad")
    for name in ("train_step", "gp_second_order", *top):
        assert tot[name]["device_ms"] > 0, (name, tot)
    assert tot["train_step"]["calls"] == 3 and tot["adam"]["calls"] == 9
    assert tot["gp_second_order"]["device_ms"] <= tot["critic_grad"]["device_ms"]
    share = sum(tot[n]["device_ms"] for n in top) / tot["train_step"]["device_ms"]
    print({k: round(v["device_ms"] / 3, 3) for k, v in tot.items()}, f"share {share:.4f}")
    assert 0.95 <= share <= 1.01, tot


def test_train_step_dw_launches_by_path(cuda):
    """One f32 WGAN-GP step at B 64, T 750 with 3 SCG channels (train.w06's
    shapes), n_critic 2: every dw launch from 16 output channels takes the
    warpgroup MMA (``conv3.dw_path_launches``) and the score layer streams
    (K2dw twice and its vjp's dw once per update).  The warpgroup MMA
    copies its rows by tensor maps but at the generator's first layer,
    whose 3 input channels give no row pairs (``conv3.dw_copy_launches``)."""
    from scgrhc_torch.ops.kernels import conv3
    from scgrhc_torch.parallel.dp import DataParallelTrainer
    from scgrhc_torch.parallel.mesh import make_mesh

    cfg = wgan.TrainConfig(n_critic=2)
    st = wgan.init_state(0, 3, cfg, cuda)
    g = torch.Generator(cuda).manual_seed(5)
    scg, rhc = (torch.rand(64, 3, 750, device=cuda, generator=g),
                torch.rand(64, 1, 750, device=cuda, generator=g))
    trainer = DataParallelTrainer(make_mesh())
    idx = torch.arange(64, device=cuda)
    _, paths, copies = _dw_counts(
        lambda: trainer.step(st, scg, rhc, idx, wgan.step_rng(0, 0, 0, cuda), cfg))
    n = cfg.n_critic
    assert paths == {"wgmma": 14 + 19 * n, "stream": 3 * n}
    assert copies == {"tma": 13 + 19 * n, "cp.async": 1}


# One WGAN-GP step on the card against the same step on the CPU (same
# weights, masks, eps).  Gradients, as Adam's first moments after one step,
# by relative L2: a gradient of the wrong sign reads 2, a zero one 1.  The
# f32 envelope is set by the relu masks: where an x̂ sits within rounding of
# 0, its mask can flip on one device and not on the other, and the critic's
# input gradient, small beside its terms, moves by a few 1e-3 per flip
# (readings 3.6e-3 for G, 4.1e-3 for D on an H100; the CPU's f32 step
# against its f64 step, printed beside, reads 1.7e-3 for G and flipped no
# critic mask).
TOL_STEP_MOMENTS = 1e-2
# The first critic loss is a forward value; the gradient penalty in it
# moves with the same mask flips (reading 3.8e-4).
TOL_STEP_LOSS0 = 2e-3  # relative
# The losses after the first critic update: Adam's first steps move every
# weight by about alpha, whatever the size of its gradient, so a gradient
# within rounding of 0 moves a weight the other way on the other device
# (reading 5.6e-3).  The same step with the critic's updates reversed is
# read beside it (0.49) and must fall outside.
TOL_STEP_LOSSES = 2e-2  # relative
# The critic's biases that feed an instance norm (its in_relu layers).
D_IN_BIASES = frozenset(f"d.model.{i}.bias" for i in (2, 5, 8))


def _pinned_step(dev, dtype, inputs, n_critic: int, reverse_critic: bool = False):
    """One WGAN-GP step from seed-7 weights on ``dev`` in ``dtype``, the
    dropout masks and eps pinned through the step's seams.
    ``reverse_critic`` applies each critic update against its gradient: a
    wrong update, to read what the checks must catch.  Returns the losses
    and the Adam first moments by parameter name (the critic's prefixed
    ``d.``)."""
    from scgrhc_torch.models import generator as gen_mod

    scg, rhc, eps = inputs
    cfg = wgan.TrainConfig(n_critic=n_critic, alpha=1e-4)
    draws = {"mask": 0, "eps": 0}

    def dropout(x, rate, rng_, train):
        draws["mask"] += 1
        m = np.random.default_rng(1000 + draws["mask"]).random(tuple(x.shape)) < 1.0 - rate
        return x * torch.from_numpy(m).to(x) / (1.0 - rate)

    def draw_eps(rng_, n, device):
        draws["eps"] += 1
        return torch.from_numpy(eps[draws["eps"] - 1]).to(device)

    state = wgan.init_state(7, scg.shape[1], cfg, dev)
    state.generator.to(dtype)
    state.critic.to(dtype)

    def apply(opt, params, loss, grad_span, reduce=None):
        sign = -1.0 if reverse_critic and opt is state.d_opt else 1.0
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = sign * g
        opt.step()
        return loss.detach()

    seams = (gen_mod.dropout, wgan._draw_eps, wgan._apply)
    gen_mod.dropout, wgan._draw_eps, wgan._apply = dropout, draw_eps, apply
    try:
        d, g = wgan.train_step(state, torch.from_numpy(scg).to(dev, dtype),
                               torch.from_numpy(rhc).to(dev, dtype), None, cfg)
        losses = np.append(d.cpu().double().numpy(), float(g))
    finally:
        gen_mod.dropout, wgan._draw_eps, wgan._apply = seams
    moments = {}
    for prefix, module, opt in (("", state.generator, state.g_opt),
                                ("d.", state.critic, state.d_opt)):
        for name, p in module.named_parameters():
            moments[prefix + name] = opt.state[p]["exp_avg"].detach().cpu().double().numpy()
    return losses, moments


def _moments_rel(a: dict, b: dict, critic: bool) -> float:
    """Relative L2 distance of one model's first moments, the biases that
    feed an instance norm left out."""
    keys = [k for k in b if k.startswith("d.") == critic
            and k not in G_IN_BIASES | D_IN_BIASES]
    x, y = (np.concatenate([m[k].ravel() for k in keys]) for m in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def test_train_step_at_n_critic_5_against_the_cpu(cuda):
    """The WGAN-GP step at full width (B 4, 4 SCG channels, T 750) on the
    card against the same step on the CPU, same weights, dropout masks and
    eps: the gradients, as Adam's first moments after a step with n_critic
    1 (the float64 CPU step printed beside for the f32 envelope), and the
    losses of a whole step at n_critic 5, and beside them the same step on
    the CPU with the critic's updates reversed, which must fall outside."""
    n_critic = 5
    rng = np.random.default_rng(11)
    b = 4
    scg = rng.random((b, 4, 750)).astype(np.float32)
    rhc = rng.random((b, 1, 750)).astype(np.float32)
    eps = [rng.random((b, 1, 1)).astype(np.float32) for _ in range(n_critic)]
    inputs = (scg, rhc, eps)
    f32, f64 = torch.float32, torch.float64

    _, m_card = _pinned_step(cuda, f32, inputs, 1)
    _, m_cpu = _pinned_step("cpu", f32, inputs, 1)
    _, m_64 = _pinned_step("cpu", f64, inputs, 1)
    mom = {f"{who}_{mod}": _moments_rel(x, y, mod == "d")
           for who, (x, y) in (("card_vs_cpu", (m_card, m_cpu)), ("card_vs_f64", (m_card, m_64)),
                               ("cpu_vs_f64", (m_cpu, m_64)))
           for mod in ("g", "d")}
    l_card, _ = _pinned_step(cuda, f32, inputs, n_critic)
    l_cpu, _ = _pinned_step("cpu", f32, inputs, n_critic)
    l_rev, _ = _pinned_step("cpu", f32, inputs, n_critic, reverse_critic=True)
    rel = np.abs(l_card - l_cpu) / np.abs(l_cpu)
    rel_rev = np.abs(l_rev - l_cpu) / np.abs(l_cpu)
    # the critic losses after the first update (the generator's loss, last,
    # is taken before its own update and moves little with the critic's)
    later, later_rev = float(rel[1:n_critic].max()), float(rel_rev[1:n_critic].max())
    print(f"first moments, relative L2: {mom}; losses card vs cpu {rel.tolist()}, the "
          f"critic's updates reversed {rel_rev.tolist()}")
    for mod in ("g", "d"):
        assert mom[f"card_vs_cpu_{mod}"] <= TOL_STEP_MOMENTS, mom
    assert rel[0] <= TOL_STEP_LOSS0, rel
    assert max(later, rel[-1]) <= TOL_STEP_LOSSES, rel
    assert later_rev > TOL_STEP_LOSSES, rel_rev
