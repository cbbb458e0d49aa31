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
f32 operations).

The backward kernels (K1b, K2dx, K2dw) and the critic's forward (K2f) are
held by the relative L2 error ``|got - want| / |want|``: 1e-4 for forward
outputs in f32; 1e-3 for backward outputs in f32, where a relu mask can
flip at an x̂ within f32 rounding of 0 and move one dc element by
rsig·dy; 3e-2 in bf16 (bf16 inputs, dc rounded to bf16 for dx and dw, and
more mask flips).  The bias gradient of an ``in_relu`` layer is held to
the scale of its sum, ``|Σ|dc||``: after an instance norm it is zero up to
rounding.  In ``relu`` and ``linear`` modes it is held by its own norm.
"""

import numpy as np
import pytest
import torch

from scgrhc_torch.models.critic import Critic
from scgrhc_torch.models.generator import Generator, plain_block
from scgrhc_torch.ops.kernels import conv_block as k1f
from scgrhc_torch.ops.kernels import critic_fused as k2
from scgrhc_torch.ops.kernels import dsp as k4
from scgrhc_torch.train import wgan

FWD_TOL, BWD_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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


@pytest.mark.parametrize(
    "ci,o,t", [(4, 64, 750), (2, 64, 96), (64, 128, 748), (512, 512, 744),
               (256, 128, 747), (100, 24, 1024), (7, 5, 1)]
)
def test_conv_in_relu_kernel_f32(cuda, ci, o, t):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(3, ci, o, t))
    before = k1f.conv_in_relu.launches
    got = k1f.conv_in_relu(x, w, b)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu.launches == before + 1
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
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 750))
    with pytest.raises(TypeError):
        k1f.conv_in_relu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        k1f.conv_in_relu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        k1f.conv_in_relu(torch.zeros(1, 4, 1025, device=cuda), w, b)


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
    "ci,o,t,need_dx", [(4, 64, 750, False), (64, 128, 748, True), (512, 512, 744, True),
                       (256, 128, 747, True), (7, 5, 1, True), (100, 24, 1024, True)]
)
def test_conv_in_relu_bwd_kernel_f32(cuda, ci, o, t, need_dx):
    x, w, b, dy = _bwd_inputs(cuda, 3, ci, o, t)
    before = k1f.conv_in_relu_bwd.launches
    got = k1f.conv_in_relu_bwd(x, w, b, dy, need_dx)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu_bwd.launches == before + 1
    want = k1f.conv_in_relu_bwd_plain(x, w, b, dy, need_dx)
    assert (got[0] is None) == (not need_dx)
    floors = (1e-30, 1e-30, _db_scale(x, w, b, dy, "in_relu"))
    for g, r, floor in zip(got, want, floors):
        if r is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
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


def test_generator_backward_reaches_every_parameter(cuda):
    """Through ConvInReLU (K1f forward, K1b backward) every generator
    parameter gets a finite gradient on the card, nonzero for every weight
    and for every bias not followed by an instance norm (those are zero up
    to rounding), and the gradients match the plain block's."""
    gen = Generator(4, torch.Generator().manual_seed(5)).to(cuda)
    x = torch.rand(4, 4, 750, generator=torch.Generator().manual_seed(6)).to(cuda)
    before = k1f.conv_in_relu_bwd.launches
    rng = torch.Generator(device=cuda).manual_seed(0)
    gen(x, rng=rng, train=True).square().mean().backward()
    torch.cuda.synchronize()
    assert k1f.conv_in_relu_bwd.launches == before + 14
    normed = {f"{blk}.{i}.bias" for blk in ("enc1", "enc2", "enc3", "bottleneck", "dec3",
                                            "dec2", "dec1") for i in (0, 3)}
    normed |= {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g",
                                                                            "psi")}
    for name, p in gen.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name not in normed:
            assert p.grad.abs().max() > 0, name
    # the same backward through the plain block
    names = [n for n, _ in gen.named_parameters()]
    got = [p.grad.clone() for p in gen.parameters()]
    gen.zero_grad()
    gen(x, block=plain_block, rng=torch.Generator(device=cuda).manual_seed(0),
        train=True).square().mean().backward()
    _grads_close(got, [p.grad for p in gen.parameters()], names)


def test_critic_gradient_penalty_matches_float64_plain(cuda):
    """The GP and its parameter gradient (second order through BwdDx) on the
    kernels, in f32, against the same critic through the plain versions in
    float64 on the card.  (The f32 plain path itself sits about 2e-3 from
    float64 here, so it is no reference at BWD_TOL.)"""
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
    def plain(x, **kw):
        return c64(x, layer=k2.critic_layer_plain, **kw)

    gp_p, grads_p = gp_and_grads(c64, plain, *(v.double() for v in (scg, rhc, pred, eps)))
    assert abs(gp_k - gp_p) <= FWD_TOL * abs(gp_p)
    _grads_close(grads_k, grads_p, [n for n, _ in critic.named_parameters()])
