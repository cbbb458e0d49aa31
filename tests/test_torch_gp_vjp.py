"""The closed-form vjp of K2dx (``critic_fused.critic_layer_bwd_dx_vjp``,
``BwdDx``'s backward: the gradient penalty's second order) against
``_plain_vjp``, the vjp of the plain input gradient by
``torch.autograd.grad``, on the CPU, where both run plain products.

  * All three modes, float64 to 1e-10 relative and float32 to
    ``tests/test_torch_critic.py``'s envelope (GRAD_ATOL absolute), at N = 3,
    an odd T and C ≠ O, with a row whose dy is 0 and an output channel whose
    c is negative throughout.
  * Only the inputs that need a gradient get one (the penalty's first layer:
    x needs none), and None where the gradient is zero.
  * bf16 keeps ``_plain_vjp``, bit for bit; the row pass alone
    (``dx_vjp_row_plain``) against autograd through ``conv3.dc_from_dy``,
    with constant rows whose variance lands on 0 and below it (the clamp).
"""

import types

import pytest
import torch

from scgrhc_torch.ops.kernels import conv3
from scgrhc_torch.ops.kernels import critic_fused as k2

N, C, O, T = 3, 4, 5, 11
F64_RTOL = 1e-10
GRAD_ATOL = 2e-4  # tests/test_torch_critic.py: f32 gradients against the Pallas kernels


def _inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, C, T, generator=g, dtype=torch.float64)
    w = torch.randn(O, C, 3, generator=g, dtype=torch.float64) * 0.5
    b = torch.randn(O, generator=g, dtype=torch.float64)
    dy = torch.randn(N, O, T, generator=g, dtype=torch.float64)
    u = torch.randn(N, C, T, generator=g, dtype=torch.float64)
    dy[1, 2] = 0.0  # a row whose cotangent is 0
    b[3] = -50.0  # c < 0 on every step of channel 3
    return [t.to(dtype) for t in (x, w, b, dy, u)]


def _closed_form(x, w, b, dy, u, mode, need):
    """BwdDx's backward, reached through autograd from K2dx's output."""
    ins = [t.clone().requires_grad_(n) for t, n in zip((x, w, b, dy), need)]
    dx = k2.fused_layer_bwd_dx(*ins, mode)
    wanted = [t for t, n in zip(ins, need) if n]
    grads = iter(torch.autograd.grad(dx, wanted, u, allow_unused=True))
    return [next(grads) if n else None for n in need]


def _plain(x, w, b, dy, u, mode, need):
    ctx = types.SimpleNamespace(saved_tensors=(x, w, b, dy), needs_input_grad=tuple(need),
                                mode=mode)
    return list(k2._plain_vjp(ctx, k2.critic_layer_bwd_dx_plain, (u,))[:4])


def _db_floor(x, w, b, dy, u, mode) -> float:
    """|Σ_{n,t} |d_c||: the scale an in_relu bias gradient sums to zero from
    (Σ_t d_c = 0 on every row)."""
    if mode != "in_relu":
        return 0.0
    c, _, stats = k2._kept_plain(x, w, b, dy, mode)
    v = torch.nn.functional.conv1d(u, w, padding=1)
    return float(k2.dx_vjp_row_plain(c, stats, dy, v, mode)[1].abs().sum(dim=(0, 2)).norm())


def _hold(got, want, dtype, floors):
    for i, (g, r, floor) in enumerate(zip(got, want, floors)):
        assert (g is None) == (r is None), i
        if g is None:
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, i
        if dtype == torch.float64:
            err = float((g - r).norm())
            assert err <= F64_RTOL * max(float(r.norm()), floor), (i, err, float(r.norm()))
        else:
            torch.testing.assert_close(g, r, atol=GRAD_ATOL, rtol=0, msg=str(i))


@pytest.mark.parametrize("need", [(True,) * 4, (False, True, True, True)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", k2.MODES)
def test_closed_form_matches_plain_vjp(mode, dtype, need):
    x, w, b, dy, u = _inputs(dtype)
    got = _closed_form(x, w, b, dy, u, mode, need)
    want = _plain(x, w, b, dy, u, mode, need)
    # x and b reach dx through flat relu masks only outside in_relu
    assert (got[0] is None, got[2] is None) == (not (need[0] and mode == "in_relu"),
                                                mode != "in_relu")
    floor = _db_floor(*(t.double() for t in (x, w, b, dy, u)), mode)
    _hold(got, want, dtype, (0.0, 0.0, floor, 0.0))


@pytest.mark.parametrize("mode", k2.MODES)
def test_closed_form_on_other_seeds_and_lengths(mode):
    """f64 at T = 1 and 2 (rows of one and two steps) and at a longer odd
    T, on fresh draws."""
    for seed, t in ((1, 1), (2, 2), (3, 37)):
        g = torch.Generator().manual_seed(seed)
        x, dy, u = (torch.randn(2, c, t, generator=g, dtype=torch.float64) for c in (3, 6, 3))
        w = torch.randn(6, 3, 3, generator=g, dtype=torch.float64)
        b = torch.randn(6, generator=g, dtype=torch.float64)
        need = (True,) * 4
        got = _closed_form(x, w, b, dy, u, mode, need)
        want = _plain(x, w, b, dy, u, mode, need)
        _hold(got, want, torch.float64, (0.0, 0.0, _db_floor(x, w, b, dy, u, mode), 0.0))


@pytest.mark.parametrize("mode", k2.MODES)
def test_bf16_keeps_the_plain_vjp(mode):
    x, w, b, dy, u = _inputs(torch.bfloat16)
    need = (True,) * 4
    got = _closed_form(x, w, b, dy, u, mode, need)
    want = _plain(x, w, b, dy, u, mode, need)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if g is not None:
            assert torch.equal(g, r)


@pytest.mark.parametrize("mode", ["relu", "in_relu"])
def test_row_pass_matches_autograd_through_dc_from_dy(mode):
    """dx_vjp_row_plain's (d_dy, d_c) are the vjp of conv3.dc_from_dy at v,
    with the row statistics that K2dx's dc pass keeps."""
    g = torch.Generator().manual_seed(4)
    c, dy, v = (torch.randn(2, 3, 11, generator=g, dtype=torch.float64) for _ in range(3))
    c[0, 2] = 0.25  # a constant row, E[c²] − mean² = 0 exactly
    c[1, 2] = -0.3  # a constant row whose E[c²] − mean² rounds below 0
    dy[0, 1] = 0.0
    cg, dyg = c.clone().requires_grad_(), dy.clone().requires_grad_()
    want_c, want_dy = torch.autograd.grad(conv3.dc_from_dy(dyg, cg, mode), (cg, dyg), v,
                                          allow_unused=True)
    stats = k2.row_stats_plain(c)
    assert stats[0, 2, 1] == 0 and stats[1, 2, 1] < 0
    d_dy, d_c = k2.dx_vjp_row_plain(c, stats, dy, v, mode)
    torch.testing.assert_close(d_dy, want_dy, rtol=F64_RTOL, atol=1e-13)
    if mode == "relu":
        assert d_c is None and want_c is None
    else:
        torch.testing.assert_close(d_c, want_c, rtol=F64_RTOL, atol=1e-13)
        torch.testing.assert_close(d_c.sum(dim=-1), torch.zeros(2, 3, dtype=torch.float64),
                                   rtol=0, atol=1e-12)


def test_one_second_order_span_per_node():
    """The closed form opens ``gp_second_order`` once per BwdDx node, on the
    CPU as on the card (the span ``gp_second_order_ms.train`` reads)."""
    from torch.profiler import ProfilerActivity, profile

    from scgrhc_torch.core import trace

    x, w, b, dy, u = _inputs(torch.float32)
    ins = [t.clone().requires_grad_() for t in (w, b, dy)]
    dx = k2.fused_layer_bwd_dx(x, *ins, "in_relu")
    dx2 = k2.fused_layer_bwd_dx(x, ins[0], ins[1], 2 * ins[2], "relu")
    trace.reset_phases()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.autograd.grad(((dx + dx2) * u).sum(), ins)
    assert trace.phase_totals()["gp_second_order"]["calls"] == 2
    trace.reset_phases()
