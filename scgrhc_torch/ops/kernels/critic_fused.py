"""K2f, K2dx and K2dw: the critic's conv1d(k=3, p=1) + bias layer in the
modes ``relu``, ``in_relu`` and ``linear``, and the three nested autograd
Functions that make it twice differentiable for the gradient penalty.

Replaces the TPU kernels of ``scgrhc/ops/pallas/critic_fused.py``: K2f its
``_fwd_kernel``, K2dx its ``_bwd_dx_kernel``, K2dw its
``_bwd_dwdb_kernel``.  The CUDA source is ``scgrhc_torch/csrc/
critic_layer.cu`` over ``conv3.cuh``.  The TPU kernels' flat, 128-column
padded layout was Mosaic's constraint; the port keeps (N, C, T), and its
values and gradients equal ``critic.apply_fused`` followed by
``from_flat`` on every real column.

The wiring mirrors ``_make_layer`` (``critic_fused.py:318-396``):

  * :class:`Layer`: forward K2f; backward :class:`BwdDx` for the input and
    :class:`BwdDwDb` for the weights.
  * :class:`BwdDx`, :class:`BwdDwDb`: forward K2dx, K2dw; their own
    backward (the second order that the gradient penalty's parameter
    gradient reaches) is the vjp of the plain versions, by
    ``torch.autograd.grad`` — plain PyTorch, as the JAX package runs its
    reference vjp under XLA.

The gradient penalty's input gradient calls :func:`fused_layer_bwd_dx`
(:class:`BwdDx`) layer by layer from the top (``Critic.forward`` with
``ct``), so it launches K2dx only, as XLA drops the JAX package's
``bwd_dwdb`` there as dead code.  On the CPU all three Functions run the
plain versions, so the CPU tests exercise the nested wiring itself.
"""

from __future__ import annotations

import torch

from scgrhc_torch.core.trace import annotate
from scgrhc_torch.ops.kernels import conv3

MODES = conv3.MODES


def critic_layer_plain(x, w, b, mode: str):
    """The plain forward, cast to x's dtype."""
    return conv3.layer_plain(x, w, b, mode)


def critic_layer_bwd_dx_plain(x, w, b, dy, mode: str):
    """The plain input gradient at ``dy``, in x's dtype."""
    return conv3.layer_bwd_plain(x, w, b, dy, mode, need_dw=False)[0]


def critic_layer_bwd_dwdb_plain(x, w, b, dy, mode: str):
    """The plain ``(dw, db)`` at ``dy``, in f32, summed over samples."""
    return conv3.layer_bwd_plain(x, w, b, dy, mode, need_dx=False)[1:]


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def critic_layer(x, w, b, mode: str):
    """K2f: x (N, C, T), w (O, C, 3), b (O,) → (N, O, T) in x's dtype.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    _check_mode(mode)
    if conv3.on_cpu(x, "critic_layer"):
        return critic_layer_plain(x, w, b, mode)
    y = conv3.launch_fwd("scgrhc_critic_layer_fwd", "critic_layer", x, w, b, mode)
    critic_layer.launches += 1
    return y


def critic_layer_bwd_dx(x, w, b, dy, mode: str):
    """K2dx: the input gradient (N, C, T) in x's dtype."""
    _check_mode(mode)
    if conv3.on_cpu(x, "critic_layer_bwd_dx"):
        return critic_layer_bwd_dx_plain(x, w, b, dy, mode)
    dx, _, _ = conv3.launch_bwd("scgrhc_critic_layer_bwd", "critic_layer_bwd_dx", x, w, b,
                                dy, mode, True, False)
    critic_layer_bwd_dx.launches += 1
    return dx


def critic_layer_bwd_dwdb(x, w, b, dy, mode: str):
    """K2dw: ``(dw (O, C, 3), db (O,))`` in f32."""
    _check_mode(mode)
    if conv3.on_cpu(x, "critic_layer_bwd_dwdb"):
        return critic_layer_bwd_dwdb_plain(x, w, b, dy, mode)
    _, dw, db = conv3.launch_bwd("scgrhc_critic_layer_bwd", "critic_layer_bwd_dwdb", x, w,
                                 b, dy, mode, False, True)
    critic_layer_bwd_dwdb.launches += 1
    return dw, db


critic_layer.launches = 0
critic_layer_bwd_dx.launches = 0
critic_layer_bwd_dwdb.launches = 0


def _plain_vjp(ctx, plain, cts):
    """Gradients of ``plain(x, w, b, dy, mode)`` for the inputs that need
    one, at the output cotangents ``cts``: the GP's second order, under the
    span ``gp_second_order``."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:4]
    with annotate("gp_second_order"), torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*ins, ctx.mode)
        out = out if isinstance(out, tuple) else (out,)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, cts, allow_unused=True))
    return tuple(next(grads) if n else None for n in need) + (None,)


class BwdDx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dy, mode):
        ctx.save_for_backward(x, w, b, dy)
        ctx.mode = mode
        return critic_layer_bwd_dx(x, w, b, dy, mode)

    @staticmethod
    def backward(ctx, ct):
        return _plain_vjp(ctx, critic_layer_bwd_dx_plain, (ct,))


class BwdDwDb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dy, mode):
        ctx.save_for_backward(x, w, b, dy)
        ctx.mode = mode
        return critic_layer_bwd_dwdb(x, w, b, dy, mode)

    @staticmethod
    def backward(ctx, ct_dw, ct_db):
        return _plain_vjp(ctx, critic_layer_bwd_dwdb_plain, (ct_dw, ct_db))


class Layer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mode):
        ctx.save_for_backward(x, w, b)
        ctx.mode = mode
        return critic_layer(x, w, b, mode)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = BwdDx.apply(x, w, b, dy, ctx.mode)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = BwdDwDb.apply(x, w, b, dy, ctx.mode)
            dw, db = dw.to(w.dtype), db.to(b.dtype)
        return dx, dw, db, None


def fused_layer(x, w, b, mode: str):
    """One critic layer, twice differentiable: x (N, C, T) → (N, O, T)."""
    _check_mode(mode)
    return Layer.apply(x, w, b, mode)


def fused_layer_bwd_dx(x, w, b, dy, mode: str):
    """The layer's input gradient at ``dy``, twice differentiable: K2dx,
    whose own backward is the plain version's vjp."""
    _check_mode(mode)
    return BwdDx.apply(x, w, b, dy.contiguous(), mode)
