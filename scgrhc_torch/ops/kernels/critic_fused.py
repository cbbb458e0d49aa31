"""K2f, K2dx and K2dw: the critic's conv1d(k=3, p=1) + bias layer in the
modes ``relu``, ``in_relu`` and ``linear``, and the three nested autograd
Functions that make it twice differentiable for the gradient penalty.

Replaces the TPU kernels of ``scgrhc/ops/pallas/critic_fused.py``: K2f its
``_fwd_kernel``, K2dx its ``_bwd_dx_kernel``, K2dw its
``_bwd_dwdb_kernel``.  The CUDA source is the layer's,
``scgrhc_torch/csrc/conv_layer.cu`` over ``conv3.cuh``, launched through
:func:`.conv3.launch_fwd` and :func:`.conv3.launch_bwd` as the
generator's layer is.  The TPU kernels' flat, 128-column
padded layout was Mosaic's constraint; the port keeps (N, C, T), and its
values and gradients equal ``critic.apply_fused`` followed by
``from_flat`` on every real column.

The wiring mirrors ``_make_layer`` (``critic_fused.py:318-396``):

  * :class:`Layer`: forward K2f; backward :class:`BwdDx` for the input and
    :class:`BwdDwDb` for the weights.
  * :class:`BwdDx`: forward K2dx; its backward, the second order that the
    gradient penalty's parameter gradient reaches, is K2dx's vjp in closed
    form (:func:`critic_layer_bwd_dx_vjp`), on the conv core's launchers
    over the c and row statistics that K2dx's own dc pass kept, so it
    differentiates the masks K2dx applied.  bf16 takes the vjp of the
    plain version by ``torch.autograd.grad`` (:func:`_plain_vjp`).
  * :class:`BwdDwDb`: forward K2dw; its backward, which no training step
    reaches, is the plain version's vjp.

The gradient penalty's input gradient calls :func:`fused_layer_bwd_dx`
(:class:`BwdDx`) layer by layer from the top (``Critic.forward`` with
``ct``), so it launches K2dx only, as XLA drops the JAX package's
``bwd_dwdb`` there as dead code.  On the CPU all three Functions run the
plain versions, and BwdDx's backward the same closed form over plain
products, so the CPU tests exercise the nested wiring itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from scgrhc_torch.core.trace import annotate
from scgrhc_torch.ops.kernels import _build, conv3
from scgrhc_torch.ops.nn import IN_EPS, stats_dtype

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
    y = conv3.launch_fwd("critic_layer", x, w, b, mode)
    critic_layer.launches += 1
    return y


def critic_layer_bwd_dx(x, w, b, dy, mode: str, keep: bool = False):
    """K2dx: the input gradient (N, C, T) in x's dtype.  ``keep``: the pair
    (dx, kept), kept what :func:`critic_layer_bwd_dx_vjp` reads of this
    launch: (c, dc) in the relu mode and (c, dc, stats) in the in_relu
    mode for float32 on the card (``conv3.launch_bwd``), else () (the CPU
    recomputes them; the linear mode needs none; bf16 takes
    :func:`_plain_vjp`)."""
    _check_mode(mode)
    if conv3.on_cpu(x, "critic_layer_bwd_dx"):
        dx = critic_layer_bwd_dx_plain(x, w, b, dy, mode)
        return (dx, ()) if keep else dx
    keep_c = keep and mode != "linear" and x.dtype == torch.float32
    dx, _, _, *kept = conv3.launch_bwd("critic_layer_bwd_dx", x, w, b, dy, mode, True, False,
                                       keep=keep_c)
    critic_layer_bwd_dx.launches += 1
    return (dx, tuple(t for t in kept if t is not None)) if keep else dx


def critic_layer_bwd_dwdb(x, w, b, dy, mode: str):
    """K2dw: ``(dw (O, C, 3), db (O,))`` in f32."""
    _check_mode(mode)
    if conv3.on_cpu(x, "critic_layer_bwd_dwdb"):
        return critic_layer_bwd_dwdb_plain(x, w, b, dy, mode)
    _, dw, db = conv3.launch_bwd("critic_layer_bwd_dwdb", x, w, b, dy, mode, False, True)
    critic_layer_bwd_dwdb.launches += 1
    return dw, db


def row_stats_plain(c):
    """Each row's (mean, E[c²] − mean²) of c (N, O, T) before the clamp,
    (N, O, 2): what K2dx's dc pass keeps in the in_relu mode."""
    mean = c.mean(dim=-1, keepdim=True)
    return torch.cat((mean, (c * c).mean(dim=-1, keepdim=True) - mean * mean), dim=-1)


def dx_vjp_row_plain(c, stats, dy, v, mode: str):
    """The row pass of K2dx's vjp (``csrc/conv_layer.cu``:
    ``dx_vjp_row_kernel``) in plain PyTorch: from v = conv(u, w), the
    cotangents (on dy, on c) of ``dc = conv3.dc_from_dy(dy, c, mode)``, on
    c's relu masks and row statistics ``stats`` (:func:`row_stats_plain`).
    With rsig = (max(var, 0) + eps)^-½, x̂ = (c − mean)·rsig, m = (x̂ > 0),
    g = m·dy and bars the means over T:

      relu     d_dy = (c > 0)·v, d_c = None (the mask is flat)
      in_relu  d_dy = m·rsig·(v − v̄ − x̂·p),  p = mean(v·x̂);
               d_c  = −rsig²·(p·(g − ḡ) + k·(v − v̄) + x̂·q),  k = mean(g·x̂),
               q = mean(v·g) − ḡ·v̄ − 3·k·p, and q = 0 where var < 0.

    d_c: ⟨v, dc⟩ = rsig·Σ_t v_t·(g_t − ḡ − x̂_t·k) depends on c through x̂
    and rsig, with ∂x̂_t/∂c_s = rsig·(δ_ts − 1/T) − x̂_t·x̂_s·rsig/T and
    ∂rsig/∂c_s = −rsig²·x̂_s/T (the clamp zeroes both second terms where
    var < 0).  Its x̂-partial is a = −rsig·(g·p + k·v), with mean(a·x̂) =
    −2·rsig·k·p, and its rsig-partial is T·(mean(v·g) − ḡ·v̄ − k·p); the
    chain gives d_c above, and Σ_t d_c = 0 on every row (Σ_t x̂ = 0)."""
    if mode == "relu":
        return v * (c > 0), None
    mean, var = stats[..., :1], stats[..., 1:]
    rsig = torch.rsqrt(torch.clamp_min(var, 0.0) + IN_EPS)
    xhat = (c - mean) * rsig
    m = (xhat > 0).to(c.dtype)
    g = dy * m
    vbar, p = v.mean(dim=-1, keepdim=True), (v * xhat).mean(dim=-1, keepdim=True)
    gbar, k = g.mean(dim=-1, keepdim=True), (g * xhat).mean(dim=-1, keepdim=True)
    q = torch.where(var < 0, 0.0, (v * g).mean(dim=-1, keepdim=True) - gbar * vbar - 3 * k * p)
    d_dy = m * (rsig * ((v - vbar) - xhat * p))
    d_c = -(rsig * rsig) * (p * (g - gbar) + k * (v - vbar) + xhat * q)
    return d_dy, d_c


def _kept_plain(x, w, b, dy, mode: str):
    """What K2dx's dc pass keeps, recomputed by the plain version: (c, dc)
    in the relu mode, (c, dc, stats) in in_relu, () in linear."""
    if mode == "linear":
        return ()
    c = conv3.conv(x, w, b)
    dc = conv3.dc_from_dy(dy.to(c.dtype), c, mode)
    return (c, dc) if mode == "relu" else (c, dc, row_stats_plain(c))


def _conv_nobias(u, w, cpu: bool):
    """conv1d(u, w, padding=1), no bias: the forward core in the linear mode
    on the card, in u's dtype; the plain conv in the statistics dtype."""
    if cpu:
        acc = stats_dtype(u.dtype)
        return F.conv1d(u.to(acc), w.to(acc), padding=1)
    return conv3.launch_fwd("critic_layer_bwd_dx_vjp", u, w, None, "linear")


def _bwd_linear(x, w, b, dy, need_dx: bool, need_dw: bool, cpu: bool):
    """(dx, dw, db) of the linear layer at dy: K2dx/K2dw's launcher in the
    linear mode (dc = dy) on the card, the plain version on the CPU."""
    if cpu:
        return conv3.layer_bwd_plain(x, w, b, dy, "linear", need_dx, need_dw)
    return conv3.launch_bwd("critic_layer_bwd_dx_vjp", x, w, b, dy, "linear", need_dx, need_dw)


def _dx_vjp_row(c, stats, dy, v, mode: str, cpu: bool):
    """(d_dy, d_c) of :func:`dx_vjp_row_plain`; on the card one launch of
    ``dx_vjp_row_kernel``, which leaves d_dy in v."""
    if cpu:
        return dx_vjp_row_plain(c, stats, dy, v, mode)
    n, o, t = c.shape
    dcc = torch.empty_like(c) if mode == "in_relu" else None
    with torch.cuda.device(c.device):
        err = _build.library().scgrhc_critic_layer_dx_vjp(
            *(None if a is None else a.data_ptr() for a in (c, stats, dy, v, dcc)), n, o, t,
            conv3.MODE_CODE[mode], conv3._stream(c))
    _build.check(err, "critic_layer_bwd_dx_vjp")
    return v, dcc


def critic_layer_bwd_dx_vjp(x, w, b, dy, u, mode: str, need=(True,) * 4, kept=()):
    """The vjp of K2dx (dx = conv_t(dc, w), dc = ``conv3.dc_from_dy(dy,
    conv(x, w, b), mode)``) at the cotangent u (N, C, T) on dx, in closed
    form: ``(dx, dw, db, ddy)`` for the inputs (x, w, b, dy) that ``need``
    asks for, None for the rest and where the gradient is zero (dx and db
    outside the in_relu mode, whose masks are flat in c).

      1. v = conv(u, w), no bias: the adjoint of the transposed conv;
      2. dw = Σ_{n,t} dc ⊗ u: the linear backward at (u, dc), dw only;
      3. (ddy, d_c) from v: :func:`dx_vjp_row_plain`;
      4. in_relu: the linear backward at (x, d_c) gives dx, dw's second
         term and db = Σ d_c.

    A CPU tensor takes the plain products, with c, dc and the row
    statistics recomputed (:func:`_kept_plain`); a CUDA tensor (float32)
    launches the conv core (1, 4), the dw product (2, 4) and
    ``dx_vjp_row_kernel`` (3) on ``kept``, what K2dx's own launch kept
    (:func:`critic_layer_bwd_dx` with ``keep``), or raises."""
    _check_mode(mode)
    cpu = conv3.on_cpu(x, "critic_layer_bwd_dx_vjp")
    if cpu:
        kept = _kept_plain(x, w, b, dy, mode)
    elif x.dtype != torch.float32 or len(kept) != {"linear": 0, "relu": 2, "in_relu": 3}[mode]:
        raise ValueError(
            f"critic_layer_bwd_dx_vjp takes float32 on the card with K2dx's kept c, dc and "
            f"statistics ({mode!r}), got {x.dtype} with {len(kept)} kept tensors")
    need_x, need_w, need_b, need_dy = need
    norm = mode == "in_relu" and (need_x or need_w or need_b)
    c, dc, stats = (*kept, None)[:3] if kept else (None, dy, None)
    ddy = d_c = dx = dw = db = None
    if need_dy or norm:
        v = _conv_nobias(u, w, cpu)
        ddy, d_c = (v, None) if mode == "linear" else _dx_vjp_row(c, stats, dy, v, mode, cpu)
    if need_w:
        dw = _bwd_linear(u, w, b, dc, False, True, cpu)[1]
    if norm:
        dx, dw_c, db = _bwd_linear(x, w, b, d_c, need_x, need_w or need_b, cpu)
        if need_w:
            dw = dw + dw_c
    if not cpu:
        critic_layer_bwd_dx_vjp.launches += 1
    return tuple(g.to(t.dtype) if n and g is not None else None
                 for g, n, t in zip((dx, dw, db, ddy), need, (x, w, b, dy)))


critic_layer.launches = 0
critic_layer_bwd_dx.launches = 0
critic_layer_bwd_dwdb.launches = 0
critic_layer_bwd_dx_vjp.launches = 0


def _recording(*ts) -> bool:
    """Whether autograd records a graph through ``ts``, so that K2dx keeps
    what its vjp reads."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _plain_vjp(ctx, plain, cts):
    """Gradients of ``plain(x, w, b, dy, mode)`` for the inputs that need
    one, at the output cotangents ``cts``, under the span
    ``gp_second_order``: :class:`BwdDwDb`'s backward, and :class:`BwdDx`'s
    in bf16; the tests hold :func:`critic_layer_bwd_dx_vjp` to it."""
    saved = ctx.saved_tensors[:4]
    need = ctx.needs_input_grad[:4]
    with annotate("gp_second_order"), torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*ins, ctx.mode)
        out = out if isinstance(out, tuple) else (out,)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, cts, allow_unused=True))
    return tuple(next(grads) if n else None for n in need) + (None,)


class BwdDx(torch.autograd.Function):
    """K2dx; ``keep`` (:func:`_recording`): the launch keeps what its vjp
    reads.  The backward runs once per node under the span
    ``gp_second_order``; no third order is taken."""

    @staticmethod
    def forward(ctx, x, w, b, dy, mode, keep):
        if keep:
            dx, kept = critic_layer_bwd_dx(x, w, b, dy, mode, keep=True)
        else:
            dx, kept = critic_layer_bwd_dx(x, w, b, dy, mode), ()
        ctx.save_for_backward(x, w, b, dy, *kept)
        ctx.mode = mode
        return dx

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, w, b, dy, *kept = ctx.saved_tensors
        if x.dtype == torch.bfloat16:
            return _plain_vjp(ctx, critic_layer_bwd_dx_plain, (ct,)) + (None,)
        with annotate("gp_second_order"):
            grads = critic_layer_bwd_dx_vjp(x, w, b, dy, ct.contiguous(), ctx.mode,
                                            ctx.needs_input_grad[:4], kept)
        return (*grads, None, None)


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
            dx = BwdDx.apply(x, w, b, dy, ctx.mode, _recording(x, w, b, dy))
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
    whose own backward is its closed-form vjp (:class:`BwdDx`)."""
    _check_mode(mode)
    dy = dy.contiguous()
    return BwdDx.apply(x, w, b, dy, mode, _recording(x, w, b, dy))
