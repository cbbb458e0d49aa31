"""WGAN-GP training step, the PyTorch counterpart of ``scgrhc.train.wgan``
(reference: waveform_train.py:249-286, 356-381).

  * critic (×n_critic):
      ``-E[D(scg‖rhc)] + E[D(scg‖G(scg))] + λ_gp · GP``,
    the gradient penalty's input gradient built with the critic's forward
    (``Critic.forward(x, ct=...)``: each layer's twice-differentiable input
    gradient, top down), and the critic loss then differentiated with
    respect to the critic's parameters.  No ``create_graph`` backward runs,
    so the step gives the same bits in a process's first step as in its
    later ones (``scgrhc_torch.models.critic``).  The
    generator runs without a graph here: the step differentiates the
    critic loss with respect to the critic only.
  * generator:
      ``-E[D(scg‖rhc)] + λ_aux · MSE(G(scg), rhc)``,
    with the reference quirk that the adversarial term scores the REAL rhc
    (waveform_train.py:376; ``fix_g_adversarial`` scores the prediction).

Optimizer: ``torch.optim.Adam(lr=alpha, betas=(beta1, beta2), eps=1e-8)``,
the update rule of ``optax.adam(eps_root=0)``.

All draws of one step (six dropout masks per generator forward, the GP's
interpolation eps per critic iteration) come from one ``torch.Generator``
on the device, which :func:`step_rng` seeds from (seed, epoch, batch
index): step mode, epoch mode and a resumed run draw the same numbers.
``generator.dropout`` and :func:`_draw_eps` are module-level seams the
parity tests replace, as they do in the JAX package.

``train_dtype: bfloat16`` keeps f32 master weights and Adam state, and
casts the weights inside the losses (the generator's ``final`` stays f32,
so predictions come back f32).  ``remat``, ``conv_backend`` and
``critic_backend`` are read for compatibility only: the generator's layers
always run K1f/K1b and the critic's K2f/K2dx/K2dw on the card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from scgrhc_torch.models.critic import Critic
from scgrhc_torch.models.generator import Generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FUSE_MODES = ("off", "2b", "3b")


@dataclass(frozen=True)
class TrainConfig:
    """The step's hyperparameters, the fields of ``scgrhc.train.wgan.
    TrainConfig``."""

    n_critic: int = 2
    lambda_gp: float = 10.0
    lambda_aux: float = 100.0
    alpha: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    fix_g_adversarial: bool = False
    compute_dtype: str = "float32"
    remat: bool = False  # compatibility only
    conv_backend: str = "xla"  # compatibility only
    critic_fuse: str = "off"
    critic_backend: str = "xla"  # compatibility only
    reuse_pred: bool = False

    def __post_init__(self):
        if self.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(DTYPES)}")
        if self.critic_fuse not in FUSE_MODES:
            raise ValueError(f"critic_fuse must be one of {FUSE_MODES}")

    @classmethod
    def from_params(cls, params) -> "TrainConfig":
        return cls(
            n_critic=int(params.n_critic),
            lambda_gp=float(params.lambda_gp),
            lambda_aux=float(params.lambda_aux),
            alpha=float(params.alpha),
            beta1=float(params.beta1),
            beta2=float(params.beta2),
            fix_g_adversarial=bool(getattr(params, "fix_g_adversarial", False)),
            compute_dtype=str(getattr(params, "train_dtype", "float32")),
            critic_fuse=str(getattr(params, "critic_fuse", "off")),
            remat=bool(getattr(params, "remat", False)),
            conv_backend=str(getattr(params, "conv_backend", "xla")),
            critic_backend=str(getattr(params, "critic_backend", "xla")),
            reuse_pred=bool(getattr(params, "reuse_pred", False)),
        )


@dataclass
class TrainState:
    generator: Generator
    critic: Critic
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam


def make_optimizer(module: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=cfg.alpha, betas=(cfg.beta1, cfg.beta2),
                            eps=1e-8)


def init_state(seed: int, in_channels: int, cfg: TrainConfig, device) -> TrainState:
    """Fresh weights (PyTorch's default conv init, drawn on the CPU from
    ``seed``) and fresh Adam state, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    g = Generator(in_channels, gen, device=device)
    d = Critic(in_channels, gen, device=device)
    return TrainState(g, d, make_optimizer(g, cfg), make_optimizer(d, cfg))


def step_rng(seed: int, epoch: int, batch: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from (seed, epoch, batch)."""
    state = np.random.SeedSequence([seed, epoch, batch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))


def _stat_dtype(x) -> torch.dtype:
    """Reduction dtype: f32, or f64 when the computation is already f64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _masked_mean(v, mask=None):
    """Mean over (B, ...) with per-sample 0/1 weights; ``mask=None`` is the
    plain mean."""
    if mask is None:
        return v.mean()
    m = mask.to(v.dtype)
    per_sample = v.reshape(v.shape[0], -1).mean(dim=1)
    return (per_sample * m).sum() / m.sum()


def _gp_norms(grads):
    """Per-sample ℓ2 of the interpolant gradient, reduced in f32 (f64 for
    f64), with +1e-12 under the root."""
    g = grads.to(_stat_dtype(grads)).reshape(grads.shape[0], -1)
    return torch.sqrt((g * g).sum(dim=1) + 1e-12)


def _draw_eps(rng: torch.Generator, b: int, device):
    """The GP interpolation draw (reference: waveform_train.py:260,
    ``torch.rand(batch_size, 1, 1)``), in f32."""
    return torch.rand((b, 1, 1), generator=rng, device=device, dtype=torch.float32)


def _cast(module: torch.nn.Module, dtype: torch.dtype, keep: tuple[str, ...] = ()):
    """``module`` as a function of its weights cast to ``dtype`` (children
    named in ``keep`` keep theirs), differentiable back to the f32 masters."""
    params = {
        name: p if name.split(".")[0] in keep else p.to(dtype)
        for name, p in module.named_parameters()
    }
    return lambda *args, **kw: functional_call(module, params, args, kw)


def _compute(module, cfg: TrainConfig, keep=()):
    dt = DTYPES[cfg.compute_dtype]
    return module if dt == torch.float32 else _cast(module, dt, keep)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """Parameters that need no gradient while the block runs."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _train_pred(generator: Generator, scg, rng, cfg: TrainConfig):
    """One train-mode generator forward in the compute dtype (f32 output:
    ``final`` keeps its dtype)."""
    dt = DTYPES[cfg.compute_dtype]
    if dt != torch.float32:
        scg = scg.to(dt)
    return _compute(generator, cfg, keep=("final",))(scg, rng=rng, train=True)


def _scores_and_grad(critic_fn, x, ct_rows: slice = slice(None)):
    """Scores of x (N, C, T) and the input gradient of the rows
    ``ct_rows``' score sum; ``critic_fn(x, ct=...)`` is a Critic's forward."""
    ct = torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
    ct[ct_rows] = 1.0
    return critic_fn(x, ct=ct)


def gradient_penalty_from_eps(critic_fn, scg, rhc, pred_rhc, eps, mask=None):
    """WGAN-GP: ∥∇_x D(scg‖x)∥₂ at the per-sample interpolant
    ``eps·rhc + (1−eps)·pred``, penalized towards 1."""
    interp = (eps * rhc + (1.0 - eps) * pred_rhc).detach()
    _, dx = _scores_and_grad(critic_fn, torch.cat((scg, interp), dim=1))
    grads = dx[:, scg.shape[1]:]
    return _masked_mean(torch.square(_gp_norms(grads) - 1.0), mask)


def _critic_terms(critic_fn, scg, rhc, pred_rhc, eps, fuse: str, mask=None):
    """(E[D(pred)], E[D(real)], GP) with the chosen forward batching; all
    three modes compute the same per-sample scores."""
    if fuse == "3b":
        z = (eps * rhc + (1.0 - eps) * pred_rhc).detach()
        x = torch.cat((pred_rhc, rhc, z), dim=0)
        b = scg.shape[0]
        v, dx = _scores_and_grad(critic_fn, torch.cat((torch.cat((scg, scg, scg), dim=0), x),
                                                      dim=1), slice(2 * b, None))
        vp, vr, _ = v.chunk(3, dim=0)
        grads = dx[2 * b:, scg.shape[1]:]
        gp = _masked_mean(torch.square(_gp_norms(grads) - 1.0), mask)
        return _masked_mean(vp, mask), _masked_mean(vr, mask), gp
    if fuse == "2b":
        v = critic_fn(torch.cat((torch.cat((scg, pred_rhc), dim=1),
                                 torch.cat((scg, rhc), dim=1)), dim=0))
        vp, vr = v.chunk(2, dim=0)
    else:  # "off": the reference's three separate forwards
        vp = critic_fn(torch.cat((scg, pred_rhc), dim=1))
        vr = critic_fn(torch.cat((scg, rhc), dim=1))
    gp = gradient_penalty_from_eps(critic_fn, scg, rhc, pred_rhc, eps, mask)
    return _masked_mean(vp, mask), _masked_mean(vr, mask), gp


def critic_loss(critic: Critic, generator: Generator, scg, rhc, rng, cfg: TrainConfig,
                mask=None, pred_rhc=None):
    dt = DTYPES[cfg.compute_dtype]
    if pred_rhc is None:  # fresh dropout-resampled forward (reference)
        with torch.no_grad():
            pred_rhc = _train_pred(generator, scg, rng, cfg)
    if dt != torch.float32:
        scg, rhc, pred_rhc = scg.to(dt), rhc.to(dt), pred_rhc.to(dt)
    # eps drawn in f32 so the stream is the same in every compute dtype
    eps = _draw_eps(rng, rhc.shape[0], rhc.device).to(rhc.dtype)
    pred_mean, real_mean, gp = _critic_terms(
        _compute(critic, cfg), scg, rhc, pred_rhc, eps, cfg.critic_fuse, mask
    )
    loss = -real_mean + pred_mean + cfg.lambda_gp * gp
    return loss.to(_stat_dtype(loss))


def generator_loss(generator: Generator, critic: Critic, scg, rhc, rng, cfg: TrainConfig,
                   mask=None, pred_rhc=None):
    """``pred_rhc`` (with its graph) stands in for the forward when given."""
    dt = DTYPES[cfg.compute_dtype]
    if pred_rhc is None:
        pred_rhc = _train_pred(generator, scg, rng, cfg)
    if dt != torch.float32:
        scg, rhc = scg.to(dt), rhc.to(dt)
    adv_input = pred_rhc.to(dt) if cfg.fix_g_adversarial else rhc
    with _frozen(critic):
        pred_validity = _compute(critic, cfg)(torch.cat((scg, adv_input), dim=1))
    resid = pred_rhc - rhc
    sq = torch.square(resid.to(_stat_dtype(resid)))
    if mask is None:
        mse = sq.mean()
    else:
        m = mask.to(sq.dtype)
        mse = (sq.reshape(sq.shape[0], -1).mean(dim=1) * m).sum() / m.sum()
    loss = -_masked_mean(pred_validity, mask) + cfg.lambda_aux * mse
    return loss.to(_stat_dtype(loss))


def _apply(opt: torch.optim.Adam, params, loss) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


def train_step(state: TrainState, scg, rhc, rng: torch.Generator, cfg: TrainConfig,
               mask=None):
    """One batch: n_critic critic updates, then one generator update
    (reference: waveform_train.py:357-381), in place on ``state``.  Returns
    (d_losses (n_critic,), g_loss) as device tensors.

    ``reuse_pred`` scores one shared prediction in every critic iteration
    and trains the generator on the same forward (one generator forward per
    step, as XLA's CSE gives the JAX step)."""
    g, d = state.generator, state.critic
    d_params, g_params = list(d.parameters()), list(g.parameters())
    pred = _train_pred(g, scg, rng, cfg) if cfg.reuse_pred else None
    shared = None if pred is None else pred.detach()
    d_losses = []
    for _ in range(cfg.n_critic):
        loss = critic_loss(d, g, scg, rhc, rng, cfg, mask, shared)
        _apply(state.d_opt, d_params, loss)
        d_losses.append(loss.detach())
    g_loss = generator_loss(g, d, scg, rhc, rng, cfg, mask, pred)
    _apply(state.g_opt, g_params, g_loss)
    return torch.stack(d_losses), g_loss.detach()


def launches_per_step(cfg: TrainConfig) -> dict[str, int]:
    """The kernel launches of one :func:`train_step` on the card, by wrapper
    name (``conv_in_relu`` K1f, ``conv_in_relu_bwd`` K1b, ``critic_layer``
    K2f, ``critic_layer_bwd_dx`` K2dx, ``critic_layer_bwd_dwdb`` K2dw).

    Per critic iteration, with ``critic_fuse`` off: three critic forwards
    (pred, real, GP interpolant) of 5 layers, and the GP's input gradient,
    5 K2dx.  The parameter gradient then runs the backward of the two
    scored forwards (4 K2dx each, their input needing none, and 5 K2dw
    each) and, through the GP's second order, of the GP forward's first 4
    layers (3 K2dx, the first layer's input needing none, and 4 K2dw).
    "2b" scores pred and real as one forward; "3b" runs one forward of all
    three, whose 5 layers the parameter gradient reaches once (4 K2dx, 5
    K2dw), the GP's input gradient running over all three.  The generator
    update runs one forward and backward (14 K1f, 14 K1b; K1f also runs in
    each critic iteration unless ``reuse_pred``) and one critic forward
    with the critic frozen, whose backward (5 K2dx) runs only under
    ``fix_g_adversarial``.
    """
    n = cfg.n_critic
    fwd, dx, dw = {"off": (15, 5 + 8 + 3, 10 + 4), "2b": (10, 5 + 4 + 3, 5 + 4),
                   "3b": (5, 5 + 4, 5)}[cfg.critic_fuse]
    return {
        "conv_in_relu": 14 * (1 if cfg.reuse_pred else n + 1),
        "conv_in_relu_bwd": 14,
        "critic_layer": fwd * n + 5,
        "critic_layer_bwd_dx": dx * n + (5 if cfg.fix_g_adversarial else 0),
        "critic_layer_bwd_dwdb": dw * n,
    }
