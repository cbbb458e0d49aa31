"""The published WGAN-GP step (waveform_train.py:249-286, 356-381) in plain
PyTorch autograd, with Adam written out.

One step: ``n_critic`` critic updates on
``-E[D(scg|rhc)] + E[D(scg|G(scg))] + lambda_gp * E[(|grad_x D(scg|x)| - 1)^2]``
at the interpolant ``x = eps * rhc + (1 - eps) * G(scg)`` (the norm over the
rhc channel, with 1e-12 under the root), each with a fresh dropout forward
of the generator; then one generator update on
``-E[D(scg|rhc)] + lambda_aux * MSE(G(scg), rhc)``, whose adversarial term
scores the real rhc, as the published code does.  The gradient penalty's
second order is autograd's ``create_graph``.

Draws, in the order the published step makes them from the step's one
generator: per critic update the six dropout masks of the generator's
forward, then eps (B, 1, 1); then the generator update's six masks.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model


class Adam:
    """``torch.optim.Adam`` (eps 1e-8, no weight decay) over a dict of
    leaves, written out."""

    def __init__(self, params: dict, lr: float, beta1: float, beta2: float, eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
                self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))


def gradient_penalty(d: dict, scg, interp):
    xi = torch.cat((scg, interp), dim=1).requires_grad_(True)
    (g,) = torch.autograd.grad(model.critic(d, xi).sum(), xi, create_graph=True)
    g = g[:, scg.shape[1]:].reshape(g.shape[0], -1)
    return ((torch.sqrt((g * g).sum(dim=1) + 1e-12) - 1.0) ** 2).mean()


def critic_loss(g: dict, d: dict, scg, rhc, rng, hp: dict):
    with torch.no_grad():
        pred = model.generator(g, scg, rng)
    eps = torch.rand((rhc.shape[0], 1, 1), generator=rng, device=rhc.device)
    interp = (eps * rhc + (1.0 - eps) * pred).detach()
    pred_mean = model.critic(d, torch.cat((scg, pred), dim=1)).mean()
    real_mean = model.critic(d, torch.cat((scg, rhc), dim=1)).mean()
    return -real_mean + pred_mean + hp["lambda_gp"] * gradient_penalty(d, scg, interp)


def generator_loss(g: dict, d: dict, scg, rhc, rng, hp: dict):
    pred = model.generator(g, scg, rng)
    validity = model.critic({k: v.detach() for k, v in d.items()}, torch.cat((scg, rhc), dim=1))
    return -validity.mean() + hp["lambda_aux"] * ((pred - rhc) ** 2).mean()


def leaves(weights: dict) -> dict:
    """Fresh float32 leaves that need gradients, copied from ``weights``."""
    return {k: v.detach().float().clone().requires_grad_(True) for k, v in weights.items()}


def run_steps(g_weights: dict, d_weights: dict, batches, rngs, hp: dict):
    """The steps over ``batches`` ((scg, rhc) pairs), step i drawing from
    ``rngs[i]``.  Returns ``losses`` (per step: the critic losses, then the
    generator loss), ``first_moment`` (each leaf's Adam first moment after
    the first step, {"g": ..., "d": ...}) and ``weights`` after the last
    step ({"g": ..., "d": ...})."""
    g, d = leaves(g_weights), leaves(d_weights)
    g_opt = Adam(g, hp["alpha"], hp["beta1"], hp["beta2"])
    d_opt = Adam(d, hp["alpha"], hp["beta1"], hp["beta2"])
    losses, first_moment = [], None
    for (scg, rhc), rng in zip(batches, rngs):
        row = []
        for _ in range(hp["n_critic"]):
            loss = critic_loss(g, d, scg, rhc, rng, hp)
            d_opt.step(_grads(loss, d))
            row.append(float(loss.detach()))
        loss = generator_loss(g, d, scg, rhc, rng, hp)
        g_opt.step(_grads(loss, g))
        row.append(float(loss.detach()))
        losses.append(row)
        if first_moment is None:
            first_moment = {"g": {k: v.clone() for k, v in g_opt.m.items()},
                            "d": {k: v.clone() for k, v in d_opt.m.items()}}
    weights = {"g": {k: v.detach() for k, v in g.items()},
               "d": {k: v.detach() for k, v in d.items()}}
    return losses, first_moment, weights
