"""The plain reference against the port on the CPU at small sizes, where the
port runs its kernels' plain versions: the forwards and the critic's input
gradient to float32 rounding, and the WGAN-GP step's first loss."""

import numpy as np
import pytest
import torch

from benchmark.lib import compare, seeds
from benchmark.reference import model
from benchmark.reference import train as reference

T = 96


@pytest.fixture(scope="module")
def weights():
    dev = torch.device("cpu")
    return (seeds.weights(model.generator_shapes(3), seeds.subseed(5, 1), dev),
            seeds.weights(model.critic_shapes(3), seeds.subseed(5, 2), dev))


def port_models(g_w, d_w):
    from scgrhc_torch.models.critic import Critic
    from scgrhc_torch.models.generator import Generator

    g, d = Generator(3), Critic(3)
    g.load_state_dict(g_w)
    d.load_state_dict(d_w)
    return g.eval(), d


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_weights_are_the_published_init(weights):
    g_w, d_w = weights
    for shapes, w in ((model.generator_shapes(3), g_w), (model.critic_shapes(3), d_w)):
        for name, shape, fan in shapes:
            assert tuple(w[name].shape) == shape
            assert float(w[name].abs().max()) <= 1.0 / np.sqrt(fan)


def test_forwards_and_input_gradient(weights):
    g_w, d_w = weights
    g, d = port_models(g_w, d_w)
    x = torch.rand(3, 4, T, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert rel(g(x[:, :3]), model.generator(g_w, x[:, :3])) < 1e-5
    scores, dx = d(x, ct=torch.ones(3, 1, T))
    xr = x.clone().requires_grad_(True)
    ref = model.critic(d_w, xr)
    (dx_ref,) = torch.autograd.grad(ref.sum(), xr)
    assert rel(scores.detach(), ref.detach()) < 1e-5 and rel(dx.detach(), dx_ref) < 1e-5


def test_first_training_losses(weights):
    """One WGAN-GP step from the same weights, batch and draws: the first
    critic loss (no update yet) within 1e-3 and every loss of the step
    within 1e-2."""
    from scgrhc_torch.parallel.dp import DataParallelTrainer
    from scgrhc_torch.train.wgan import TrainConfig, init_state

    g_w, d_w = weights
    hp = {"alpha": 1e-4, "beta1": 0.5, "beta2": 0.999, "lambda_gp": 10.0,
          "lambda_aux": 100.0, "n_critic": 2}
    gen = torch.Generator().manual_seed(8)
    scg, rhc = torch.rand(4, 3, 200, generator=gen), torch.rand(4, 1, 200, generator=gen)
    state = init_state(0, 3, TrainConfig(**hp), "cpu")
    with torch.no_grad():
        for w, module in ((g_w, state.generator), (d_w, state.critic)):
            for name, p in module.named_parameters():
                p.copy_(w[name])
    d, g = DataParallelTrainer().step(state, scg, rhc, torch.arange(4),
                                      torch.Generator().manual_seed(9), TrainConfig(**hp))
    ref, _, _ = reference.run_steps(g_w, d_w, [(scg, rhc)], [torch.Generator().manual_seed(9)], hp)
    prog = d.tolist() + [float(g)]
    # the penalty's input gradient switches with the relu masks, so float32
    # rounding in the prediction moves the first loss by up to about 1e-4
    assert abs(prog[0] / ref[0][0] - 1) < 1e-3
    assert compare.scalar_gap(prog, ref[0]) < 1e-2
