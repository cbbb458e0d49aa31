"""Training traffic: WGAN-GP steps through the program's own step, as
``scgrhc_torch.train.run``'s epoch mode drives them.

Set-up makes the training split on the card from the seed (SCG windows and
an RHC pulse train, each window scaled to [0, 1]), the weights on the card
from the seed (loaded into the program's train state), and runs the first
``checked_steps`` steps through ``DataParallelTrainer.step`` (a mesh of
one: ``train_step`` on the whole batch), which also warms every shape the
window uses.  Each epoch's order is a permutation drawn from the seed; step
k of epoch e draws its dropout masks and eps from a generator on the card
seeded from (seed, e, k); the losses come back to the host once an epoch.

The window runs steps until ``--seconds`` have passed, then reads the last
losses back; ``train_windows_per_s`` is the windows trained over the time
from the first step dispatched to that read-back.  ``--trace 1`` traces
``traced_steps`` more steps after the window.

``correct``: the plain reference (:mod:`benchmark.reference.train`) runs
the checked steps from the same weights, batches and draws, once the
window has closed and the program's state is freed.  The numbers: the
first critic loss, before any update (``first_loss_gap``); each step's
losses (``loss_gap``); the generator's median leaf of the Adam first moment
after the first step, which is its first gradient as the optimizer got it
(``grad_median_gap``), and the worst leaf of both models' (``grad_gap``);
and the worst leaf's change over the checked steps (``update_gap``),
leaving out the leaves whose reference gradient is under a thousandth of
the median leaf's (the conv biases under an instance norm).  The cell's
limits file names the numbers compared.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from benchmark.lib import compare, flops, seeds
from benchmark.lib.trace import Traced
from benchmark.reference import model
from benchmark.reference import train as reference

WEIGHTS_G, WEIGHTS_D, DATA, ORDER, STEP = 1, 2, 3, 4, 5


def hyper(config: dict) -> dict:
    hp = {k: float(config[k]) for k in ("alpha", "beta1", "beta2", "lambda_gp", "lambda_aux")}
    return {**hp, "n_critic": int(config["n_critic"])}


def make_data(n: int, c: int, t: int, seed: int, device):
    """(scg (n, c, t), rhc (n, 1, t)) on the card, every window min-max scaled."""
    gen = seeds.generator(seed, device)
    scg = torch.rand((n, c, t), generator=gen, device=device)
    tt = torch.arange(t, device=device, dtype=torch.float32) / 500.0
    rate = 0.9 + 0.6 * torch.rand((n, 1, 1), generator=gen, device=device)
    phase = torch.frac(tt * rate + torch.rand((n, 1, 1), generator=gen, device=device))
    rhc = (torch.exp(-((phase - 0.15) ** 2) / 0.006)
           + 0.35 * torch.exp(-((phase - 0.45) ** 2) / 0.004)
           + 0.05 * torch.randn((n, 1, t), generator=gen, device=device))

    def scale(x):
        lo = x.amin(dim=(1, 2), keepdim=True)
        hi = x.amax(dim=(1, 2), keepdim=True)
        return (x - lo) / (hi - lo + 1e-4)

    return scale(scg), scale(rhc)


def numbers(prog: dict, ref: dict, w0: dict) -> dict[str, float]:
    """The numbers of a training cell, program (or control) against the
    reference: both are ``{"losses", "first_moment", "weights"}`` as
    :func:`benchmark.reference.train.run_steps` returns them."""
    grad = upd = 0.0
    for m in ("g", "d"):
        grad = max(grad, compare.leaf_norm_gap(prog["first_moment"][m],
                                               ref["first_moment"][m])[0])
        moved = compare.moved_leaves(ref["first_moment"][m])
        dp = {k: prog["weights"][m][k] - w0[m][k] for k in moved}
        dr = {k: ref["weights"][m][k] - w0[m][k] for k in moved}
        upd = max(upd, compare.leaf_norm_gap(dp, dr)[0])
    return {
        "first_loss_gap": compare.scalar_gap(prog["losses"][0][:1], ref["losses"][0][:1]),
        "loss_gap": compare.scalar_gap([x for row in prog["losses"] for x in row],
                                       [x for row in ref["losses"] for x in row]),
        "grad_median_gap": statistics.median(compare.leaf_gaps(
            prog["first_moment"]["g"], ref["first_moment"]["g"]).values()),
        "grad_gap": grad,
        "update_gap": upd,
    }


def checks(prog: dict, ref: dict, w0: dict, limits: dict) -> list[dict]:
    """The numbers that the cell's limits file gives a limit, each beside it."""
    return [{"name": n, "value": v, "limit": limits[n]["limit"]}
            for n, v in numbers(prog, ref, w0).items() if n in limits]


def host(tree: dict) -> dict:
    return {m: {k: v.detach().double().cpu().numpy() for k, v in leaves.items()}
            for m, leaves in tree.items()}


class Driver:
    def __init__(self, run):
        self.run = run
        c = run.config
        self.c = len(c["in_channels"])
        self.t = int(round(c["segment_size"] * 500))
        self.b = int(c["batch_size"])
        self.n = int(c["train_windows"])
        self.hp = hyper(c)
        self.step_flops = flops.step_conv_flops(self.c, self.b, self.t, self.hp["n_critic"])

    # the program's feed: epoch orders and step generators from the seed
    def _order(self, epoch: int):
        gen = seeds.generator(seeds.subseed(self.run.seed, ORDER, epoch), self.dev)
        return torch.randperm(self.n, generator=gen, device=self.dev)

    def _rng(self, epoch: int, k: int):
        return seeds.generator(seeds.subseed(self.run.seed, STEP, epoch, k), self.dev)

    def _next(self):
        """The next step's (epoch, k, row indices)."""
        per_epoch = self.n // self.b
        if self.k == per_epoch:
            self.epoch, self.k = self.epoch + 1, 0
            self.order = self._order(self.epoch)
        idx = self.order[self.k * self.b:(self.k + 1) * self.b]
        self.k += 1
        return self.epoch, self.k - 1, idx

    def _step(self):
        epoch, k, idx = self._next()
        d, g = self.trainer.step(self.state, self.scg, self.rhc, idx, self._rng(epoch, k), self.cfg)
        return torch.cat((d, g[None]))

    def setup(self):
        from scgrhc_torch.core.device import resolve_device
        from scgrhc_torch.parallel.dp import DataParallelTrainer
        from scgrhc_torch.parallel.mesh import make_mesh
        from scgrhc_torch.train.wgan import TrainConfig, init_state

        run = self.run
        self.dev = resolve_device(run.device)
        self.cfg = TrainConfig(**self.hp)
        w0 = {"g": seeds.weights(model.generator_shapes(self.c),
                                 seeds.subseed(run.seed, WEIGHTS_G), self.dev),
              "d": seeds.weights(model.critic_shapes(self.c),
                                 seeds.subseed(run.seed, WEIGHTS_D), self.dev)}
        self.state = init_state(0, self.c, self.cfg, self.dev)
        with torch.no_grad():
            for m, module in (("g", self.state.generator), ("d", self.state.critic)):
                for name, p in module.named_parameters():
                    p.copy_(w0[m][name])
        self.w0 = w0
        self.scg, self.rhc = make_data(self.n, self.c, self.t, seeds.subseed(run.seed, DATA),
                                       self.dev)
        self.trainer = DataParallelTrainer(make_mesh())
        self.trainer.place_state(self.state)
        self.epoch, self.k, self.order = 0, 0, self._order(0)

        self.batches, self.rng_seeds, losses = [], [], []
        for i in range(int(run.traffic["checked_steps"])):
            idx = self.order[self.k * self.b:(self.k + 1) * self.b]
            self.batches.append((self.scg[idx].clone(), self.rhc[idx].clone()))
            self.rng_seeds.append(seeds.subseed(run.seed, STEP, self.epoch, self.k))
            losses.append(self._step())
            if i == 0:
                self.first_moment = {
                    m: {name: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach()
                        .clone() for name, p in module.named_parameters()}
                    for m, module, opt in (("g", self.state.generator, self.state.g_opt),
                                           ("d", self.state.critic, self.state.d_opt))}
        self.checked_losses = torch.stack(losses).tolist()
        self.checked_weights = {
            m: {name: p.detach().clone() for name, p in module.named_parameters()}
            for m, module in (("g", self.state.generator), ("d", self.state.critic))}

    def _read_back(self, pending: list) -> int:
        """Read pending losses back; returns how many steps gave a non-finite one."""
        if not pending:
            return 0
        rows = torch.stack(pending).tolist()
        return sum(1 for row in rows if not all(math.isfinite(x) for x in row))

    def measure(self):
        run = self.run
        self.setup()
        per_epoch = self.n // self.b
        run.setup_end = time.time()
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        steps, failed, pending, marks = 0, 0, [], []
        while True:
            pending.append(self._step())
            steps += 1
            if self.k == per_epoch:  # the epoch's read-back
                failed += self._read_back(pending)
                pending = []
                marks.append(time.perf_counter() - t0)
            if time.perf_counter() >= deadline:
                break
        failed += self._read_back(pending)
        if run.on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run.window = {"steps": steps, "windows": steps * self.b, "seconds": seconds,
                      "conv_flops": steps * self.step_flops}
        print(f"benchmark: {steps} steps in {seconds:.3f} s; epochs read back at "
              f"{[round(m, 3) for m in marks]} s", file=sys.stderr)
        if run.trace:
            n = int(run.traffic["traced_steps"])
            tracer = Traced(run.tmpdir, run.on_card)
            tracer.start()
            failed += self._read_back([self._step() for _ in range(n)])
            run.summary = tracer.stop()
            run.traced = {"steps": n, "launches": flops.train_step_launches(
                self.c, self.b, self.t, self.hp["n_critic"]) * n}
        return {"train_windows_per_s": steps * self.b / seconds}, steps, failed

    def program_result(self) -> dict:
        return {"losses": self.checked_losses, "first_moment": host(self.first_moment),
                "weights": host(self.checked_weights)}

    def free(self):
        """Drop the program's state and the split; keep what the check reads."""
        for name in ("state", "trainer", "scg", "rhc", "order"):
            setattr(self, name, None)
        if self.run.on_card:
            torch.cuda.empty_cache()

    def reference_result(self) -> dict:
        rngs = [seeds.generator(s, self.dev) for s in self.rng_seeds]
        losses, first_moment, weights = reference.run_steps(
            self.w0["g"], self.w0["d"], self.batches, rngs, self.hp)
        return {"losses": losses, "first_moment": host(first_moment),
                "weights": host(weights)}

    def check(self):
        prog = self.program_result()
        self.free()
        return checks(prog, self.reference_result(), host(self.w0), self.run.limits)

