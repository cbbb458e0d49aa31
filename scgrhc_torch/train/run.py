"""Training stage, the port's copy of ``scgrhc.train.run`` (reference
parity: waveform_train.py:299-418).

Resume from the latest complete checkpoint, the epoch loop, the loss-diff
prints every 10 batches, the ``train_losses.png`` curve (skipped without
matplotlib) and a ``{epoch:03d}.checkpoint`` per epoch, as in the JAX
package.  ``train_mode``:

  * ``epoch`` (default): the split is uploaded to the device once, and each
    epoch's batches are gathered there from the epoch's permutation (the
    counterpart of ``train_epoch_gather``); losses come back to the host
    once per epoch.
  * ``step``: each batch is uploaded from the host, and its losses come
    back at once.

Both batch the same permutation and seed each step's draws from (seed,
epoch, batch index) (:func:`scgrhc_torch.train.wgan.step_rng`), so they
draw the same masks and eps, and so does a run resumed from any epoch, in
the same process or a new one: their checkpoints agree bit for bit, on
the CPU and on the card.
``shape_bucket``, ``channel_bucket``, ``checkpoint_backend: "orbax"``, an
``rng_impl`` other than threefry and a multi-process launch are not yet
ported and raise.  ``plot_async`` is read for compatibility only.
"""

from __future__ import annotations

import os
from time import perf_counter, time

import torch

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.data.loaders import load_dataloader
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train.wgan import TrainConfig, init_state, step_rng, train_step


def _plot_losses(g_losses, d_losses, epoch, total_epochs, batch, n_batches, dir_path):
    """Loss curve png (reference: waveform_train.py:391-399); nothing
    without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    plt.plot(g_losses, label="Generator Loss")
    plt.plot(d_losses, label="Discriminator Loss")
    plt.title(f"Epoch {epoch}/{total_epochs} | Batch {batch}/{n_batches}")
    plt.xlabel("Iteration")
    plt.ylabel("Loss")
    plt.ylim(0, 100)
    plt.legend()
    plt.savefig(os.path.join(dir_path, "train_losses.png"))
    plt.close()


def _refuse_unported(params) -> None:
    for key in ("shape_bucket", "channel_bucket"):
        if getattr(params, key, False):
            raise NotImplementedError(f"{key} is not yet ported to scgrhc_torch")
    if getattr(params, "checkpoint_backend", "reference") == "orbax":
        raise NotImplementedError("checkpoint_backend 'orbax' is not yet ported to scgrhc_torch")
    if getattr(params, "rng_impl", "threefry") != "threefry":
        raise NotImplementedError(
            f"rng_impl {params.rng_impl!r} is not yet ported to scgrhc_torch (threefry only)"
        )
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "training over more than one device is not yet ported to scgrhc_torch"
        )


def _step_mode(state, loader, cfg, seed, epoch, device):
    for i, (scg, rhc) in enumerate(loader.batches(epoch)):
        d, g = train_step(state, torch.from_numpy(scg).to(device),
                          torch.from_numpy(rhc).to(device),
                          step_rng(seed, epoch, i, device), cfg)
        yield i, d.tolist(), float(g)


def _epoch_mode(state, loader, cfg, seed, epoch, device):
    scg_all, rhc_all = loader.dataset.device_arrays(device)
    order = torch.from_numpy(loader.epoch_order(epoch)).to(device)
    bs = loader.batch_size
    losses = []
    for i, s in enumerate(range(0, len(order), bs)):
        idx = order[s:s + bs]
        d, g = train_step(state, scg_all[idx], rhc_all[idx], step_rng(seed, epoch, i, device),
                          cfg)
        losses.append(torch.cat((d, g[None])))
    for i, row in enumerate(torch.stack(losses).tolist() if losses else []):
        yield i, row[:-1], row[-1]


def run(params, device=None, plot: bool = True) -> dict:
    """Train ``params``' experiment on ``device`` (default CUDA) from its
    last complete checkpoint to ``total_epochs``.  Returns
    ``{"epochs": [{"epoch", "steps", "seconds"}, ...]}`` for the epochs run
    (seconds on the host clock, checkpoint write included)."""
    dev = resolve_device(device)
    _refuse_unported(params)
    start_time = time()
    print(timelog(f"Run waveform_train for {params.dir_path}", start_time))
    cfg = TrainConfig.from_params(params)
    total_epochs = params.total_epochs
    os.makedirs(params.checkpoint_dir_path, exist_ok=True)
    loader = load_dataloader(params.train_path, seed=params.seed)
    n_channels = len(params.in_channels)

    last = ckpt_io.get_last_checkpoint_path(params.checkpoint_dir_path)
    if last is not None:
        path = os.path.join(params.checkpoint_dir_path, last)
        if os.path.isdir(path):
            raise NotImplementedError(f"{last}: Orbax checkpoints are not yet ported")
        ckpt = ckpt_io.load(path)
        state = ckpt_io.restore(ckpt, cfg, n_channels, dev)
        start_time = ckpt["start_time"]
        epoch = ckpt["epoch"] + 1
        g_losses, d_losses = list(ckpt["g_losses"]), list(ckpt["d_losses"])
        print(timelog(f"Loaded {last}", start_time))
    else:
        epoch, g_losses, d_losses = 0, [], []
        state = init_state(params.seed, n_channels, cfg, dev)

    epoch_steps = _step_mode if getattr(params, "train_mode", "epoch") == "step" else _epoch_mode
    n_batches = len(loader)
    g_total, d_total = sum(g_losses), sum(d_losses)
    stats = []
    ok = False
    try:
        while epoch < total_epochs:
            t0 = perf_counter()
            for i, d_step, g_loss in epoch_steps(state, loader, cfg, params.seed, epoch, dev):
                d_losses.extend(d_step)
                g_losses.append(g_loss)
                if i > 0 and (i % 10 == 0 or i == n_batches - 1):
                    print(timelog(f"waveform_train | {params.dir_path} | epoch "
                                  f"{epoch}/{total_epochs} | batch {i}/{n_batches}", start_time))
                    g_sum, d_sum = sum(g_losses), sum(d_losses)
                    print(f"  G Loss Diff: {g_sum - g_total}")
                    print(f"  D Loss Diff: {d_sum - d_total}")
                    g_total, d_total = g_sum, d_sum
                    if plot:
                        _plot_losses(g_losses, d_losses, epoch, total_epochs, i, n_batches,
                                     params.dir_path)
            ckpt_io.save(
                os.path.join(params.checkpoint_dir_path, f"{epoch:03d}.checkpoint"),
                start_time=start_time, epoch=epoch, g_losses=g_losses, d_losses=d_losses,
                state=state, cfg=cfg, block=not getattr(params, "checkpoint_async", False),
            )
            stats.append({"epoch": epoch, "steps": n_batches, "seconds": perf_counter() - t0})
            epoch += 1
        ok = True
    finally:
        try:
            ckpt_io.wait()
        except Exception:
            if ok:  # a dropped checkpoint fails the run; else keep the loop's error
                raise
    return {"epochs": stats}
