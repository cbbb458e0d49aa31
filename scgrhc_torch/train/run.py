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

The keys of ``train_profile: "fast"`` that ``scgrhc`` needs for XLA are
read and change nothing here, so a run trains and saves what it does with
them off:

  * ``channel_bucket`` and ``shape_bucket`` pad the SCG channels to 4 and
    a short batch (and the epoch scan's rows) to fixed sizes so that the
    sweep's configs share compiled XLA programs.  The port launches its
    kernels at any shape and has no programs to share, so padding would
    only add work.
  * ``rng_impl`` (``"threefry"``, ``"rbg"``, ``"unsafe_rbg"``) picks JAX's
    generator in ``scgrhc``.  The port draws from ``torch.Generator``
    under every impl: draws cannot match across frameworks anyway.

Data parallelism: under a process group of N ranks
(:mod:`scgrhc_torch.parallel.comm`) every rank trains its block of each
batch (:mod:`scgrhc_torch.parallel.dp`), as ``scgrhc`` does on more than
one device with no setting at all.  In epoch mode the split is on every
rank's card whole and each rank gathers its block of the batch's indices;
in step mode it takes its block of the host batch.  A batch (the tail
batch too) that does not divide N is padded with masked rows
(:func:`scgrhc_torch.parallel.mesh.pad_idx_mask`).  The replicas start
from rank 0's state; only rank 0 prints the progress lines and writes the
checkpoints and ``train_losses.png``, and every rank waits for each write
and fails with it (:func:`scgrhc_torch.parallel.comm.on_primary`).  A
resume reads the checkpoint on every rank.

``checkpoint_backend: "orbax"`` writes each epoch as an Orbax directory
``{epoch:03d}.checkpoint.orbax`` (:mod:`scgrhc_torch.train.orbax_io`),
in the background as ``scgrhc`` does, and a resume reads the latest
checkpoint of either backend.  ``plot_async`` is read for compatibility
only.
"""

from __future__ import annotations

import os
from time import perf_counter, time

import torch

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.core.trace import annotate, trace
from scgrhc_torch.data.loaders import load_dataloader
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.dp import DataParallelTrainer
from scgrhc_torch.parallel.mesh import make_mesh
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import orbax_io
from scgrhc_torch.train.wgan import TrainConfig, init_state, step_rng


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


RNG_IMPLS = ("threefry", "rbg", "unsafe_rbg")


def _check_rng_impl(params) -> None:
    if getattr(params, "rng_impl", "threefry") not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got {params.rng_impl!r}")


def _step_mode(trainer, state, loader, cfg, seed, epoch, device):
    for i, (scg, rhc) in enumerate(loader.batches(epoch)):
        d, g = trainer.step(state, torch.from_numpy(scg).to(device),
                            torch.from_numpy(rhc).to(device),
                            torch.arange(len(scg), device=device),
                            step_rng(seed, epoch, i, device), cfg)
        with annotate("losses_read_back"):
            d_list, g_loss = d.tolist(), float(g)
        yield i, d_list, g_loss


def _epoch_mode(trainer, state, loader, cfg, seed, epoch, device):
    scg_all, rhc_all = loader.dataset.device_arrays(device)
    order = torch.from_numpy(loader.epoch_order(epoch)).to(device)
    bs = loader.batch_size
    losses = []
    with annotate("train_epoch"):
        for i, s in enumerate(range(0, len(order), bs)):
            d, g = trainer.step(state, scg_all, rhc_all, order[s:s + bs],
                                step_rng(seed, epoch, i, device), cfg)
            losses.append(torch.cat((d, g[None])))
        with annotate("losses_read_back"):
            rows = torch.stack(losses).tolist() if losses else []
    for i, row in enumerate(rows):
        yield i, row[:-1], row[-1]


def run(params, device=None, plot: bool = True) -> dict:
    """Train ``params``' experiment on ``device`` (default CUDA) from its
    last complete checkpoint to ``total_epochs``.  Returns
    ``{"epochs": [{"epoch", "steps", "seconds"}, ...]}`` for the epochs run
    (seconds on the host clock, checkpoint write included)."""
    comm.refuse_lone_rank()
    dev = resolve_device(device)
    _check_rng_impl(params)
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
        ckpt = ckpt_io.load(path)  # a pickle or an .orbax dir
        state = ckpt_io.restore(ckpt, cfg, n_channels, dev)
        start_time = ckpt["start_time"]
        epoch = ckpt["epoch"] + 1
        g_losses, d_losses = list(ckpt["g_losses"]), list(ckpt["d_losses"])
        print(timelog(f"Loaded {last}", start_time))
    else:
        epoch, g_losses, d_losses = 0, [], []
        state = init_state(params.seed, n_channels, cfg, dev)
    trainer = DataParallelTrainer(make_mesh())
    trainer.place_state(state)
    primary = comm.is_primary()
    orbax = getattr(params, "checkpoint_backend", "reference") == "orbax"

    epoch_steps = _step_mode if getattr(params, "train_mode", "epoch") == "step" else _epoch_mode
    n_batches = len(loader)
    g_total, d_total = sum(g_losses), sum(d_losses)
    stats = []
    try:
        with trace("train", device=dev):
            while epoch < total_epochs:
                t0 = perf_counter()
                for i, d_step, g_loss in epoch_steps(trainer, state, loader, cfg, params.seed,
                                                     epoch, dev):
                    d_losses.extend(d_step)
                    g_losses.append(g_loss)
                    if primary and i > 0 and (i % 10 == 0 or i == n_batches - 1):
                        print(timelog(f"waveform_train | {params.dir_path} | epoch "
                                      f"{epoch}/{total_epochs} | batch {i}/{n_batches}",
                                      start_time))
                        g_sum, d_sum = sum(g_losses), sum(d_losses)
                        print(f"  G Loss Diff: {g_sum - g_total}")
                        print(f"  D Loss Diff: {d_sum - d_total}")
                        g_total, d_total = g_sum, d_sum
                        if plot:
                            _plot_losses(g_losses, d_losses, epoch, total_epochs, i, n_batches,
                                         params.dir_path)
                path = os.path.join(params.checkpoint_dir_path, f"{epoch:03d}.checkpoint")
                with annotate("checkpoint_save"):
                    if orbax:  # the write overlaps the next epoch, as in scgrhc
                        comm.on_primary("train_checkpoint", orbax_io.save, path,
                                        start_time=start_time, epoch=epoch, g_losses=g_losses,
                                        d_losses=d_losses, state=state, block=False)
                    else:
                        comm.on_primary("train_checkpoint", ckpt_io.save, path,
                                        start_time=start_time, epoch=epoch, g_losses=g_losses,
                                        d_losses=d_losses, state=state, cfg=cfg,
                                        block=not getattr(params, "checkpoint_async", False))
                stats.append({"epoch": epoch, "steps": n_batches, "seconds": perf_counter() - t0})
                epoch += 1
        # a dropped checkpoint fails the run, on every rank
        comm.on_primary("train_end", ckpt_io.wait)
    finally:
        try:
            ckpt_io.wait()
        except Exception:
            pass  # the failure path: drained, and the loop's own error is kept
    return {"epochs": stats}
