"""CLI entry point: ``python -m scgrhc_torch <dir> | all | data | train |
test | select | serve | predict | export-loaders | export | report | plots |
demo | sweep | summary ...``.

Argument handling follows ``python -m scgrhc`` (``scgrhc/pipeline/run.py``),
plus ``--device`` (default ``cuda``) for the commands that touch a device.

Over N cards, one process per card: ``torchrun --nproc-per-node=N -m
scgrhc_torch <dir>`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``).  The CLI then joins
the process group first (:func:`scgrhc_torch.parallel.comm.init_distributed`,
whose backend follows ``--device``) and leaves it on exit.  Over ranks,
``predict --continuous`` and the daemon's continuous requests run
time-sharded, and ``serve`` answers from rank 0 with every rank computing.
The host-side commands over more than one rank (``_SINGLE_RANK``) are not
yet ported and are refused.
"""

from __future__ import annotations

import os
import sys

USAGE = (
    "usage: python -m scgrhc_torch <dir> [--device D]     the pipeline: data, train,\n"
    "                                                     test valid all, select,\n"
    "                                                     test test best\n"
    "       python -m scgrhc_torch all [--device D]       the pipeline on waveform_06..33\n"
    "       python -m scgrhc_torch data <dir> [--device D]\n"
    "       python -m scgrhc_torch train <dir> [--device D]\n"
    "       python -m scgrhc_torch test <dir> <train|valid|test> <all|last|ckpt> [--device D]\n"
    "       python -m scgrhc_torch select <dir>            (host only)\n"
    "       python -m scgrhc_torch serve <dir> [ckpt|best|last] [--calibrate]\n"
    "                                [--warm N] [--timeout S] [--mesh] [--device D]\n"
    "       python -m scgrhc_torch predict <dir> <record> [ckpt|best|last]\n"
    "                                [--overlap S] [--continuous] [--calibrate]\n"
    "                                [--mesh] [--device D]\n"
    "       python -m scgrhc_torch export-loaders <dir> [out_dir]  (host only)\n"
    "       python -m scgrhc_torch export <dir> <ckpt|best|last> [out_path]  (host only)\n"
    "       python -m scgrhc_torch report [root]           (host only)\n"
    "       python -m scgrhc_torch plots <dir> <split> <ckpt|best> [n]  (host only)\n"
    "       python -m scgrhc_torch demo [workdir] [--epochs N] [--records N]\n"
    "                                [--seconds S] [--device D]\n"
    "       python -m scgrhc_torch sweep [root] [--jobs N] [--epochs E] [--seed S]\n"
    "                                [--train-mode M] [--fast] [--prune]\n"
    "                                [--inproc|--subproc] [--device D]\n"
    "       python -m scgrhc_torch summary                 (host only; SCGRHC_DATA)\n"
    "D is cuda (default) or cpu.  Over N cards: torchrun --nproc-per-node=N -m\n"
    "scgrhc_torch ...; D is then each rank's own card (or cuda:0 to share one)."
)

# subcommand: (arguments before the flags, including the subcommand)
_MIN_ARGS = {"data": 2, "train": 2, "test": 4, "select": 2, "serve": 2, "predict": 3,
             "export-loaders": 2, "export": 3, "plots": 4}


def _option(rest: list[str], flag: str, kind, default):
    if flag not in rest:
        return default
    i = rest.index(flag)
    try:
        return kind(rest[i + 1])
    except (IndexError, ValueError):
        raise SystemExit(USAGE)


def _params(dir_name: str):
    from scgrhc_torch.core.params import Params

    return Params(os.path.join(dir_name, "params.json"))


def _root_and_flags(argv: list[str], default: str) -> tuple[str, list[str]]:
    """``[<cmd>, [root], flags...]`` → (root or ``default``, flags)."""
    if len(argv) > 1 and not argv[1].startswith("--"):
        return argv[1], argv[2:]
    return default, argv[1:]


def _flags(rest: list[str], cmd: str, spec: dict) -> dict:
    """Parse ``--flag value`` and bare ``--flag`` options; ``spec`` maps a
    flag to (key, kind) for one taking a value, or to (key, constant) for a
    bare one.  An unknown flag exits, as ``scgrhc`` does."""
    out, i = {}, 0
    while i < len(rest):
        if rest[i] not in spec:
            raise SystemExit(f"unknown {cmd} flag {rest[i]}")
        key, kind = spec[rest[i]]
        if callable(kind):
            try:
                out[key] = kind(rest[i + 1])
            except (IndexError, ValueError):
                raise SystemExit(USAGE)
            i += 2
        else:
            out[key] = kind
            i += 1
    return out


_SWEEP_FLAGS = {"--jobs": ("jobs", int), "--epochs": ("total_epochs", int),
                "--seed": ("seed", int), "--train-mode": ("train_mode", str),
                "--prune": ("prune", True), "--inproc": ("inproc", True),
                "--subproc": ("inproc", False), "--fast": ("train_profile", "fast"),
                "--device": ("device", str)}
_DEMO_FLAGS = {"--epochs": ("epochs", int), "--records": ("n_records", int),
               "--seconds": ("duration_s", float), "--device": ("device", str)}


# one process each: over several ranks every rank would write the same files
_SINGLE_RANK = ("demo", "sweep", "summary", "report", "plots", "export", "export-loaders")


def _refusal(cmd: str, rest: list[str]) -> str | None:
    """What of this command line is not yet ported, or None."""
    from scgrhc_torch.parallel import comm

    if cmd in _SINGLE_RANK and comm.process_count() > 1:
        return f"{cmd} over more than one rank"
    return None


def _sweep(argv: list[str]) -> int:
    """``sweep [root] [flags]``: write the 32 configs of waveform_06..37
    under root (default ``.``) and run them all (``scgrhc/pipeline/run.py:
    50-114``).  ``train_mode`` defaults to "step" here, as in ``scgrhc``;
    ``--fast`` sets ``train_profile: "fast"``, and the in-process runner is
    the default at one job with ``--fast``."""
    from scgrhc_torch.pipeline.sweep import run_sweep
    from scgrhc_torch.utils.experiments import write_experiments

    root, rest = _root_and_flags(argv, ".")
    opts = _flags(rest, "sweep", _SWEEP_FLAGS)
    jobs, prune, device = opts.pop("jobs", 1), opts.pop("prune", False), opts.pop("device", None)
    inproc = opts.pop("inproc", None)
    overrides = {"train_mode": "step", **opts}
    if inproc is None:
        inproc = jobs <= 1 and overrides.get("train_profile") == "fast"
    dirs = write_experiments(root, **overrides)
    results = run_sweep(dirs, jobs=jobs, inproc=inproc, prune=prune, device=device)
    return 0 if all(c == 0 for c in results.values()) else 1


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd = argv[0]
    first = _MIN_ARGS.get(cmd, 1)
    if len(argv) < first or cmd.startswith("-"):
        raise SystemExit(USAGE)
    from scgrhc_torch.parallel import comm

    device = _option(argv, "--device", str, None)
    created = comm.init_distributed(device=device)
    try:
        if created and device != "cpu":
            # every rank builds (or loads) the kernels before any stage, so
            # that no rank's first build runs while another waits for it in
            # a collective
            from scgrhc_torch.ops.kernels import _build

            _build.build()
        return _main(cmd, argv, argv[first:])
    finally:
        if created:
            comm.destroy()


def _main(cmd: str, argv: list[str], rest: list[str]) -> int:
    feature = _refusal(cmd, rest)
    if feature is not None:
        raise SystemExit(f"{feature} is not yet ported to scgrhc_torch")

    if cmd == "summary":
        from scgrhc_torch.summary import main as summary_main

        summary_main()
        return 0
    if cmd == "report":
        from scgrhc_torch.pipeline import report

        report.run(argv[1] if len(argv) > 1 else ".")
        return 0
    if cmd == "demo":
        from scgrhc_torch.pipeline import demo

        workdir, rest = _root_and_flags(argv, "scgrhc_demo")
        demo.run(workdir, **_flags(rest, "demo", _DEMO_FLAGS))
        return 0
    if cmd == "sweep":
        return _sweep(argv)

    device = _option(rest, "--device", str, None)
    if cmd not in _MIN_ARGS:  # the pipeline on one dir, or the reference's `all`
        from scgrhc_torch.pipeline import run as pipeline_run

        dirs = ([f"waveform_{i:02d}" for i in range(6, 34)] if cmd == "all" else [cmd])
        for dir_name in dirs:
            pipeline_run.run(_params(dir_name), device=device)
        return 0

    params = _params(argv[1])
    which = rest[0] if rest and not rest[0].startswith("--") else "best"
    if cmd == "data":
        from scgrhc_torch.data import run as data_run

        data_run.run(params, device=device)
    elif cmd == "train":
        from scgrhc_torch.train import run as train_run

        train_run.run(params, device=device)
    elif cmd == "test":
        from scgrhc_torch.eval import run as eval_run

        eval_run.run(params, argv[2], argv[3], device=device)
    elif cmd == "select":
        from scgrhc_torch.select import run as select_run

        select_run.run(params)
    elif cmd == "export-loaders":
        # re-encode the loader files as pickled torch DataLoaders the
        # reference scripts load unchanged (reference: recordutil.py:202-224)
        from scgrhc_torch.data.torch_export import export_torch_loaders

        out_dir = rest[0] if rest and not rest[0].startswith("--") else None
        for path in export_torch_loaders(params, out_dir):
            print(f"Exported {path}")
    elif cmd == "export":
        # re-encode a checkpoint as a torch.save file for the reference's
        # tools; the default output lies OUTSIDE checkpoint_dir_path, where a
        # .torch file would shadow the real checkpoint in the reference's
        # reverse-lex resume sort (scgrhc/pipeline/run.py:142-169)
        from scgrhc_torch.pipeline.predict import resolve_checkpoint
        from scgrhc_torch.train import checkpoint as ckpt_io
        from scgrhc_torch.train import orbax_io
        from scgrhc_torch.train.wgan import TrainConfig

        name = resolve_checkpoint(params, argv[2])
        src = os.path.join(params.checkpoint_dir_path, name)
        out = rest[0] if rest and not rest[0].startswith("--") else os.path.join(
            params.dir_path, name.replace(orbax_io.ORBAX_SUFFIX, "") + ".torch")
        if orbax_io.is_orbax_checkpoint(src):  # through the reference pickle
            ref = src[: -len(orbax_io.ORBAX_SUFFIX)] + ".tmp"
            orbax_io.to_reference(src, ref, TrainConfig.from_params(params),
                                  len(params.in_channels))
            try:
                ckpt_io.export_torch(ref, out)
            finally:
                os.remove(ref)
        else:
            ckpt_io.export_torch(src, out)
        print(f"Exported {src} -> {out}")
    elif cmd == "plots":
        from scgrhc_torch.pipeline import plots
        from scgrhc_torch.pipeline.predict import resolve_checkpoint

        n = int(rest[0]) if rest and not rest[0].startswith("--") else 5
        plots.run(params, argv[2], resolve_checkpoint(params, argv[3]), n=n)
    elif cmd == "serve":
        from scgrhc_torch.pipeline import serve

        serve.run(
            params, checkpoint=which, calibrate="--calibrate" in rest,
            warm=_option(rest, "--warm", int, 0),
            timeout=_option(rest, "--timeout", float, None),
            mesh="--mesh" in rest, device=device,
        )
    else:
        from scgrhc_torch.pipeline import predict

        predict.run(
            params, argv[2], checkpoint=which,
            overlap_s=_option(rest, "--overlap", float, 0.0),
            continuous="--continuous" in rest, calibrate="--calibrate" in rest,
            mesh="--mesh" in rest, device=device,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
