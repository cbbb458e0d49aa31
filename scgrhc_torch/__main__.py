"""CLI entry point: ``python -m scgrhc_torch <dir> | all | data | train |
test | select | serve | predict ...``.

Argument handling follows ``python -m scgrhc`` (``scgrhc/pipeline/run.py``),
plus ``--device`` (default ``cuda``).  Subcommands and flags of ``scgrhc``
that the port does not have yet are refused with a "not yet ported"
message.
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
    "                                [--warm N] [--timeout S] [--device D]\n"
    "       python -m scgrhc_torch predict <dir> <record> [ckpt|best|last]\n"
    "                                [--overlap S] [--continuous] [--calibrate]\n"
    "                                [--device D]\n"
    "       python -m scgrhc_torch export-loaders <dir> [out_dir]  (host only)\n"
    "D is cuda (default) or cpu.  Not yet ported: sweep, report, plots, demo,\n"
    "export, summary."
)

_NOT_PORTED = {"--mesh": "mesh sharding (--mesh)"}
_NOT_PORTED_COMMANDS = ("sweep", "report", "plots", "demo", "export", "summary")
# subcommand: (arguments before the flags, including the subcommand)
_MIN_ARGS = {"data": 2, "train": 2, "test": 4, "select": 2, "serve": 2, "predict": 3,
             "export-loaders": 2}


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


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd = argv[0]
    if cmd in _NOT_PORTED_COMMANDS:
        raise SystemExit(f"the {cmd} subcommand is not yet ported to scgrhc_torch")
    first = _MIN_ARGS.get(cmd, 1)
    if len(argv) < first or cmd.startswith("-"):
        raise SystemExit(USAGE)
    rest = argv[first:]
    for flag, feature in _NOT_PORTED.items():
        if flag in rest:
            raise SystemExit(f"{feature} is not yet ported to scgrhc_torch")
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
    elif cmd == "serve":
        from scgrhc_torch.pipeline import serve

        serve.run(
            params, checkpoint=which, calibrate="--calibrate" in rest,
            warm=_option(rest, "--warm", int, 0),
            timeout=_option(rest, "--timeout", float, None),
            device=device,
        )
    else:
        from scgrhc_torch.pipeline import predict

        predict.run(
            params, argv[2], checkpoint=which,
            overlap_s=_option(rest, "--overlap", float, 0.0),
            continuous="--continuous" in rest, calibrate="--calibrate" in rest,
            device=device,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
