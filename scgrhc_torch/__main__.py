"""CLI entry point: ``python -m scgrhc_torch train|serve|predict ...``.

Argument handling follows ``scgrhc``'s ``train``, ``serve`` and ``predict``
subcommands, plus ``--device`` (default ``cuda``).  Flags of those
subcommands that the port does not have yet are refused with a "not yet
ported" message.
"""

from __future__ import annotations

import os
import sys

USAGE = (
    "usage: python -m scgrhc_torch train <dir> [--device D]\n"
    "       python -m scgrhc_torch serve <dir> [ckpt|best|last] [--warm N]\n"
    "                                [--timeout S] [--device D]\n"
    "       python -m scgrhc_torch predict <dir> <record> [ckpt|best|last]\n"
    "                                [--overlap S] [--device D]\n"
    "D is cuda (default) or cpu."
)

_NOT_PORTED = {
    "--continuous": "the continuous mode (--continuous)",
    "--calibrate": "cohort calibration (--calibrate)",
    "--mesh": "mesh sharding (--mesh)",
}


def _option(rest: list[str], flag: str, kind, default):
    if flag not in rest:
        return default
    i = rest.index(flag)
    try:
        return kind(rest[i + 1])
    except (IndexError, ValueError):
        raise SystemExit(USAGE)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd = argv[0]
    min_args = {"train": 2, "serve": 2, "predict": 3}.get(cmd)
    if min_args is None or len(argv) < min_args:
        raise SystemExit(USAGE)
    first = 3 if cmd == "predict" else 2
    rest = argv[first:]
    for flag, feature in _NOT_PORTED.items():
        if flag in rest:
            raise SystemExit(f"{feature} is not yet ported to scgrhc_torch")
    which = rest[0] if rest and not rest[0].startswith("--") else "best"
    device = _option(rest, "--device", str, None)

    from scgrhc_torch.core.params import Params

    params = Params(os.path.join(argv[1], "params.json"))
    if cmd == "train":
        from scgrhc_torch.train import run as train_run

        train_run.run(params, device=device)
    elif cmd == "serve":
        from scgrhc_torch.pipeline import serve

        serve.run(
            params, checkpoint=which,
            warm=_option(rest, "--warm", int, 0),
            timeout=_option(rest, "--timeout", float, None),
            device=device,
        )
    else:
        from scgrhc_torch.pipeline import predict

        predict.run(
            params, argv[2], checkpoint=which,
            overlap_s=_option(rest, "--overlap", float, 0.0),
            device=device,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
