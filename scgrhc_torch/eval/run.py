"""Evaluation stage, the port's copy of ``scgrhc.eval.run`` (reference
parity: waveform_test.py:96-162).

The reference's contract: the checkpoint list ('all' → the sorted
checkpoints cut to ``total_epochs``, 'last', or an explicit name);
checkpoints that already have a comparison CSV are skipped; each scored
checkpoint gets ``comparisons/<split>/<ckpt>.csv`` with one row per segment
(denormalized real and predicted waveforms as stringified lists, PCC with
its Fisher-z CI, RMSE with its t-CI), sorted by ``pcc_r`` descending.  The
CSVs are written with the standard library, byte for byte as pandas'
``to_csv(index=False)`` writes them (floats as ``repr``, NaN as an empty
field).

The split is scored on the device in chunks of ``eval_batch`` windows
(:mod:`scgrhc_torch.eval.infer`), in the params' ``dtype`` (``"int8"``
through :class:`scgrhc_torch.models.quant.QuantGenerator`), one
checkpoint after another; a background thread loads the next
checkpoint from disk while the current one runs.  ``eval_stack`` is
accepted and ignored: ``scgrhc`` stacks checkpoints under ``vmap``, which
cannot pass through K1f's ctypes launch, so in the port a stack would be
the same per-checkpoint forwards in a loop, the serial path's bits.

``channel_bucket`` and ``shape_bucket`` are read and ignored, as in
training (:mod:`scgrhc_torch.train.run`): they pad to fixed shapes so that
XLA's programs are shared, and the port's kernels need no fixed shapes.
Checkpoints of either backend are scored, once per epoch in a directory
that holds both (:func:`scgrhc_torch.train.checkpoint.list_checkpoints`).

Under a process group of N > 1 ranks each chunk is split over the ranks
(:func:`scgrhc_torch.eval.infer.predict_split` with the data mesh), as
``scgrhc`` shards evaluation over its devices, and only rank 0 writes the
comparison CSVs; every rank waits for each write and fails with it
(:func:`scgrhc_torch.parallel.comm.on_primary`).
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from time import time

import torch

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.core.trace import trace
from scgrhc_torch.data.loaders import load_dataloader
from scgrhc_torch.eval.infer import predict_split
from scgrhc_torch.models.convert import generator_from_state_dict
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import make_mesh
from scgrhc_torch.pipeline.predict import resolve_checkpoint
from scgrhc_torch.train import checkpoint as ckpt_io

CSV_COLUMNS = [
    "filename", "start_idx", "stop_idx", "real_rhc", "pred_rhc",
    "pcc_r", "pcc_ci95_lower", "pcc_ci95_upper",
    "rmse", "rmse_ci95_lower", "rmse_ci95_upper",
]


def _csv_field(v) -> str:
    if isinstance(v, float):
        return "" if v != v else repr(v)
    return str(v)


def write_csv(path: str, columns: list[str], rows: list[dict]) -> None:
    """``pd.DataFrame(rows, columns=columns).to_csv(path, index=False)``'s
    bytes: a header line, minimal quoting, ``\\n`` line ends, floats as
    ``repr`` and NaN as an empty field."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_csv_field(row[c]) for c in columns])


def get_processed_checkpoints(comp_dir_path: str) -> frozenset:
    """Checkpoints already scored in this directory
    (reference: waveform_test.py:89-93)."""
    return frozenset(
        f"{filename.split('.')[0]}.checkpoint" for filename in os.listdir(comp_dir_path)
    )


def _comparison_rows(store, real, pred, scores) -> list[dict]:
    """(real, pred, scores) arrays → per-segment comparison rows
    (reference row schema: waveform_test.py:72-85)."""
    return [
        {
            "filename": store.record_names[i],
            "start_idx": int(store.start_idx[i]),
            "stop_idx": int(store.stop_idx[i]),
            "real_rhc": str(real[i].tolist()),
            "pred_rhc": str(pred[i].tolist()),
            **{k: float(scores[k][i]) for k in CSV_COLUMNS[5:]},
        }
        for i in range(len(store))
    ]


def _write_comparison_csv(store, real, pred, scores, comp_dir_path, ckpt_name) -> None:
    comparisons = _comparison_rows(store, real, pred, scores)
    comparisons.sort(key=lambda c: c["pcc_r"], reverse=True)
    path = os.path.join(comp_dir_path, f"{ckpt_name.split('.')[0]}.csv")
    write_csv(path, CSV_COLUMNS, comparisons)


def _load_generator(params, ckpt_name):
    """A checkpoint's generator on the CPU (the load-ahead thread's part),
    from a pickle or an Orbax directory."""
    full = os.path.join(params.checkpoint_dir_path, resolve_checkpoint(params, ckpt_name))
    return generator_from_state_dict(ckpt_io.load(full)["g_state_dict"])


def _to_device(gen, params, dev):
    """The generator on ``dev`` in the params' inference dtype: bfloat16
    casts in place, int8 returns the quantized module (``Generator.cast``)."""
    gen = gen.to(dev).eval()
    if params.dtype != "float32":
        gen = gen.cast(getattr(torch, params.dtype))
    return gen


def run(params, loader_type: str, checkpoint_path: str, device=None) -> None:
    start_time = time()
    checkpoint_message = f"{checkpoint_path if checkpoint_path else 'last checkpoint'}"
    print(timelog(f"Run waveform_test for {params.dir_path} | {loader_type} | "
                  f"{checkpoint_message}", start_time))
    comm.refuse_lone_rank()
    dev = resolve_device(device)
    mesh = make_mesh()

    if loader_type == "train":
        loader_path = params.train_path
    elif loader_type == "valid":
        loader_path = params.valid_path
    elif loader_type == "test":
        loader_path = params.test_path
    else:
        raise Exception("Invalid loader type")
    store = load_dataloader(loader_path).dataset

    if checkpoint_path == "all":
        checkpoint_paths = ckpt_io.list_checkpoints(params.checkpoint_dir_path)[
            : params.total_epochs
        ]
    elif checkpoint_path == "last":
        checkpoint_paths = [ckpt_io.get_last_checkpoint_path(params.checkpoint_dir_path)]
    else:
        checkpoint_paths = [checkpoint_path]

    comp_dir_path = os.path.join(params.comparison_dir_path, loader_type)
    os.makedirs(comp_dir_path, exist_ok=True)
    processed = get_processed_checkpoints(comp_dir_path)

    def is_processed(name: str) -> bool:
        return f"{name.split('.')[0]}.checkpoint" in processed

    todo = [name for name in checkpoint_paths if not is_processed(name)]

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(_load_generator, params, todo[0]) if todo else None
        next_todo = 1
        try:
            for i, ckpt_name in enumerate(checkpoint_paths):
                # the reference prints i/len over ALL checkpoints, processed
                # ones included (waveform_test.py:138-140)
                print(timelog(f"waveform_test | {params.dir_path} | {loader_type} | "
                              f"{checkpoint_message} | {i}/{len(checkpoint_paths)}",
                              start_time))
                if is_processed(ckpt_name):
                    continue
                gen = _to_device(pending.result(), params, dev)
                pending = (pool.submit(_load_generator, params, todo[next_todo])
                           if next_todo < len(todo) else None)
                next_todo += 1
                with trace(f"eval_{loader_type}", device=dev):
                    real, pred, scores = predict_split(gen, store, batch=params.eval_batch,
                                                       mesh=mesh)
                    # one writer; select reads the CSVs next
                    comm.on_primary("test_csv", _write_comparison_csv, store, real, pred,
                                    scores, comp_dir_path, ckpt_name)
        finally:
            if pending is not None:
                pending.cancel()
    comm.barrier("test_end")

