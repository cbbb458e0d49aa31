"""Checkpoint reading, the read side of ``scgrhc.train.checkpoint``.

Checkpoints are one dict per epoch at ``checkpoints/{epoch:03d}.checkpoint``
with the reference's keys (reference: waveform_train.py:401-411); model
weights are reference-layout state dicts.  :func:`load` reads both the
JAX package's native pickles and the reference's ``torch.save`` zip files.
Writing comes with the training slice.
"""

from __future__ import annotations

import os
import pickle

import torch


def is_complete_checkpoint(dirpath: str, name: str) -> bool:
    """True for entries safe to resume/evaluate from.

    Excluded: Orbax in-flight temp dirs (``*.orbax-checkpoint-tmp-*``),
    Orbax dirs whose ``meta.json`` has not landed, and side artifacts
    (``*.torch`` exports, ``*.tmp``) that shadow a real checkpoint in the
    reverse-lex sort."""
    if "orbax-checkpoint-tmp" in name:
        return False
    if name.endswith((".torch", ".tmp")):
        return False
    full = os.path.join(dirpath, name)
    if os.path.isdir(full):
        return os.path.exists(os.path.join(full, "meta.json"))
    return True


def get_last_checkpoint_path(dirpath: str) -> str | None:
    """Latest *complete* checkpoint filename, by reverse lexicographic sort
    (reference: waveform_train.py:289-296)."""
    try:
        names = sorted(os.listdir(dirpath), reverse=True)
    except OSError:
        return None
    for name in names:
        if is_complete_checkpoint(dirpath, name):
            return name
    return None


def list_checkpoints(dirpath: str) -> list[str]:
    """Sorted complete checkpoint names, deduplicated by epoch stem."""
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return []
    out, seen = [], set()
    for name in names:
        if not is_complete_checkpoint(dirpath, name):
            continue
        stem = name.split(".")[0]
        if stem in seen:
            continue
        seen.add(stem)
        out.append(name)
    return out


def load(path: str) -> dict:
    """Read a checkpoint — native pickle or reference torch.save zip.
    State dicts come back as numpy arrays in either case."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"PK":  # torch.save zipfile container
        ckpt = torch.load(path, weights_only=False, map_location="cpu")
        for k in ("g_state_dict", "d_state_dict"):
            if k in ckpt:
                ckpt[k] = {
                    kk: vv.detach().cpu().numpy() if hasattr(vv, "detach") else vv
                    for kk, vv in ckpt[k].items()
                }
        return ckpt
    with open(path, "rb") as f:
        return pickle.load(f)
