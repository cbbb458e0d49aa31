"""Checkpoints, the port's copy of ``scgrhc.train.checkpoint``.

Checkpoints are one dict per epoch at ``checkpoints/{epoch:03d}.checkpoint``
with the reference's keys (reference: waveform_train.py:401-411): model
weights as reference-layout state dicts of numpy arrays, and each Adam
optimizer in ``torch.optim.Adam.state_dict()`` layout, parameters keyed by
registration order, ``step`` an int.  :func:`save` writes the JAX
package's native pickle (``format`` ``scgrhc-checkpoint.v1``), so
``scgrhc.train.checkpoint.load`` + ``restore_state`` read it; :func:`load`
reads those pickles and the reference's ``torch.save`` zip files.
"""

from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import torch

from scgrhc_torch.models.convert import critic_from_state_dict, generator_from_state_dict

NATIVE_TAG = "scgrhc-checkpoint.v1"


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


def _adam_layout(state: dict, n_params: int, cfg) -> dict:
    """Adam state (``Optimizer.state_dict()["state"]``) in the checkpoint
    layout: numpy moments, int step, and the reference's full param_group
    (``scgrhc/train/checkpoint.py:144-181``)."""
    group = {
        "lr": float(cfg.alpha), "betas": (float(cfg.beta1), float(cfg.beta2)),
        "eps": 1e-8, "weight_decay": 0, "amsgrad": False, "maximize": False,
        "foreach": None, "capturable": False, "differentiable": False, "fused": None,
        "params": list(range(n_params)),
    }
    return {
        "state": {
            i: {"step": int(s["step"]), "exp_avg": s["exp_avg"].cpu().numpy(),
                "exp_avg_sq": s["exp_avg_sq"].cpu().numpy()}
            for i, s in state.items()
        },
        "param_groups": [group],
    }


def _snapshot(state) -> dict:
    """Device copies of everything a checkpoint holds, taken now, so a
    background write never reads tensors the next step updates in place."""
    def opt_copy(opt):
        saved = {i: {k: v.detach().clone() for k, v in s.items()}
                 for i, s in opt.state_dict()["state"].items()}
        return saved, len(opt.param_groups[0]["params"])

    return {
        "g": {k: v.detach().clone() for k, v in state.generator.state_dict().items()},
        "d": {k: v.detach().clone() for k, v in state.critic.state_dict().items()},
        "g_opt": opt_copy(state.g_opt),
        "d_opt": opt_copy(state.d_opt),
    }


_async_thread: threading.Thread | None = None
_async_error: list = []


def wait() -> None:
    """Block until an in-flight :func:`save` (``block=False``) is on disk;
    re-raise the error it hit."""
    global _async_thread
    if _async_thread is not None:
        _async_thread.join()
        _async_thread = None
    if _async_error:
        raise _async_error.pop()


def save(path: str, *, start_time: float, epoch: int, g_losses: list, d_losses: list,
         state, cfg, block: bool = True) -> None:
    """Write the checkpoint dict of ``state`` (a ``wgan.TrainState``).

    The write is atomic (``.tmp`` then rename; :func:`is_complete_checkpoint`
    skips temps).  ``block=False`` (params key ``checkpoint_async``) copies
    the state on the device, returns, and moves it to the host and pickles
    it in a background thread; at most one write is in flight, and callers
    :func:`wait` before relying on the file.  The bytes are the same either
    way."""
    g_losses, d_losses = list(g_losses), list(d_losses)
    snap = _snapshot(state)

    def write():
        ckpt = {
            "format": NATIVE_TAG,
            "start_time": start_time,
            "epoch": epoch,
            "g_losses": g_losses,
            "d_losses": d_losses,
            "g_state_dict": {k: v.cpu().numpy() for k, v in snap["g"].items()},
            "d_state_dict": {k: v.cpu().numpy() for k, v in snap["d"].items()},
            "g_optimizer_state_dict": _adam_layout(*snap["g_opt"], cfg),
            "d_optimizer_state_dict": _adam_layout(*snap["d_opt"], cfg),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(ckpt, f)
        os.replace(tmp, path)

    wait()  # one write at a time, in order; surfaces the previous error
    if block:
        write()
        return

    def background():
        try:
            write()
        except BaseException as e:  # re-raised by wait()
            _async_error.append(e)

    global _async_thread
    _async_thread = threading.Thread(target=background, daemon=True)
    _async_thread.start()


def _load_adam(opt: torch.optim.Optimizer, sd: dict | None) -> None:
    """Adam moments of a checkpoint into ``opt`` (which keeps its own
    hyperparameters); a missing or empty state leaves it fresh."""
    if not sd or not sd.get("state"):
        return
    base = opt.state_dict()
    base["state"] = {
        int(i): {"step": torch.tensor(float(s["step"]), dtype=torch.float32),
                 "exp_avg": torch.as_tensor(np.asarray(s["exp_avg"])),
                 "exp_avg_sq": torch.as_tensor(np.asarray(s["exp_avg_sq"]))}
        for i, s in sd["state"].items()
    }
    opt.load_state_dict(base)


def restore(ckpt: dict, cfg, in_channels: int, device):
    """Checkpoint dict → ``wgan.TrainState`` (weights and Adam moments) on
    ``device``."""
    from scgrhc_torch.train.wgan import TrainState, make_optimizer

    g = generator_from_state_dict(ckpt["g_state_dict"], device)
    d = critic_from_state_dict(ckpt["d_state_dict"], device)
    if g.in_channels != in_channels:
        raise ValueError(f"checkpoint generator takes {g.in_channels} channels, "
                         f"params.json gives {in_channels}")
    g_opt, d_opt = make_optimizer(g, cfg), make_optimizer(d, cfg)
    _load_adam(g_opt, ckpt.get("g_optimizer_state_dict"))
    _load_adam(d_opt, ckpt.get("d_optimizer_state_dict"))
    return TrainState(g, d, g_opt, d_opt)
