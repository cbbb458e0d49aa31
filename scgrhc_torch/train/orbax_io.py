"""Orbax checkpoints, the port's copy of ``scgrhc.train.orbax_io``, with no
Orbax: the on-disk layout is read and written with numpy, the standard
library and the host's libzstd.

``checkpoint_backend: "orbax"`` in params.json makes training write each
epoch as a ``NNN.checkpoint.orbax`` directory, the one ``scgrhc``'s
``StandardCheckpointer`` writes and restores:

* ``_METADATA``: the tree (``g_params``, ``d_params``, ``g_opt``, ``d_opt``)
  as JSON, one entry per leaf keyed by its path tuple; optax's
  ``(ScaleByAdamState(count, mu, nu), EmptyState())`` gives the ``0``
  entries and an ``EmptyState`` entry ``1`` with no array;
* ``array_metadatas/process_0``, ``_CHECKPOINT_METADATA``: JSON;
* ``manifest.ocdbt`` and ``d/``: an OCDBT store
  (:mod:`scgrhc_torch.train.ocdbt`) of zarr v2 arrays
  (:mod:`scgrhc_torch.train.zarr2`), one per leaf, named by the path
  joined with dots (``g_opt.0.mu.enc1.conv1.w``);
* ``meta.json``: epoch, start time and loss histories, written by
  ``scgrhc`` itself.

The weights keep PyTorch's layouts in both trees, and Adam's moments map
onto ``torch.optim.Adam``'s by registration order
(:mod:`scgrhc_torch.models.convert`), so nothing is transposed.
``_sharding`` holds JAX device strings; Orbax's restore against a target
tree does not read it, and the port does not write it.

A save writes everything into ``<name>.orbax-checkpoint-tmp-<ns>`` and
renames it, so a directory with ``meta.json`` is whole
(:func:`scgrhc_torch.train.checkpoint.is_complete_checkpoint`).  Unlike
``scgrhc``, where every process calls ``save`` and Orbax coordinates the
commit, only rank 0 writes (the training loop calls :func:`save` through
``comm.on_primary``); every rank loads.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from scgrhc_torch.models import convert
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import ocdbt, zarr2
from scgrhc_torch.train.checkpoint import ORBAX_SUFFIX, is_orbax_checkpoint  # noqa: F401 (kept names)

ITEM_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                "StandardCheckpointHandler")
_OPT_KINDS = (("g", "generator"), ("d", "critic"))


def _flatten(tree: dict, path: tuple = ()) -> list[tuple[tuple, np.ndarray | None]]:
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], path + (k,))]


def _tree(state_dicts: dict, adam: dict) -> dict:
    """The JAX state's tree, numpy leaves: ``state_dicts`` and ``adam`` map
    ``"g"``/``"d"`` to a state dict and to a torch Adam ``"state"`` (empty
    before the first step, which optax holds as count 0 and zero moments)."""
    tree = {}
    for p, kind in _OPT_KINDS:
        _, to_tree = convert.KINDS[kind]
        params = to_tree(state_dicts[p])
        if adam[p]:
            count, mu, nu = convert.adam_state_to_jax(adam[p], kind)
        else:
            zeros = {k: np.zeros_like(v) for k, v in state_dicts[p].items()}
            count, mu, nu = 0, to_tree(zeros), to_tree(zeros)
        tree[f"{p}_params"] = params
        tree[f"{p}_opt"] = {"0": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu},
                            "1": None}
    return tree


def _metadata(leaves) -> dict:
    """``_METADATA``, as Orbax writes it for this tree."""
    entries = {}
    for path, value in leaves:
        keys = [{"key": k, "key_type": 1 if k.isdigit() else 2} for k in path]
        if value is None:
            meta = {"value_type": "None", "skip_deserialize": True}
        else:
            meta = {"value_type": "jax.Array", "skip_deserialize": False,
                    "write_shape": list(value.shape)}
        entries[str(path)] = {"key_metadata": keys, "value_metadata": meta}
    return {"tree_metadata": entries, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}


def _write_dir(out: str, tree: dict, meta: dict) -> None:
    t0 = time.time_ns()
    tmp = f"{out}.orbax-checkpoint-tmp-{t0}"
    leaves = _flatten(tree)
    arrays = [(".".join(p), v) for p, v in leaves if v is not None]
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    try:
        items: dict[bytes, bytes] = {}
        for name, v in arrays:
            items.update(zarr2.encode(name, v))
        ocdbt.write(tmp, items)
        docs = {
            "_METADATA": _metadata(leaves),
            "array_metadatas/process_0": {"array_metadatas": [
                {"array_metadata": {"param_name": name, "write_shape": list(v.shape),
                                    "chunk_shape": list(v.shape), "ext_metadata": None}}
                for name, v in arrays]},
            "meta.json": meta,
            "_CHECKPOINT_METADATA": {
                "item_handlers": ITEM_HANDLER, "metrics": {}, "performance_metrics": {},
                "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                "custom_metadata": {}},
        }
        for rel, doc in docs.items():
            with open(os.path.join(tmp, rel), "w") as f:
                json.dump(doc, f)
        if os.path.exists(out):  # Orbax's force=True: the new one replaces it
            shutil.rmtree(out)
        os.replace(tmp, out)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save(path: str, *, start_time, epoch, g_losses, d_losses, state,
         block: bool = True) -> None:
    """Write ``state`` (a ``wgan.TrainState``) as the Orbax directory
    ``path + '.orbax'``.

    ``block=False`` copies the state on the device, returns, and writes it
    on a background thread; callers MUST :func:`wait` before relying on the
    directory (the training loop does at the end of its run).  The writer
    is the one :mod:`scgrhc_torch.train.checkpoint` uses: one write in
    flight, in order, and its error raised by :func:`wait`."""
    out = os.path.abspath(path) + ORBAX_SUFFIX
    meta = {"start_time": float(start_time), "epoch": int(epoch),
            "g_losses": [float(x) for x in g_losses],
            "d_losses": [float(x) for x in d_losses]}
    snap = ckpt_io.snapshot(state)

    def write():
        sds = {p: {k: v.cpu().numpy() for k, v in snap[p].items()} for p in ("g", "d")}
        adam = {p: ckpt_io.adam_state(snap[f"{p}_opt"][0]) for p in ("g", "d")}
        _write_dir(out, _tree(sds, adam), meta)

    ckpt_io.submit(write, block)


def wait() -> None:
    """Block until an in-flight save is on disk; re-raise its error."""
    ckpt_io.wait()


def _nest(arrays: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, v in arrays.items():
        *head, last = name.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def read(path: str, cfg=None) -> dict:
    """An Orbax directory → the checkpoint dict :func:`checkpoint.load`
    gives for a pickle: the scalars of ``meta.json``, both state dicts and
    both optimizers' Adam ``"state"`` (numpy), with the reference's
    ``param_groups`` when ``cfg`` (a ``wgan.TrainConfig``) is given."""
    with open(os.path.join(path, "_METADATA")) as f:
        tree_meta = json.load(f)["tree_metadata"]
    names = [".".join(k["key"] for k in e["key_metadata"]) for e in tree_meta.values()
             if e["value_metadata"]["value_type"] != "None"]
    store = ocdbt.read(path)
    tree = _nest({name: zarr2.decode(name, store) for name in names})
    with open(os.path.join(path, "meta.json")) as f:
        ckpt = json.load(f)
    for p, kind in _OPT_KINDS:
        ckpt[f"{p}_state_dict"] = convert.KINDS[kind][0](tree[f"{p}_params"])
    for p, kind in _OPT_KINDS:
        adam = tree[f"{p}_opt"]["0"]
        count = int(adam["count"])
        state = convert.adam_state_from_jax(count, adam["mu"], adam["nu"], kind) if count else {}
        sd = {"state": state}
        if cfg is not None:
            sd["param_groups"] = [ckpt_io.param_group(len(convert.param_keys(kind)), cfg)]
        ckpt[f"{p}_optimizer_state_dict"] = sd
    return ckpt


def load(path: str, cfg, in_channels: int, device=None):
    """Read an Orbax directory → ``(ckpt_dict, wgan.TrainState)`` on
    ``device``; the dict carries the reference layout's keys, so stage code
    is backend-blind."""
    p = os.path.abspath(path)
    if not p.endswith(ORBAX_SUFFIX):
        p += ORBAX_SUFFIX
    ckpt = read(p, cfg)
    return ckpt, ckpt_io.restore(ckpt, cfg, in_channels, device)


def to_reference(path: str, out_path: str, cfg, in_channels: int) -> None:
    """Orbax directory → the reference-layout pickle
    (:func:`checkpoint.save`'s file for the same state)."""
    ckpt, _ = load(path, cfg, in_channels, "cpu")
    ckpt_io.write_pickle(out_path, {"format": ckpt_io.NATIVE_TAG, **ckpt})
