"""Carry generator weights across from the JAX package's pytree layout.

``scgrhc``'s generator pytree (``{"enc1": {"conv1": {"w", "b"}, ...}}``)
keeps PyTorch's weight layouts, so the conversion is a relabeling into the
reference state-dict keys, with no transposes.  This module keeps its own
copy of that key map.
"""

from __future__ import annotations

import numpy as np
import torch

from scgrhc_torch.models.generator import BLOCKS, Generator

_ATT_NAMES = ("att3", "att2", "att1")
_UP_NAMES = ("up3", "up2", "up1")


def state_dict_from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """Generator pytree (numpy leaves) → reference state-dict layout."""
    sd: dict[str, np.ndarray] = {}
    for name, _, _ in BLOCKS:
        for idx, conv in ((0, "conv1"), (3, "conv2")):
            sd[f"{name}.{idx}.weight"] = np.asarray(params[name][conv]["w"])
            sd[f"{name}.{idx}.bias"] = np.asarray(params[name][conv]["b"])
    for name in _ATT_NAMES:
        for sub in ("W_x", "W_g", "psi"):
            sd[f"{name}.{sub}.0.weight"] = np.asarray(params[name][sub]["w"])
            sd[f"{name}.{sub}.0.bias"] = np.asarray(params[name][sub]["b"])
    for name in _UP_NAMES + ("final",):
        sd[f"{name}.weight"] = np.asarray(params[name]["w"])
        sd[f"{name}.bias"] = np.asarray(params[name]["b"])
    return sd


def generator_from_state_dict(sd: dict, device=None) -> Generator:
    """A reference-layout state dict (numpy arrays or tensors) → Generator
    with those exact weights, in their dtype, on ``device``."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    w = tensors["enc1.0.weight"]
    g = Generator(w.shape[1], dtype=w.dtype)
    g.load_state_dict(tensors)
    return g.to(device) if device is not None else g


def generator_from_jax_params(params: dict, device=None) -> Generator:
    """The JAX generator pytree, as numpy arrays
    (``jax.tree.map(np.asarray, scgrhc.models.generator.init(...))``) →
    Generator with the same weights."""
    return generator_from_state_dict(state_dict_from_jax_params(params), device)
