"""Carry weights and Adam moments across from the JAX package's pytrees.

``scgrhc``'s parameter pytrees (generator ``{"enc1": {"conv1": {"w",
"b"}, ...}}``, critic ``{"conv0": {"w", "b"}, ...}``) keep PyTorch's weight
layouts, so the conversion is a relabeling into the reference state-dict
keys, with no transposes.  optax's Adam state ``(count, mu, nu)`` holds
params-shaped moment trees; ``torch.optim.Adam.state_dict()`` keys the same
moments by the parameter's registration order, which the port's modules
share with the reference (``scgrhc/train/checkpoint.py:96-127``).  This
module keeps its own copy of the key maps (from
``scgrhc/models/torch_compat.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from scgrhc_torch.models.critic import SEQ_IDX, Critic
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


def jax_params_from_state_dict(sd: dict) -> dict:
    """Reference generator state dict → the JAX generator pytree (numpy)."""
    params: dict = {}
    for name, _, _ in BLOCKS:
        params[name] = {
            conv: {"w": np.asarray(sd[f"{name}.{idx}.weight"]),
                   "b": np.asarray(sd[f"{name}.{idx}.bias"])}
            for idx, conv in ((0, "conv1"), (3, "conv2"))
        }
    for name in _ATT_NAMES:
        params[name] = {
            sub: {"w": np.asarray(sd[f"{name}.{sub}.0.weight"]),
                  "b": np.asarray(sd[f"{name}.{sub}.0.bias"])}
            for sub in ("W_x", "W_g", "psi")
        }
    for name in _UP_NAMES + ("final",):
        params[name] = {"w": np.asarray(sd[f"{name}.weight"]),
                        "b": np.asarray(sd[f"{name}.bias"])}
    return params


def critic_state_dict_from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """Critic pytree ``conv0..conv4`` → ``model.{0,2,5,8,11}.{weight,bias}``."""
    sd: dict[str, np.ndarray] = {}
    for i, idx in enumerate(SEQ_IDX):
        sd[f"model.{idx}.weight"] = np.asarray(params[f"conv{i}"]["w"])
        sd[f"model.{idx}.bias"] = np.asarray(params[f"conv{i}"]["b"])
    return sd


def critic_jax_params_from_state_dict(sd: dict) -> dict:
    return {
        f"conv{i}": {"w": np.asarray(sd[f"model.{idx}.weight"]),
                     "b": np.asarray(sd[f"model.{idx}.bias"])}
        for i, idx in enumerate(SEQ_IDX)
    }


def critic_from_state_dict(sd: dict, device=None) -> Critic:
    """A reference-layout critic state dict → Critic with those weights."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    w = tensors["model.0.weight"]
    c = Critic(w.shape[1] - 1, dtype=w.dtype)
    c.load_state_dict(tensors)
    return c.to(device) if device is not None else c


def critic_from_jax_params(params: dict, device=None) -> Critic:
    return critic_from_state_dict(critic_state_dict_from_jax_params(params), device)


_KINDS = {
    "generator": (state_dict_from_jax_params, jax_params_from_state_dict),
    "critic": (critic_state_dict_from_jax_params, critic_jax_params_from_state_dict),
}


def param_keys(kind: str) -> list[str]:
    """State-dict keys of ``kind`` ("generator" or "critic") in parameter
    registration order: torch Adam's state ids."""
    wb = ("weight", "bias")
    if kind == "critic":
        return [f"model.{idx}.{p}" for idx in SEQ_IDX for p in wb]
    return (
        [f"{name}.{idx}.{p}" for name, _, _ in BLOCKS for idx in (0, 3) for p in wb]
        + [f"{name}.{sub}.0.{p}" for name in _ATT_NAMES for sub in ("W_x", "W_g", "psi")
           for p in wb]
        + [f"{name}.{p}" for name in _UP_NAMES + ("final",) for p in wb]
    )


def adam_state_from_jax(count: int, mu: dict, nu: dict, kind: str) -> dict:
    """optax Adam ``(count, mu, nu)`` of the ``kind`` pytree → the
    ``"state"`` of a torch Adam state dict, keyed by registration order,
    numpy moments."""
    to_sd, _ = _KINDS[kind]
    mu_sd, nu_sd = to_sd(mu), to_sd(nu)
    return {
        i: {"step": int(count), "exp_avg": mu_sd[key], "exp_avg_sq": nu_sd[key]}
        for i, key in enumerate(param_keys(kind))
    }


def adam_state_to_jax(state: dict, kind: str) -> tuple[int, dict, dict]:
    """The ``"state"`` of a torch-layout Adam state dict → optax's
    ``(count, mu, nu)`` with numpy pytrees."""
    _, from_sd = _KINDS[kind]
    keys = param_keys(kind)
    mu = {key: np.asarray(state[i]["exp_avg"]) for i, key in enumerate(keys)}
    nu = {key: np.asarray(state[i]["exp_avg_sq"]) for i, key in enumerate(keys)}
    return int(state[0]["step"]), from_sd(mu), from_sd(nu)
