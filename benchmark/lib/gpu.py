"""The card a run measures, and the checks that refuse to measure anything
else."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "scgrhc")


class NoCard(RuntimeError):
    """The run has fewer CUDA cards than its cell asks for."""


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark measures a CUDA card "
                     "and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards and {torch.cuda.device_count()} are here")


def power_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def device_record(chips: int, on_card: bool) -> dict:
    """The result's ``device``: the card's name, the cards used and the
    peak of device memory allocated by this process."""
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def tf32(on: bool) -> None:
    """The control's precision: TF32 products in cuDNN's convolutions and in
    matmuls (on), or full float32 (off, as the program keeps them)."""
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})
