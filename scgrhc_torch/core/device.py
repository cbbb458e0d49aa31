"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Without a
CUDA device the default raises; it never falls back to the CPU, where the
kernels' plain versions would run in their place.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  On CUDA, TF32 is switched off for cuDNN
    convolutions and matmuls, so the plain f32 ops that stay on the path
    (the attention 1×1 convs, ``up*``, ``final``) run in full f32 like the
    kernels (PyTorch's cuDNN default is TF32, about three decimal digits)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scgrhc_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
