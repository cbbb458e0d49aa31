"""PyTorch/CUDA port of ``scgrhc`` for one NVIDIA H100.

The port imports torch, numpy, scipy and the standard library only, never
JAX and never the ``scgrhc`` package.  ``python -m scgrhc_torch <dir>``
runs the experiment pipeline (data → train → test valid all → select →
test test best) and ``serve|predict`` the windowed streaming path, on
CUDA, with hand-written kernels for the generator's fused conv + instance
norm + relu layers, the critic's layers, the data stage's noise gate and
the per-window normalization.
"""

from scgrhc_torch.core import debug as _debug

_debug.enable_from_env()  # SCGRHC_DEBUG modes
