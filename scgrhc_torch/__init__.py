"""PyTorch/CUDA port of ``scgrhc`` for one NVIDIA H100.

The port imports torch, numpy and the standard library only — never JAX
and never the ``scgrhc`` package.  This slice serves: ``python -m
scgrhc_torch serve|predict`` run the windowed streaming path on CUDA,
with hand-written kernels for the generator's fused conv + instance norm
+ relu layers and for the per-window normalization.
"""
