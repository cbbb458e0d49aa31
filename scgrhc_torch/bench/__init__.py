"""The port's benchmark (``python -m scgrhc_torch.bench``, :mod:`.run`) and
the measurement scripts beside it: ``serve_envelope.py`` (the generator's
f32 envelope on a long record) and the CUDA microbenchmarks ``dw_tiles.cu``,
``conv_core.cu`` and ``gate_layouts.cu``, each with its build line in its
header.  Importing the package does no work."""
