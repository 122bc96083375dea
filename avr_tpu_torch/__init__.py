"""avr_tpu_torch — the PyTorch/CUDA port of ``avr_tpu`` for NVIDIA Hopper.

Same layer layout as the JAX package (``config``, ``utils``, ``ops``,
``ops/kernels``, ``models``, ``renderers``, ``evaluation``); the hand-written
CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at first use.

This slice covers the serving path: encode a source view, then render novel
views with the adaptive renderer (forward only).  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
