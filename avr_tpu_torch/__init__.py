"""avr_tpu_torch — the PyTorch/CUDA port of ``avr_tpu`` for NVIDIA Hopper.

Same layer layout as the JAX package (``config``, ``utils``, ``ops``,
``ops/kernels``, ``models``, ``renderers``, ``evaluation``, ``training``);
the hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
at first use.

Two paths are ported: serving (encode a source view, then render novel
views with the adaptive renderer) and the training step (encode, render,
loss, gradients through the kernels' backwards, Adam).  Entry points run on
the card unless the caller passes ``device="cpu"`` or CPU tensors.
"""
