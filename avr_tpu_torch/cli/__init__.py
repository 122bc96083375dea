"""Command-line entry points of the port (ports of ``avr_tpu/cli``):
``python -m avr_tpu_torch.cli.train``, ``.test`` and ``.video``, with the JAX
CLIs' flags and defaults.  Each runs on the card; ``main(argv, device=...)``
and ``run(opt, device=...)`` take ``device="cpu"`` for the host."""
