"""Command-line entry points of the port: ``python -m
ssg_tpu_torch.cli.prepare``, ``.pretraining``, ``.selftraining`` and
``.semitraining``, with the flags and defaults of the JAX package's root
scripts of the same names, the last three plus ``--device`` (``cuda``, or
``cpu`` for the plain versions). Each exposes ``build_parser()`` and ``main(argv) -> 0``."""
