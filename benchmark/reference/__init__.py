"""Plain PyTorch references that the program's outputs are judged against.
They import neither ``jax`` nor ``ssg_tpu`` nor anything of
``ssg_tpu_torch``, and take no weights, tables or state the program made."""
