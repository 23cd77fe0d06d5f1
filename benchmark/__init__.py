"""The benchmark of ``ssg_tpu_torch`` on NVIDIA GPUs.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits in
a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (parameters read by the general runner
``kinds/<kind>.py`` that the mix names), ``limits/<cell>.json`` (the limits
of the comparison that decides ``correct``) and ``metrics/<metric>.py`` (a
reader of the traced slice). ``frozen/`` holds copies of what the benchmark
needs from the program, ``reference/`` the plain PyTorch reference that the
program's outputs are judged against; neither imports the program.
"""
