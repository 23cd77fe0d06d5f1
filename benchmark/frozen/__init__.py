"""Frozen copies of the program's arithmetic that the benchmark measures
with. Each module names the file and commit it was copied from, so that a
later change to the program does not move the yardstick."""
