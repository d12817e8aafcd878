"""Frozen copies of what the benchmark takes from the repository.

Each module names the file and commit it was copied from.  Later
changes to those files do not move the yardstick: the benchmark reads
only these copies.
"""
