"""Measurement scripts for the port's kernels on the card."""
