"""Measurements of the port's kernels on the card, beside ``chip_smoke.py``."""
