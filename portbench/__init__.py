"""The port's benchmark: one cell of robseg_torch run once by ``run.py``."""
