"""Drivers, one a traffic kind: ``run(cell, seed, seconds, trace, device)``."""
