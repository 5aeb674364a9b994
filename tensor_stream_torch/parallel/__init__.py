"""Training beyond one batch in memory: gradient accumulation
(``accum.py``), the port of the JAX package's ``parallel`` package."""
from .accum import accumulate_gradients

__all__ = ["accumulate_gradients"]
