"""Evaluation on the host (numpy/scipy): chamfer, ICP alignment and the
evaluate function, the JAX package's ``eval/``."""
