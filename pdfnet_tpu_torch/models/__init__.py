"""Modules of the PyTorch port (NCHW inside, JAX layouts at the edges)."""
