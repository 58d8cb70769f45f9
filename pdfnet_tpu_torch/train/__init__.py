"""Eval outputs and the eval step of the PyTorch port."""
