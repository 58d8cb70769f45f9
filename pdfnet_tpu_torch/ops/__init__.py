"""Tensor ops of the PyTorch port; ``sa`` holds the CUDA-kernel wrappers."""
