"""MANO hand model of the PyTorch port."""
