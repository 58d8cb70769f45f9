"""Modules of the PyTorch port (NCHW inside, JAX layouts at the edges)."""

from pdfnet_tpu_torch.models.handnet import HandNet, build_model  # noqa: F401
from pdfnet_tpu_torch.models.csp import CSPNet, build_csp_model  # noqa: F401
