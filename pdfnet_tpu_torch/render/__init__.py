"""Triangle rasterizer and spherical-harmonics lighting of the two hand
meshes (port of ``pdfnet_tpu/render``), in plain PyTorch: the JAX package
has no Pallas kernel here."""

from pdfnet_tpu_torch.render.lighting import sh_illumination  # noqa: F401
from pdfnet_tpu_torch.render.rasterizer import (  # noqa: F401
    SKIN_COLOR, rasterize_mesh, render_two_hands, shade_vertex_colors)
