"""Tensor ops of the PyTorch port; ``sa`` holds the CUDA-kernel wrappers.

The exports are those of ``pdfnet_tpu/ops/__init__.py`` that the port has:
``crop_and_resize`` belongs to the CSP family, not in the port yet.
"""

from pdfnet_tpu_torch.ops.gather import gather_feat, gather_pixels  # noqa: F401
from pdfnet_tpu_torch.ops.grouping import group_points, group_points_level2  # noqa: F401
from pdfnet_tpu_torch.ops.chebconv import cheb_basis, cheb_conv  # noqa: F401
from pdfnet_tpu_torch.ops.heatmap import (  # noqa: F401
    clamped_sigmoid, decode_centers, heatmap_nms, heatmap_topk)
from pdfnet_tpu_torch.ops.geometry import (  # noqa: F401
    backproject_depth,
    depth_normals,
    orthographic_project,
    perspective_project,
    uv_root_to_3d,
)
from pdfnet_tpu_torch.ops.fps import farthest_point_sampling  # noqa: F401
from pdfnet_tpu_torch.ops.resize import (  # noqa: F401
    resize_bilinear_align_corners, upsample2x_nearest)
