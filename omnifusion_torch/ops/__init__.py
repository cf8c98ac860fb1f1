"""The port's ops, exported as ``omnifusion_tpu/ops/__init__.py`` exports
them. The JAX package's ``quad_gather_blend`` (the XLA quad blend) has its
counterpart in ``omnifusion_torch.ops.quad_blend.quad_blend``, over
``BlendTables``; the name ``quad_blend`` here stays that module."""

from omnifusion_torch.ops.quad_blend import gather_blend
from omnifusion_torch.ops.splatting import splat, render, depth_distance_weights
from omnifusion_torch.ops.depth2normal import normals_cross, normals_plane_fit, depth_to_points
from omnifusion_torch.ops.gradients import dI_du, dI_dv, dI_duv, imgrad, imgrad_yx
from omnifusion_torch.ops.pano_stretch import pano_stretch
from omnifusion_torch.ops.dibr import dibr_vertical, dibr_horizontal
from omnifusion_torch.ops import derivatives

__all__ = [
    "gather_blend",
    "splat",
    "render",
    "depth_distance_weights",
    "normals_cross",
    "normals_plane_fit",
    "depth_to_points",
    "dI_du",
    "dI_dv",
    "dI_duv",
    "imgrad",
    "imgrad_yx",
    "pano_stretch",
    "dibr_vertical",
    "dibr_horizontal",
    "derivatives",
]
