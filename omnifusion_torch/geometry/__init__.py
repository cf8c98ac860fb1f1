from omnifusion_torch.geometry import gnomonic, sphere
from omnifusion_torch.geometry.layout import PATCH_LAYOUTS, num_patches, patch_centers

__all__ = ["PATCH_LAYOUTS", "num_patches", "patch_centers", "sphere", "gnomonic"]
