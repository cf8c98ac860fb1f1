from omnifusion_torch.losses.direct import berhu_loss, l1_loss
from omnifusion_torch.losses.smoothness import guided_smoothness_loss
from omnifusion_torch.losses.ssim import ssim_gaussian, ssim_box, ssim_loss
from omnifusion_torch.losses.photometric import PhotometricLossParameters, photometric_loss

__all__ = [
    "berhu_loss",
    "l1_loss",
    "guided_smoothness_loss",
    "ssim_gaussian",
    "ssim_box",
    "ssim_loss",
    "PhotometricLossParameters",
    "photometric_loss",
]
