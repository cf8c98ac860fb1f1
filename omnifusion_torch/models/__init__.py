from omnifusion_torch.models.spherical_fusion import (
    DepthTrunk,
    MlpPoints,
    SphericalFusion,
    confidence_merge,
    init_weights,
)
from omnifusion_torch.models.convert import state_dict_from_jax
from omnifusion_torch.models.iterative import SphericalFusionIterative
from omnifusion_torch.models.resnet import ResNet34Encoder
from omnifusion_torch.models.segmentation import SphericalFusionSeg, cross_entropy_ignore
from omnifusion_torch.models.transformer import TransformerCascade

__all__ = [
    "SphericalFusion",
    "SphericalFusionIterative",
    "SphericalFusionSeg",
    "cross_entropy_ignore",
    "DepthTrunk",
    "MlpPoints",
    "confidence_merge",
    "init_weights",
    "state_dict_from_jax",
    "ResNet34Encoder",
    "TransformerCascade",
]
