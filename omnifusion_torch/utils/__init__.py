from omnifusion_torch.utils import ply
from omnifusion_torch.utils.colorize import colorize
from omnifusion_torch.utils.iou import (
    NUM_CLASSES,
    confusion_matrix,
    evaluate_iou,
    mean_iou,
    per_class_iou,
)

__all__ = ["NUM_CLASSES", "colorize", "confusion_matrix", "evaluate_iou", "mean_iou",
           "per_class_iou", "ply"]
