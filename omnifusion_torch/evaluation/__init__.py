from omnifusion_torch.evaluation.metrics import (
    abs_rel_error,
    sq_rel_error,
    lin_rms_sq_error,
    log_rms_sq_error,
    delta_inlier_ratio,
    masked_median,
    compute_depth_metrics,
)
from omnifusion_torch.evaluation.meters import AverageMeter, MetricAccumulator
from omnifusion_torch.evaluation.chamfer import chamfer_distance, chamfer_distance_symmetric

__all__ = [
    "abs_rel_error",
    "sq_rel_error",
    "lin_rms_sq_error",
    "log_rms_sq_error",
    "delta_inlier_ratio",
    "masked_median",
    "compute_depth_metrics",
    "AverageMeter",
    "MetricAccumulator",
    "chamfer_distance",
    "chamfer_distance_symmetric",
]
