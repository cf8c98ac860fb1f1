from omnifusion_torch.evaluation.meters import AverageMeter, MetricAccumulator
from omnifusion_torch.evaluation.metrics import compute_depth_metrics

__all__ = ["AverageMeter", "MetricAccumulator", "compute_depth_metrics"]
