"""Host-side metric accumulation (parity: AverageMeter, test.py:120-147).

A copy of ``omnifusion_tpu/evaluation/meters.py``, which imports nothing of
JAX; the port keeps its own."""

from __future__ import annotations


class AverageMeter:
    """Weighted running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        val = float(val)
        n = float(n)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0

    def to_dict(self):
        return {"val": self.val, "sum": self.sum, "count": self.count, "avg": self.avg}

    def from_dict(self, d):
        self.val = d["val"]
        self.sum = d["sum"]
        self.count = d["count"]
        self.avg = self.sum / self.count if self.count else 0.0


class MetricAccumulator:
    """A dict of AverageMeters keyed by metric name."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    def update(self, metrics: dict, n=1):
        for k, v in metrics.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()
