"""``heads_roofline.<suffix>`` (%): the fused heads kernel's share of its
roofline in the traced window.

The bound (``bound_s``, a forward) is counted from the cell's shapes
alone, whatever implements the heads. Each pass reads the decoder's map,
batch × n_patches rows of (c, h, w), once in the trunk's type; writes pred
and conf, (rows, n_out, h, w), once in that type; and reads the heads' f32
weights and biases once. It takes 2·9·c operations an output pixel of each
output. n_out is the kind's ``pred.weight`` rows + 1 (``param_specs``),
the passes are the kind's ``passes``. The bound is the larger of the
bytes over the memory rate and the operations over the trunk's peak
(``yardstick``). The share is the bound times the traced steps over the
device time of the kernels whose name holds ``fused_heads3x3``. None where
no heads kernel ran.
"""

from benchmark import yardstick
from benchmark.reference import model as ref

KERNEL = "fused_heads3x3"


def bound_s(cfg, trunk: str, batch: int) -> float:
    """The heads' least time a forward at ``batch`` with a ``trunk`` map."""
    kind = ref.kind(cfg)
    pred = {n: s for n, s, _ in kind.param_specs(cfg)}["pred.weight"]
    n_out, c, kh, kw = pred[0] + 1, pred[1], pred[2], pred[3]
    h, w = cfg["patch_size"]
    rows = batch * cfg["n_patches"]
    n_bytes = (rows * (c + n_out) * h * w * yardstick.SIZE[trunk]
               + n_out * (c * kh * kw + 1) * 4)
    n_ops = 2.0 * kh * kw * c * n_out * rows * h * w
    one = max(n_bytes / yardstick.HBM_BYTES_PER_S, n_ops / yardstick.TRUNK_PEAK[trunk])
    return kind.passes(cfg) * one


def read(cell, out, name):
    t = out.trace
    if t is None:
        return None
    measured = sum(s for kname, s, cat in t.kernels if cat == "kernel" and KERNEL in kname)
    if measured <= 0:
        return None
    bound = bound_s(cell.config, cell.traffic["precision"]["trunk"], out.facts["batch"])
    return 100.0 * bound * t.steps / measured
