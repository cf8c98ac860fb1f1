"""``trunk_ms.<suffix>`` (ms/batch): device time per batch of every
kernel but the hand kernels (the trunk on cuDNN and cuBLAS, the
elementwise work around it), memory copies and sets left out."""

from benchmark import yardstick


def read(cell, out, name):
    t = out.trace
    if t is None:
        return None
    s = sum(d for kname, d, cat in t.kernels
            if cat == "kernel" and not any(sub in kname for sub in yardstick.KERNELS.values()))
    return 1e3 * s / t.steps if s > 0 else None
