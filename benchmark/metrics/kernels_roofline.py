"""``kernels_roofline.<suffix>`` (%): the hand kernels' share of their
roofline in the traced window.

The sum of the bounds (``yardstick.kernel_bounds``, per forward or train
step, times the steps traced) of each kernel family that ran, over the
device time of that family's kernels, found by name in the trace. None
when no hand kernel ran."""

from benchmark import yardstick


def read(cell, out, name):
    t = out.trace
    if t is None:
        return None
    measured = {k: 0.0 for k in yardstick.KERNELS}
    for kname, s, cat in t.kernels:
        for fam, sub in yardstick.KERNELS.items():
            if cat == "kernel" and sub in kname and not (fam == "up2x" and "adjoint" in kname):
                measured[fam] += s
    bounds = yardstick.kernel_bounds(cell.config, cell.traffic["precision"], out.facts["batch"],
                                     cell.traffic["mode"] == "train")
    ran = [f for f, s in measured.items() if s > 0]
    if not ran:
        return None
    return 100.0 * sum(bounds[f] for f in ran) * t.steps / sum(measured[f] for f in ran)
