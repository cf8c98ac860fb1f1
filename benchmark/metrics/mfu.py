"""``mfu.<suffix>`` (%): the whole step's share of the card's dense peak.

Model FLOPs per panorama (``yardstick.flops_per_panorama``: the
reference at the cell's shapes, forward for serving, forward and backward
for training) times the panoramas per second of the measured window, over
the peak of the trunk's precision (``yardstick.TRUNK_PEAK``)."""

from benchmark import yardstick


def read(cell, out, name):
    rate = out.facts.get("panos_per_s")
    if not rate:
        return None
    train = cell.traffic["mode"] == "train"
    flops = yardstick.flops_per_panorama(cell.config, out.facts["batch"], train)
    peak = yardstick.TRUNK_PEAK[cell.traffic["precision"]["trunk"]]
    return 100.0 * flops * rate / peak
