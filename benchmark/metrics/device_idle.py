"""``device_idle.<suffix>`` (%): the share of the traced window in which
no operation ran on the device (the union of the device ops' intervals
is the busy time)."""


def read(cell, out, name):
    t = out.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
