"""``device_ms.<span>`` (ms a step): the device time of the operations
launched while the program's span ``<span>`` was open on the stepping
thread, inclusive of the spans inside it, a step of the mode (a batch, a
train step), from the profiled window of ``harness.span_window``. None
off the card or where the span did not open."""


def read(cell, out, name):
    s = out.spans
    if s is None or not s.on_card:
        return None
    return s.device_ms.get(name.split(".", 1)[1])
