"""``host_ms.<span>`` (ms a step): the host time of the program's span
``<span>``, summed over its instances, a step of the mode, from the
window of ``harness.span_window`` that records the spans without a
profiler. None off the card or where the span did not open."""


def read(cell, out, name):
    s = out.spans
    if s is None or not s.on_card:
        return None
    return s.host_ms.get(name.split(".", 1)[1])
