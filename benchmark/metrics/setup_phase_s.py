"""``setup_phase_s.<phase>`` (s): the host time of the program's span of
that set-up phase, summed over its instances, from the start of the run
to the end of set-up (``Context.record_setup``): ``kernels`` is the span
``kernel_library`` (the kernel library built or loaded), any other
suffix the span of its name (``tables``: the projection tables computed
or read from disk, and the blend tables made and moved to the device).
None off the card or where the span did not open."""

SPANS = {"kernels": "kernel_library"}


def read(cell, out, name):
    s = out.spans
    if s is None or not s.on_card:
        return None
    phase = name.split(".", 1)[1]
    return s.setup_s.get(SPANS.get(phase, phase))
