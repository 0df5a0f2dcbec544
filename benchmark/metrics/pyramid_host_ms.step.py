"""Milliseconds a step the host spent inside the program's ``fit.pyramid``
spans, over the traced steps of a pyramid fit: the host's cost of issuing
the blurred levels of ``fit.image_loss`` (their forward; autograd issues
their backward outside the span). None where the program has no such
span."""

SPAN = "fit.pyramid"


def read(trace):
    if not trace.units or not any(n == SPAN for n, _, _ in trace.host_ops):
        return None
    return 1e3 * trace.host_seconds((SPAN,)) / trace.units
