"""The march kernel B1's share of its roofline over the traced training
steps, in %.

Kernel-name map: B1 is the device kernel ``march_kernel`` (here its
checkpointing variant, launched by ``ops/march_diff.py``). Work: the
reference's ray-steps at the parameters each traced step started from,
times the operations of a forward ray-step (``benchmark.workcount``), over
the float32 peak."""

from benchmark.metrics import roofline_share

KERNELS = ("march_kernel",)
EXCLUDE = ("adjoint",)


def read(trace):
    return roofline_share(trace, KERNELS, EXCLUDE, "B1")
