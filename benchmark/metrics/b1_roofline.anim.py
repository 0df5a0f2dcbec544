"""The march kernel B1's share of its roofline over the traced animation
frames (each dropped after its copy to the host), in %.

Kernel-name map: B1 is the device kernel ``march_kernel`` (the frame
variant; ``ops/csrc/march.cu``). Work: the reference's ray-steps of the
traced frames (8,294,400 rays each) times the operations of a forward
ray-step (``benchmark.workcount``), over the float32 peak."""

from benchmark.metrics import roofline_share

KERNELS = ("march_kernel",)
EXCLUDE = ("adjoint",)


def read(trace):
    return roofline_share(trace, KERNELS, EXCLUDE, "B1")
