"""The adjoint kernel B2's share of its roofline over the traced training
steps, in %.

Kernel-name map: B2 is the device kernel ``march_adjoint_kernel``
(``ops/csrc/march_adjoint.cu``). Work: the reference's ray-steps at the
parameters each traced step started from (B2 reverses each of them), times
the operations of a reversed ray-step, the RK4 step replayed and its
vector-Jacobian product (``benchmark.workcount``), over the float32 peak."""

from benchmark.metrics import roofline_share

KERNELS = ("march_adjoint_kernel",)
EXCLUDE = ()


def read(trace):
    return roofline_share(trace, KERNELS, EXCLUDE, "B2")
