"""The pyramid's box blurs' share of their roofline over the traced steps
of a pyramid fit, in %.

Work: a blur is two axes, and each axis reads the image once and writes it
once. Each blur of the rendered image runs forward and, for its gradient,
backward; each blur of the target runs forward once. So the bytes are
(2 × the image's blurs + the target's blurs) × 2 axes × 2 × the image's
bytes, with the blurs the program counted over the traced job
(``fit.image_loss.pyramid_blurs``, ``fit.target_pyramid.blurs``), over
the card's memory rate. None where the program has no such counters.

Kernel-name map, read off a traced run of the cell on the card (PyTorch
2.11, CUDA 12.8): the plain blur (``ops/filters.box_blur``) is its scans
(``cumsum`` forward and the reversed scans of its backward:
``tensor_kernel_scan``, with the reversal's ``flip_kernel_impl``), its
gathers (``index_select``: ``vectorized_gather_kernel`` and
``_scatter_gather_elementwise_kernel``, one an axis) and the
scatter-adds of the gathers' backward (``index_add_``:
``indexFuncLargeIndex``, ``indexFuncSmallIndex``); and the bloom kernel B5
(``bloom_kernel``), so that a blur through B5 is read on the same work. No
kernel of a traced ``default-1080p.fit`` run carries one of these names.
The plain path's elementwise kernels (the windows' difference and scale,
the zero row of the padding and its ``cat``, the gradients' zero fills)
carry generic names that the rest of the step shares, and are left out:
the share reads high by their time."""

from benchmark.peaks import HBM_BYTES

KERNELS = ("tensor_kernel_scan", "flip_kernel_impl", "vectorized_gather_kernel",
           "_scatter_gather_elementwise_kernel", "indexFuncLargeIndex", "indexFuncSmallIndex",
           "bloom_kernel")


def read(trace):
    x = trace.extra
    if not {"pyramid_blurs", "target_blurs", "image_bytes"} <= set(x):
        return None
    seconds = trace.kernel_seconds(KERNELS)
    if not seconds:
        return None
    nbytes = (2 * x["pyramid_blurs"] + x["target_blurs"]) * 2 * 2 * x["image_bytes"]
    return 100.0 * nbytes / HBM_BYTES / seconds
