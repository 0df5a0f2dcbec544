"""blackstar_tpu_torch — the PyTorch/CUDA port of ``blackstar_tpu``, a
Schwarzschild black-hole renderer (reference: flannelhead/blackstar).

The module layout follows the JAX package, so each module has a
counterpart of the same name there. Plain tensor code is PyTorch; the two
per-ray hot stages are CUDA kernels written for Hopper (``sm_90a``), built
with ``nvcc`` at first use:

* ``ops/csrc/march.cu`` — the RK4 null-geodesic march with disk shading
  (replaces the TPU Pallas kernel ``ops/march_pallas.py::_march_kernel``);
* ``stars/csrc/star_lookup.cu`` — the per-ray star lookup.

Tensors on a CUDA device go through the kernels; tensors on the CPU through
their plain PyTorch versions, which the tests compare with the JAX package.
"""

from blackstar_tpu_torch.config import (
    Camera,
    Config,
    Scene,
    SceneParams,
    StaticConfig,
    load_config,
)
from blackstar_tpu_torch.imageio import encode_rgb8, srgb_encode, to_uint8, write_png
from blackstar_tpu_torch.render import render, render_image, render_rgb

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Config",
    "Scene",
    "SceneParams",
    "StaticConfig",
    "load_config",
    "render",
    "render_rgb",
    "render_image",
    "encode_rgb8",
    "srgb_encode",
    "to_uint8",
    "write_png",
]
