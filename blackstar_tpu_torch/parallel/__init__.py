"""Sharded rendering over ``torch.distributed`` ranks, one per card (the
port of ``blackstar_tpu.parallel``; JAX's ``replicated`` and
``row_sharding`` have no counterpart, see ``parallel.mesh``)."""

from blackstar_tpu_torch.parallel.mesh import RAY_AXIS, Mesh, initialize_distributed, make_mesh
from blackstar_tpu_torch.parallel.render import render_sharded

__all__ = [
    "RAY_AXIS",
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "render_sharded",
]
