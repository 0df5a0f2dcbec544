"""Process groups for the sharded renderer: one process per card.

The port of ``blackstar_tpu/parallel/mesh.py``. The JAX package lays a 1-D
``('rays',)`` mesh over every device that its processes see; here each
process drives one device and ``torch.distributed`` joins the processes:
NCCL for CUDA tensors, gloo for CPU tensors. Forward rendering is
embarrassingly parallel over pixels, so the only traffic is the image
gather at the end of a frame and, in a fit, one all-reduce of the
parameter gradients.

Launch one process per card with ``torchrun``::

    torchrun --nproc-per-node 4 -m blackstar_tpu_torch render SCENE.yaml --sharded

JAX's ``replicated`` and ``row_sharding`` are placements of arrays on a
mesh. The port places no tensor by a placement: every rank holds the
replicated scene parameters and star tables as ordinary tensors, makes its
own rays, and the gather hands every rank the whole image, so they have no
counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

RAY_AXIS = "rays"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D ``RAY_AXIS`` mesh over the ranks of the default group: this
    rank's index, the number of ranks, and this rank's device."""

    rank: int
    size: int
    device: torch.device


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda`` means the card ``cuda:LOCAL_RANK`` (0
    without ``torchrun``); an explicit index or ``cpu`` is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None, *,
                           device="cuda") -> None:
    """Join this process to the default process group.

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); outside ``torchrun``,
    and with no ``init_method``, the group is this process alone (an
    in-memory store). The backend follows ``device``: ``nccl`` for a CUDA
    device, ``gloo`` for the CPU; an explicit ``backend`` wins. A backend
    that fails to start raises; no other backend or device is tried.
    """
    dev = rank_device(device)
    if backend is None:
        if dev.type not in BACKENDS:
            raise ValueError(f"initialize_distributed: no backend for device {dev}")
        backend = BACKENDS[dev.type]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None and not _torchrun_env():
        if world_size not in (None, 1) or rank not in (None, 0):
            raise ValueError("initialize_distributed: ranks beyond one need torchrun's "
                             "environment or an init_method")
        kwargs = dict(store=dist.HashStore(), world_size=1, rank=0)
    else:
        kwargs = dict(init_method=init_method)
        if world_size is not None:
            kwargs["world_size"] = world_size
        if rank is not None:
            kwargs["rank"] = rank
    dist.init_process_group(backend, **kwargs)


def make_mesh(device="cuda") -> Mesh:
    """The 1-D ``RAY_AXIS`` mesh over every rank of the default group (which
    :func:`initialize_distributed` starts), with this rank's device
    (:func:`rank_device`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed() first "
                           "(or launch with torchrun)")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=rank_device(device))


@contextlib.contextmanager
def sharded_session(device="cuda"):
    """The mesh of a ``--sharded`` CLI run: joins the default group
    (:func:`initialize_distributed`: ``torchrun``'s ranks, else this process
    alone) unless the process is in one already, and leaves it on exit if
    it joined here. Only rank 0 prints: the others' stdout goes to
    ``os.devnull`` inside the block."""
    joined = not dist.is_initialized()
    if joined:
        initialize_distributed(device=device)
    try:
        mesh = make_mesh(device)
        with contextlib.ExitStack() as stack:
            if mesh.rank:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            yield mesh
    finally:
        if joined:
            dist.destroy_process_group()


@contextlib.contextmanager
def rank_zero_first(mesh: Optional[Mesh]):
    """Run the block on rank 0 first and on the other ranks after it, as for
    a block that may build a shared file (the star grid from ``stars.ppm``).
    Without a mesh, just the block."""
    if mesh is not None and mesh.rank:
        dist.barrier()
    yield
    if mesh is not None and not mesh.rank and mesh.size > 1:
        dist.barrier()
