"""Meshes, after the JAX package's ``launch/mesh.py``.

Functions, not module constants, as in the reference: importing this
module touches no process group.  A mesh is a ``torch.distributed``
``DeviceMesh`` with axes ("data", "model"), or ("pod", "data", "model")
for two pods.

- :func:`make_production_mesh` is the reference's (16, 16) or (2, 16, 16)
  over the initialised world (256 or 512 ranks); the dry-run builds it on
  the ``fake`` backend in one process (``launch/dryrun.py``).
- :func:`make_local_mesh` is a (data, model) mesh over the world that is
  initialised, or that ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) describes, or a world
  of one on ``localhost``: NCCL on the card, gloo when the caller asks for
  the CPU.  On the card each rank takes card ``LOCAL_RANK`` (or its rank).
  A mesh that asks for more ranks than the world has raises; nothing
  shrinks the mesh or moves it to the CPU.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from repro_torch.sharding import MeshAxes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device="cuda") -> None:
    """Initialise the default process group unless one is: from
    ``torchrun``'s environment when it is set, else a world of one over
    ``tcp://localhost``.  NCCL for a CUDA ``device`` (which needs a card),
    gloo for the CPU."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh: device 'cuda' asked for, but "
                               "torch sees no CUDA card (pass device='cpu' "
                               "for a gloo mesh on the CPU)")
        backend = "nccl"
    else:
        backend = "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world = 0, 1
        init = f"tcp://localhost:{_free_port()}"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod", over the
    initialised world (which must have 256 or 512 ranks), on the cards
    unless the caller asks for the CPU (the dry-run's ``fake`` world)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) mesh over the world (initialised here if it is
    not, :func:`init_world`), which must have exactly data x model
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    init_world(device)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"make_local_mesh: a {data} x {model} mesh needs "
                         f"{data * model} ranks, the world has {world}")
    device_type = torch.device(device).type
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def axes_for(mesh) -> MeshAxes:
    return MeshAxes.for_mesh(mesh)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def parse_mesh(text: str):
    """``"D,M"`` -> (D, M)."""
    data, model = (int(v) for v in text.split(","))
    return data, model
