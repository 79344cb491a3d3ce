"""Device meshes on ``torch.distributed``.

Counterpart of ``diffusionkit_tpu/parallel/mesh.py``: a ``DeviceMesh`` with
``("data", "model")`` axes over the ranks of one process group, one device
each. NCCL carries a CUDA mesh and gloo a CPU one. Nothing on a machine
tells a program of its cluster: ``init_distributed`` is given the
rendezvous, the world size and the rank.
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils import get_logger

logger = get_logger(__name__)

AXES = ("data", "model")


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(init_method: str, world_size: int, rank: int, device="cuda") -> None:
    """Join a process group of ``world_size`` ranks as ``rank``: NCCL for
    CUDA (each rank on card ``rank % device_count``), gloo for the CPU.
    ``init_method`` is the rendezvous, e.g. ``file:///path`` (no network
    needed) or ``tcp://localhost:port``."""
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    logger.info("torch.distributed initialised: %s rank %s/%s", backend, rank, world_size)


def create_mesh(data: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """A (data, model) mesh over every rank of the default process group,
    which must hold exactly ``data * model`` ranks; the model axis is the
    inner one, so a model group is ``model`` consecutive ranks."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    backend = _backend(device)
    if dist.get_backend() != backend:
        raise ValueError(f"a {torch.device(device).type} mesh needs the {backend} backend, "
                         f"the process group runs {dist.get_backend()}")
    return init_device_mesh(torch.device(device).type, (data, model), mesh_dim_names=AXES)


def local_mesh(device="cuda") -> DeviceMesh:
    """The 1x1 mesh of a one-process job: the degenerate case every path
    also accepts. Starts a one-rank process group if none exists (NCCL for
    CUDA, gloo for the CPU; a ``file://`` rendezvous in a temporary
    directory), and destroys it and removes the directory at exit: a
    process that exits with its NCCL group alive can hang there."""
    if not dist.is_initialized():
        tmp = Path(tempfile.mkdtemp(prefix="dk_dist_"))
        atexit.register(shutil.rmtree, tmp, True)
        init_distributed(f"file://{tmp / 'rendezvous'}", 1, 0, device)
        atexit.register(_destroy)
    elif dist.get_world_size() != 1:
        raise ValueError(f"local_mesh is one rank; the process group holds "
                         f"{dist.get_world_size()}: use create_mesh")
    return create_mesh(1, 1, device)


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]
