"""Device meshes on ``torch.distributed``.

Counterpart of ``diffusionkit_tpu/parallel/mesh.py``: a ``DeviceMesh`` with
``("data", "model")`` axes over the ranks of one process group, one device
each. NCCL carries a CUDA mesh and gloo a CPU one; gloo also carries a
CUDA mesh whose ranks share one card (NCCL refuses two ranks on one
device), its collectives staged through the host
(``parallel/collectives.py``). Nothing on a machine tells a program of its
cluster: ``init_distributed`` is given the rendezvous, the world size and
the rank. ``group``, ``axis_size`` and ``axis_index`` read a mesh's
``data`` and ``model`` groups; a mesh of None is one rank.
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils import get_logger

logger = get_logger(__name__)

AXES = ("data", "model")


def _backend(device, backend=None) -> str:
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(init_method: str, world_size: int, rank: int, device="cuda",
                     backend=None) -> None:
    """Join a process group of ``world_size`` ranks as ``rank``: by default
    NCCL for CUDA and gloo for the CPU; ``backend="gloo"`` with a CUDA
    device puts several ranks on the cards they find (each rank on card
    ``rank % device_count``, so on one card all of them).
    ``init_method`` is the rendezvous, e.g. ``file:///path`` (no network
    needed) or ``tcp://localhost:port``."""
    backend = _backend(device, backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    logger.info("torch.distributed initialised: %s rank %s/%s", backend, rank, world_size)


def create_mesh(data: int = 1, model: int = 1, device="cuda", backend=None) -> DeviceMesh:
    """A (data, model) mesh over every rank of the default process group,
    which must hold exactly ``data * model`` ranks and run ``backend`` (by
    default NCCL on CUDA, gloo on the CPU); the model axis is the inner
    one, so a model group is ``model`` consecutive ranks. A gloo mesh is a
    CPU ``DeviceMesh`` whatever device its tensors live on: gloo runs its
    collectives on the host."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    backend = _backend(device, backend)
    if dist.get_backend() != backend:
        raise ValueError(f"a {torch.device(device).type} mesh needs the {backend} backend, "
                         f"the process group runs {dist.get_backend()}")
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", (data, model),
                            mesh_dim_names=AXES)


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


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The number of ranks along the axis ``name`` (1 for no mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def group(mesh: Optional[DeviceMesh], name: str):
    """The process group of this rank along the axis ``name``, or None
    where the axis is one rank (or there is no mesh): nothing to
    communicate."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's index along the axis ``name`` (0 for no mesh)."""
    if axis_size(mesh, name) == 1:
        return 0
    return dist.get_rank(mesh.get_group(name))
