"""Parallelism on ``torch.distributed``: (data, model) meshes and ring
attention. Tensor parallelism (the reference's ``parallel/sharding.py``)
and the data-parallel split of the image batch come in a later slice."""

from .mesh import axis_size, create_mesh, init_distributed, local_mesh  # noqa: F401
from .ring_attention import merge_chunk_stats, ring_attention  # noqa: F401
