"""Parallelism on ``torch.distributed``: (data, model) meshes, the
Megatron tensor-parallel shard plan of the MMDiT and the T5
(``sharding.py``: column- and row-parallel linears, local-head attention),
the counted collectives (``collectives.py``) and context-parallel ring
attention. The pipelines shard their MMDiT and T5 over a mesh's ``model``
axis at load and split the image batch over its ``data`` axis."""

from .collectives import all_gather, all_reduce_max, all_reduce_sum  # noqa: F401
from .mesh import (  # noqa: F401
    axis_index, axis_size, create_mesh, group, init_distributed, local_mesh,
)
from .ring_attention import merge_chunk_stats, ring_attention  # noqa: F401
from .sharding import (  # noqa: F401
    TensorParallel, mmdit_plan, plan, replicate, routes, shard_module_, t5_plan,
)
