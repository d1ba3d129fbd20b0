"""Distributed layer: meshes, tensor-parallel placements, collectives.

- voices/segments become batch axes split over ``data``;
- the LLM shards megatron-style over ``model`` (tensor parallelism);
- one process drives one device, in a ``torch.distributed`` process group
  (``nccl`` on CUDA, ``gloo`` on the CPU), and the sharded forward calls its
  collectives itself.
"""

from .mesh import data_sharding, local_mesh, make_mesh, replicated  # noqa: F401
from .sharding import llm_param_spec, shard_params  # noqa: F401
