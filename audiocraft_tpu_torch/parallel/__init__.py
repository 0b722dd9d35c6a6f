"""Parallelism on `torch.distributed` (counterpart of
`audiocraft_tpu/parallel/`): the distributed verbs, the ('dp', 'fsdp',
'tp') device mesh, parameter placements, sharded checkpoints and the
composed multi-process check."""
# flake8: noqa
from . import distrib, mesh, sharding
from .mesh import batch_sharding, create_mesh, replicated
from .sharding import infer_param_spec, shard_lm
