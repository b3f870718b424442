"""Data parallelism and multi-process bootstrap over torch.distributed
(the port's counterpart of `nanodecoder_tpu.parallel`): the `data` axis
of the JAX package's device mesh becomes the ranks of a process group,
one device each; basecalling across ranks is share-nothing, a file
partition per rank and a merge of the FASTQ shards on rank 0.
"""

from nanodecoder_tpu_torch.parallel.mesh import MeshPlan, make_mesh_plan  # noqa: F401
from nanodecoder_tpu_torch.parallel.multihost import (  # noqa: F401
    host_shard_path,
    initialize_multihost,
    partition_files_for_host,
)
