"""Multi-device and multi-process builds: the mesh on torch.distributed
(mesh.py, shard.py) and the file-coordinated build (distributed.py).

The names of panagram_tpu.parallel, with ``Mesh`` (one rank per device)
and ``launch`` (spawn the ranks) in place of its jax.sharding ``make_mesh``
and ``DICT_AXIS``.
"""

from .mesh import Mesh, launch
from .shard import (
    GenomeShardedDict,
    ShardedBucketedDict,
    assemble_genome_shards,
    genome_sharded_anchor_chunk,
    make_halo_chunks,
    shard_dictionary,
    shard_dictionary_genomes,
    sharded_anchor_chunk,
    sharded_build_dictionary,
)

__all__ = [
    "Mesh",
    "launch",
    "GenomeShardedDict",
    "ShardedBucketedDict",
    "assemble_genome_shards",
    "genome_sharded_anchor_chunk",
    "make_halo_chunks",
    "shard_dictionary",
    "shard_dictionary_genomes",
    "sharded_anchor_chunk",
    "sharded_build_dictionary",
]
