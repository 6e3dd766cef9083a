"""Multi-shard domain decomposition over a shard group.

Port of ``hpdg_tpu.parallel``.  The reference partitions the mesh over a
``jax.sharding.Mesh`` and exchanges one element layer with each
neighbour by ``ppermute`` inside ``shard_map``; here a
:class:`~hpdg_tpu_torch.parallel.comm.ShardGroup` holds the shards, in
one process (every shard on one device, the shard body batched over
them) or over ``torch.distributed`` ranks (NCCL on cards, gloo on the
CPU).  The sharded layout is non-overlapping: each element's block
lives on exactly one shard, so an apply needs a halo gather before the
face terms and nothing after; global reductions are group psums.
"""

from hpdg_tpu_torch.parallel.comm import ShardGroup, Sharding  # noqa: F401
from hpdg_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedPoisson, build_sharded_poisson)
