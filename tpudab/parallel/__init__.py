"""Scale-out: ensemble x time device mesh, halo-exchange time sharding.

No reference analog (the reference is single-host thread pipelining,
SURVEY.md sec 2.7); this is the device scaling design: independent DAB
ensembles shard over the 'ensemble' axis (pure DP, zero comm), long captures
shard over the 'time' axis as contiguous frame runs with the 15-CIF
deinterleaver halo exchanged via lax.ppermute.
"""

from tpudab.parallel.mesh import make_mesh, default_mesh_shape
from tpudab.parallel.sharded_step import ShardedReceiveStep
