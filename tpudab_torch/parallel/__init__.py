"""Scale-out: the ensemble x time mesh on torch.distributed and the receive
step sharded over it (counterpart of tpudab.parallel).

Independent DAB ensembles shard over the 'ensemble' axis (pure data
parallel, no communication); long captures shard over the 'time' axis as
contiguous frame runs, with the 15-CIF deinterleaver halo sent to the
right time neighbour (one isend/irecv pair a call). Run it with
tpudab_torch.tools.launch_multihost.
"""

from tpudab_torch.parallel.mesh import Mesh, default_mesh_shape, make_mesh
from tpudab_torch.parallel.sharded_step import ShardedReceiveStep
