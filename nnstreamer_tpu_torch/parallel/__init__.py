"""Parallel execution: the serving mesh, long context, pipeline stages
and multi-host runs.

The JAX package's ``parallel`` package on the port's single-controller
mesh: one process drives every device of its mesh.

- ``mesh``      — mesh construction, placements (``Placement``, the
  ``NamedSharding`` counterpart) and ``ShardedTensor``;
- ``serve``     — the serving plane: ``mesh=`` specs, plans, batch and
  weight placement, the reshard counter;
- ``sharded``   — the transformer's param specs, its sharded serving
  steps and its sharded train steps (dp rows, tp heads, ep experts and
  sp sequence shards, one thread a device meeting at explicit
  collectives);
- ``ring``      — ring attention over ``sp``;
- ``pipeline``  — GPipe microbatch pipelining of the layer stack over
  ``pp``;
- ``multihost`` — several processes, ``dp`` spanning them.
"""

from nnstreamer_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchSharding,
    Mesh,
    P,
    PartitionSpec,
    Placement,
    ShardedTensor,
    batch_sharding,
    make_mesh,
)
from nnstreamer_tpu_torch.parallel.ring import ring_attention  # noqa: F401
from nnstreamer_tpu_torch.parallel import multihost  # noqa: F401
