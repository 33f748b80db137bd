"""Parallel execution: the serving mesh.

The JAX package's ``parallel`` package on the port's single-controller
mesh: one process drives every device.

- ``mesh``    — mesh construction, placements (``Placement``, the
  ``NamedSharding`` counterpart) and ``ShardedTensor``;
- ``serve``   — the serving plane: ``mesh=`` specs, plans, batch and
  weight placement, the reshard counter;
- ``sharded`` — the transformer's param specs and its sharded serving
  steps (dp rows, tp heads with explicit collectives).

Ring attention, the pipelined placement and multi-host runs are ROADMAP
A.25: ``ring_attention`` and ``multihost`` raise naming it.
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
from nnstreamer_tpu_torch.pipeline.element import not_ported as _not_ported

_A25 = "A.25 ring attention, pipeline and multi-host"


def ring_attention(*args, **kwargs):
    """Ring attention over ``sp`` (JAX ``parallel/ring.py``)."""
    raise _not_ported("ring_attention (sequence parallelism)", _A25)


def __getattr__(name):
    if name == "multihost":
        raise _not_ported("parallel.multihost", _A25)
    raise AttributeError(name)
