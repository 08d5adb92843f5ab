"""``combblas_tpu_torch.serve`` — batched graph-query serving; counterpart
of ``combblas_tpu/serve/``.

Ported so far, the two lower layers:

1. **engine** (``engine.py``) — ``GraphEngine``: one loaded graph
   (``EllParMat`` + weighted / normalized / transposed twins, CSC
   companion, degree vectors), a (kind, width) plan cache warmed by
   ``warmup()``, and the graph versions that ``swap()`` installs, which
   ``build_version()`` and the mutation lane (``combblas_tpu_torch.dynamic``)
   build.
2. **batcher** (``batcher.py``) — lane-bucket assembly: coalesce
   single-root requests into the nearest power-of-two lane width, pad
   with ``models.PAD_ROOT``, scatter per-lane results back to request
   futures (pad lanes can never leak).

The scheduler, ``Server`` (api), faults, SLO budget, pool, fleet,
process fleet, network front door and sharded engine of the reference
come in later slices.
"""

from .batcher import Request, assemble, bucket_width, scatter
from .engine import KINDS, GraphEngine, GraphVersion

__all__ = [
    "GraphEngine", "GraphVersion", "Request", "KINDS",
    "bucket_width", "assemble", "scatter",
]
