"""``combblas_tpu_torch.dynamic`` — the streaming graph-mutation lane;
counterpart of ``combblas_tpu/dynamic/``.

The READ half of dynamic serving is the engine's double-buffered
``GraphVersion`` hot-swap (``serve.engine``).  This package is the WRITE
half, four layers:

1. **delta** (`delta.py`) — ``DeltaBuffer``: a bounded host-side COO
   delta log (insert / delete / upsert with a per-semiring combine on
   duplicate keys and a deterministic, vectorized fold), batched
   admission with reject-on-full backpressure, obs-visible depth/age.
2. **merge** (`merge.py`) — ``apply_delta(version, batch)``: fold a
   drained batch into the existing ``EllParMat`` tiles and their
   weighted / normalized / transpose twins PER TILE — rows whose
   degree-class slots still fit are patched in place, overflowing rows
   re-bucket into free padding slots, and a spill threshold falls back
   to a full rebuild — re-uploading only the touched bucket classes, so
   the new version keeps every operand shape.
3. **refresh** (`refresh.py`) — warm-restart recompute: BFS/CC repair
   from the previous result (insert-only, by monotonicity) and PageRank
   restart from the previous vector, exposed as
   ``GraphEngine.refresh(kind)``.
4. **wal** (`wal.py`) — the durability layer: a schema-versioned
   append-only write-ahead log of acknowledged batches (torn-tail
   tolerant, fsync-policy knob) plus ``recover_version`` = latest valid
   ``utils.checkpoint`` snapshot + WAL-suffix replay through
   ``apply_delta``, bit-exact with a never-crashed engine.

Log files and snapshots are the reference's formats: either package
replays and loads the other's.
"""

from .delta import (  # noqa: F401
    COMBINES,
    DeltaBatch,
    DeltaBuffer,
    DeltaOverflowError,
    OP_NAMES,
    fold_ops,
)
from .merge import (  # noqa: F401
    MergeState,
    MergeStats,
    apply_delta,
    bootstrap_state,
)
from .refresh import REFRESH_KINDS, refresh_analytic  # noqa: F401
from .wal import (  # noqa: F401
    RecoveryError,
    WriteAheadLog,
    open_wal,
    recover,
    recover_version,
)

__all__ = [
    "DeltaBuffer", "DeltaBatch", "DeltaOverflowError", "OP_NAMES",
    "COMBINES", "fold_ops",
    "apply_delta", "bootstrap_state", "MergeState", "MergeStats",
    "refresh_analytic", "REFRESH_KINDS",
    "WriteAheadLog", "open_wal", "recover", "recover_version",
    "RecoveryError",
]
