"""``combblas_tpu_torch.serve`` — batched graph-query serving; counterpart
of ``combblas_tpu/serve/``.

Ported so far:

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
3. **scheduler** (``scheduler.py``) — admission control: a bounded
   queue that rejects with a retry-after hint (``BackpressureError``),
   per-kind flush deadlines, request timeouts, per-kind circuit breakers
   (``CircuitBreaker``), the policy knobs (``ServeConfig``) and the
   tenants' fair queue (``DeficitRoundRobin``).
4. **api** (``api.py``) — ``Server`` (``GraphEngine.serve``): one worker
   thread owns execution; a failed batch is bisected so a poison request
   fails alone; ``submit_update`` is the write lane (merge off the
   execution lock, atomic swap); with a durability directory, the WAL
   and the background checkpointer, and ``Server.from_recovery``.
5. **faults** (``faults.py``) and **slo** (``slo.py``) — deterministic
   fault injection at named points (``FaultInjector``) and the rolling
   SLO error budget (``ErrorBudget``).
6. **pool** (``pool.py``) — ``EnginePool`` + ``PoolServer``: many
   tenants' graphs behind one card, one worker under weighted fair
   queueing, byte-budgeted LRU eviction of device state (a re-admitted
   tenant is rebuilt from its retained host COO).
7. **policy** (``policy.py``) and **fleet** (``fleet.py``) —
   ``FleetRouter``: N replicas of one graph behind one router,
   least-loaded routing with spillover and read retry, writes routed
   home and fanned out, and a supervisor that quarantines dead replicas
   (``ReplicaDeadError``), promotes a dead home at the WAL frontier and
   rebuilds replacements.
8. **process fleet** (``procfleet.py``, ``_procworker.py``, ``frame.py``,
   ``ipc.py``) — ``ProcessFleet``: the same policy over replica
   subprocesses, each a ``Server`` with its own CUDA context, behind
   framed socketpair IPC (``ReplicaProc``, ``IpcTimeoutError``),
   heartbeats, SIGKILL/SIGSTOP chaos (``ProcessFaultPlan``) and respawn
   from checkpoint + WAL.
9. **shard** (``shard.py``, ``_shardworker.py``) — ``ShardedEngine``:
   one graph's row space partitioned over N slices (``plan_partition``),
   each a rectangular slab on its own grid, in-process or a subprocess
   with its own CUDA context, served as one engine through the router's
   bulk-synchronous hop loops (``ShardedGraphVersion`` carries the
   per-slice WAL frontier vector; durability is engine-owned).
10. **net** (``net/``) — ``NetFrontend``: the TCP front door over any of
    the backends above (versioned hello, pipelined requests, the typed
    status taxonomy of ``net/protocol.py``), ``NetClient`` (the
    blocking, retrying client) and ``net/loadgen.py`` (the open-loop
    Poisson load generator).
"""

from .batcher import Request, assemble, bucket_width, scatter
from .engine import KINDS, GraphEngine, GraphVersion
from .faults import (
    FAULT_POINTS,
    FaultInjector,
    InjectedFault,
    ProcessFaultPlan,
)
from .scheduler import (
    BackpressureError,
    CircuitBreaker,
    CircuitBreakerOpen,
    DeficitRoundRobin,
    Scheduler,
    ServeConfig,
)
from .api import Server
from .pool import EnginePool, PoolServer
from .fleet import FleetRouter, ReplicaDeadError
from .procfleet import IpcTimeoutError, ProcessFleet, ReplicaProc
from .slo import ErrorBudget
from .shard import ShardedEngine, ShardedGraphVersion, plan_partition
from .net import NetClient, NetFrontend

__all__ = [
    "GraphEngine", "GraphVersion", "Server", "ServeConfig", "Scheduler",
    "BackpressureError", "CircuitBreaker", "CircuitBreakerOpen",
    "DeficitRoundRobin", "EnginePool", "PoolServer", "FleetRouter",
    "ReplicaDeadError",
    "ProcessFleet", "ReplicaProc", "IpcTimeoutError",
    "ShardedEngine", "ShardedGraphVersion", "plan_partition",
    "NetClient", "NetFrontend",
    "FaultInjector", "InjectedFault", "ProcessFaultPlan",
    "FAULT_POINTS", "ErrorBudget",
    "Request", "KINDS",
    "bucket_width", "assemble", "scatter",
]
