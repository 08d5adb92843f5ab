"""Grids over several processes (≈ the MPI world the reference assumes) —
counterpart of ``combblas_tpu/parallel/multihost.py``.

The reference's distribution substrate is MPI_COMM_WORLD split by
CommGrid (``CommGrid.cpp:37-75``); the JAX package's is
``jax.distributed.initialize`` and a mesh over every process's devices.
Here it is ``torch.distributed``: one process per rank, each with one
device, and a grid whose tiles each have an owner rank
(``Grid.owners``). A rank holds only its own tiles, and the tiles other
ranks need travel by ``broadcast`` and ``all_reduce``, the two collectives
that the gloo backend also takes on CUDA tensors, so that every exchange
here runs under both gloo and NCCL. NCCL refuses two ranks on one card,
so a machine with one card runs gloo on CUDA tensors; the NCCL path has
not run on a card yet (ROADMAP item 12c.6).

``init_distributed`` joins the process group (torchrun's ``MASTER_ADDR``
/ ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` where the
reference reads ``JAX_*``), ``make_global_grid`` assigns tiles to ranks in
the reference's device order, ``launch`` starts a job on a fresh process
per rank (``_rankworker``) and ``shutdown`` leaves the group. The
exchanges (``gather_tiles``, ``share_tiles`` with its ``fetch_tiles`` and
``share_line``, ``gather_entries``, ``agree``) are collective: every rank
of the grid calls them in the same order. ``STATS`` counts the collectives
a rank took part in, their bytes (each tensor once, sent or received) and
the host seconds spent in them.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .grid import Grid

#: this process's device once initialised
_STATE: dict = {}
#: process groups of grid rows and columns, by their sorted ranks
_GROUPS: dict = {}
#: collectives, bytes and host seconds of this rank's exchanges
STATS = {"collectives": 0, "bytes": 0, "seconds": 0.0}

_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64, torch.int16, torch.int8,
           torch.uint8, torch.bool, torch.float16, torch.bfloat16)


def world_size() -> int:
    """Ranks in the process group (1 when none is initialised)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device() -> torch.device:
    """This rank's device (``init_distributed``), else the CUDA card."""
    return _STATE.get("device", torch.device("cuda"))


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str | None = None,
                     device: str | torch.device | None = None,
                     timeout_s: float = 300.0) -> int:
    """Join the process group (idempotent) and return the world size.

    With no arguments it reads torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE`` and ``RANK``; the
    reference reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` instead. The rank's device is ``cuda:{LOCAL_RANK %
    device_count}`` unless ``device`` names another (``"cpu"`` in the
    tests). ``backend`` is the caller's, else ``"nccl"`` for a CUDA device
    and ``"gloo"`` for the CPU; nothing switches it afterwards. Every
    collective of the group fails after ``timeout_s`` seconds, so a rank
    that dies does not leave the others waiting for ever.

    The reference returns ``len(jax.devices())``, every device of every
    process; a rank here has one device, so this is the number of ranks.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    n = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", "1"))
    me = int(process_id if process_id is not None else env.get("RANK", "0"))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", me)) % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    be = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _STATE["device"] = dev
    if n == 1:
        return 1
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator address (host:port)")
    dist.init_process_group(be, init_method=f"tcp://{coordinator_address}", world_size=n,
                            rank=me, timeout=datetime.timedelta(seconds=timeout_s))
    return n


def shutdown() -> None:
    """Leave the process group and forget its grids' groups."""
    _GROUPS.clear()
    _STATE.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_global_grid(pr: int | None = None, pc: int | None = None) -> Grid:
    """The pr×pc grid over every rank (the squarest one when a dimension is
    missing), its tiles assigned in the reference's device order
    (``multihost.py:60-79``): process-major, tile t (row-major) on rank
    ``t · world // (pr·pc)``, so that each rank holds a run of pr·pc /
    world tiles as a reference process holds that many devices. The
    reference takes a subgrid smaller than its device count round-robin
    across processes so that every process holds tiles; here a rank is one
    device, so such a grid would leave ranks without a tile, and it is
    refused. Every rank must call this in the same order: it creates the
    process groups of the grid's rows and columns."""
    if pr is None or pc is None:
        return Grid.make_default(device=device())
    world, need = world_size(), pr * pc
    if world == 1:
        return Grid.make(pr, pc, device=device())
    if need < world:
        raise ValueError(f"a {pr}x{pc} grid leaves ranks of {world} without a tile")
    return grid_of_owners(pr, pc, tuple(t * world // need for t in range(need)))


def grid_of_owners(pr: int, pc: int, owners: tuple) -> Grid:
    """The pr×pc grid over every rank whose tile t (row-major) lives on rank
    ``owners[t]``, with the process groups of its rows and columns (every
    rank calls this in the same order). ``make_global_grid``'s layout is
    one such; any other that gives each rank a tile runs the same code."""
    world = world_size()
    if sorted(set(owners)) != list(range(world)) or len(owners) != pr * pc:
        raise ValueError(f"owners {owners} must give each of {world} ranks a tile of {pr}x{pc}")
    grid = Grid(pr=pr, pc=pc, device=device(), owners=tuple(owners), rank=rank(), world=world)
    for members in ([grid.row_ranks(i) for i in range(pr)]
                    + [grid.col_ranks(j) for j in range(pc)]):
        key = tuple(members)
        if 1 < len(key) < world and key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(key))
    return grid


# --- collectives -------------------------------------------------------------


def _group(members):
    """The process group whose ranks are ``members``, or the smallest
    grid row or column group holding them, or the world: ``(group,
    ranks)``."""
    key = tuple(sorted(set(members)))
    world = world_size()
    if len(key) == world:
        return None, list(range(world))
    if key in _GROUPS:
        return _GROUPS[key], list(key)
    supers = [k for k in _GROUPS if set(key) <= set(k)]
    if supers:
        k = min(supers, key=len)
        return _GROUPS[k], list(k)
    return None, list(range(world))


def _count(t: torch.Tensor, t0: float) -> None:
    STATS["collectives"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0


def broadcast_(t: torch.Tensor, src: int, members=None) -> torch.Tensor:
    """``t`` from rank ``src`` to every rank of ``members`` (default: all),
    in place; every one of them calls it. Bools travel as uint8."""
    group, _ = _group(members if members is not None else range(world_size()))
    buf = t.view(torch.uint8) if t.dtype == torch.bool else t
    t0 = time.perf_counter()
    dist.broadcast(buf, src=src, group=group)
    _count(buf, t0)
    return t


def all_reduce_(t: torch.Tensor, op: str = "sum", members=None) -> torch.Tensor:
    """``t`` reduced over the ranks of ``members`` (default: all) by
    ``op`` (sum, min, max), in place."""
    group, _ = _group(members if members is not None else range(world_size()))
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    t0 = time.perf_counter()
    dist.all_reduce(t, op=ops[op], group=group)
    _count(t, t0)
    return t


def agree(grid, value: int, op: str = "max") -> int:
    """An integer reduced over every rank of ``grid`` (max, min or sum),
    the same on each: what sizes or routes work on a grid over several
    processes comes from here. On one process, ``value``."""
    if not grid.is_distributed:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=grid.device)
    return int(all_reduce_(t, op).item())


def _meta(x: torch.Tensor | None, grid, src: int) -> tuple:
    """Shape and dtype of ``x`` on rank ``src``, sent to every rank."""
    m = torch.zeros(10, dtype=torch.int64, device=grid.device)
    if grid.rank == src:
        m[0], m[1] = _DTYPES.index(x.dtype), x.dim()
        m[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    broadcast_(m, src)
    m = m.tolist()
    return tuple(m[2:2 + m[1]]), _DTYPES[m[0]]


def gather_tiles(grid, fn) -> dict:
    """``fn(i, j)`` of every tile on every rank: each rank computes its own
    tiles' (tensors of one shape and dtype), then each rank's stack goes to
    all (one ``broadcast`` a rank after the shape's). A dict by tile. On
    one process, ``fn`` of every tile and no exchange."""
    own = {t: fn(*t) for t in grid.owned_tiles()}
    if not grid.is_distributed:
        return own
    shape, dtype = _meta(own.get((0, 0)), grid, grid.owner(0, 0))
    out = {}
    for r in range(grid.world):
        tiles = [(i, j) for i in range(grid.pr) for j in range(grid.pc) if grid.owner(i, j) == r]
        if r == grid.rank:
            buf = torch.stack([own[t] for t in tiles]).contiguous()
        else:
            buf = torch.empty((len(tiles), *shape), dtype=dtype, device=grid.device)
        broadcast_(buf, r)
        out.update(zip(tiles, buf))
    return out


def share_tiles(grid, own, need, like) -> dict:
    """The tensors of the tiles other ranks hold that this rank needs, by
    tile: ``own(i, j)`` gives the tuple of tensors of a tile this rank
    holds (called for the tiles another rank needs), ``need(r)`` the tiles
    rank r needs (every rank evaluates it for every rank), ``like`` the
    ``(shape, dtype)`` of each tensor of the tuple. A tile goes from its
    owner to the ranks that need it by one ``broadcast`` a tensor, within
    the smallest row, column or world group holding them."""
    wants = [set(need(r)) for r in range(grid.world)]
    out = {}
    for i in range(grid.pr):
        for j in range(grid.pc):
            o = grid.owner(i, j)
            takers = [r for r in range(grid.world) if r != o and (i, j) in wants[r]]
            if not takers:
                continue
            _, members = _group([o, *takers])
            if grid.rank not in members:
                continue
            if grid.rank == o:
                bufs = tuple(x.contiguous() for x in own(i, j))
            else:
                bufs = tuple(torch.empty(shape, dtype=dt, device=grid.device) for shape, dt in like)
            for b in bufs:
                broadcast_(b, o, members)
            if grid.rank != o and (i, j) in wants[grid.rank]:
                out[i, j] = bufs
    return out


def fetch_tiles(M, need) -> dict:
    """The tiles of the distributed matrix ``M`` that this rank needs
    (``need`` as for ``share_tiles``), as SpTuples by tile: its own read in
    place, the others' fetched as their indices and count in one tensor and
    their values in another."""
    from ..ops.tuples import SpTuples

    grid, cap = M.grid, M.capacity

    def pack(i, j):
        t = M.local_tile(i, j)
        return torch.cat([t.rows, t.cols, t.nnz.view(1).to(t.rows.dtype)]), t.vals

    got = share_tiles(grid, pack, need, [((2 * cap + 1,), M.rows.dtype), ((cap,), M.vals.dtype)])
    out = {}
    for i, j in need(grid.rank):
        if (i, j) in got:
            ints, vals = got[i, j]
            out[i, j] = SpTuples(rows=ints[:cap], cols=ints[cap:2 * cap], vals=vals,
                                 nnz=ints[2 * cap].to(torch.int32), nrows=M.local_rows,
                                 ncols=M.local_cols)
        else:
            out[i, j] = M.local_tile(i, j)
    return out


def share_line(grid, own: dict, line: str) -> dict:
    """Every tile's tensors on the ranks of its grid row (``line="row"``) or
    column (``"col"``): ``own`` holds this rank's tiles' tuples of tensors,
    of one shape and dtype a position across tiles. Returns, by tile, the
    tuples of every tile of the lines this rank holds tiles in."""
    def need(r):
        mine = [(i, j) for i in range(grid.pr) for j in range(grid.pc) if grid.owner(i, j) == r]
        if line == "row":
            return {(i, j) for i in {t[0] for t in mine} for j in range(grid.pc)}
        return {(i, j) for j in {t[1] for t in mine} for i in range(grid.pr)}

    like = [(x.shape, x.dtype) for x in next(iter(own.values()))]
    return {**own, **share_tiles(grid, lambda i, j: own[i, j], need, like)}


def gather_entries(grid, fn) -> dict:
    """``fn(i, j)`` -> ``(ints [a, n], vals [n])`` of every tile on every
    rank, n varying by tile: the counts go first (one ``all_reduce``),
    then each tile's two tensors from its owner. A dict by tile."""
    own = {t: fn(*t) for t in grid.owned_tiles()}
    first = own[grid.owned_tiles()[0]]
    counts = torch.zeros(grid.size, dtype=torch.int64, device=grid.device)
    for (i, j), (_, v) in own.items():
        counts[i * grid.pc + j] = v.shape[0]
    counts = all_reduce_(counts, "sum").tolist()
    ishape, dtype = _meta(own.get((0, 0), first)[0], grid, grid.owner(0, 0))
    _, vdtype = _meta(own.get((0, 0), first)[1], grid, grid.owner(0, 0))
    out = {}
    for i in range(grid.pr):
        for j in range(grid.pc):
            o, n = grid.owner(i, j), counts[i * grid.pc + j]
            if grid.rank == o:
                ints, vals = (x.contiguous() for x in own[i, j])
            else:
                ints = torch.empty((ishape[0], n), dtype=dtype, device=grid.device)
                vals = torch.empty(n, dtype=vdtype, device=grid.device)
            if n:
                broadcast_(ints, o)
                broadcast_(vals, o)
            out[i, j] = (ints, vals)
    return out


# --- running a job on several processes ----------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def load_job(job: str):
    """``"package.module:function"`` or ``"path/to/file.py:function"``."""
    where, name = job.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def launch(job: str, world: int, *, kwargs: dict | None = None, device: str = "cuda",
           backend: str | None = None, timeout_s: float = 300.0,
           workdir: str | os.PathLike | None = None, env: dict | None = None) -> list:
    """Run ``job(**kwargs)`` on ``world`` fresh processes, one a rank
    (``python -m combblas_tpu_torch.parallel._rankworker``), joined by
    ``init_distributed`` through torchrun's variables on a local port, and
    return each rank's return value (pickled through ``workdir``).
    ``device``: ``"cuda"`` (the rank's card by ``LOCAL_RANK``) or ``"cpu"``.
    A rank that exits non-zero, or a run past ``timeout_s``, kills every
    rank and raises with the end of each rank's log."""
    own_dir = workdir is None
    wd = Path(tempfile.mkdtemp(prefix="ranks-") if own_dir else workdir)
    wd.mkdir(parents=True, exist_ok=True)
    spec = {"job": job, "kwargs": kwargs or {}, "device": device, "backend": backend,
            "timeout_s": timeout_s, "out": str(wd / "result{rank}.pkl")}
    spec_path = wd / "job.pkl"
    spec_path.write_bytes(pickle.dumps(spec))
    root = str(Path(__file__).resolve().parents[2])
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(wd / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "combblas_tpu_torch.parallel._rankworker", str(spec_path)],
                stdout=log, stderr=subprocess.STDOUT,
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = f"rank {failed[0]} exited {procs[failed[0]].returncode}" if failed \
                    else f"ranks still running after {timeout_s} s"
                raise RuntimeError(f"{job}: {why}\n{_tails(wd, world)}")
            time.sleep(0.02)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{job}: rank {bad[0]} exited {procs[bad[0]].returncode}\n"
                               f"{_tails(wd, world)}")
        return [pickle.loads((wd / f"result{r}.pkl").read_bytes()) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        if own_dir:
            import shutil

            shutil.rmtree(wd, ignore_errors=True)


def _tails(wd: Path, world: int, nbytes: int = 3000) -> str:
    parts = []
    for r in range(world):
        p = wd / f"rank{r}.log"
        text = p.read_text(errors="replace") if p.exists() else ""
        parts.append(f"--- rank {r} ---\n{text[-nbytes:]}")
    return "\n".join(parts)
