"""The two-rank side of ``tests/test_torch_multihost.py``: the reference's
multi-process path (``tests/_multihost_worker.py``: ``from_global_coo`` ->
``dist_spmv``, ``spgemm`` on a square subgrid, ``read_mm_distributed``) run
in the port over ``torch.distributed`` (gloo, CPU tensors), with the rest
of the slice beside it.

``compute(make_grid, mm_path)`` runs every step on the grids that
``make_grid(pr, pc, owners)`` makes and returns host values by
key; the test parent calls it with one-process grids, and each rank calls
it (through ``job``, started by ``multihost.launch``) with
``global_grid``. ``distributed_only`` adds what has no
one-process counterpart: the tiles a rank holds, ``axis_reduce``, and the
calls that must raise ``LocalOnlyError``. Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from combblas_tpu_torch import (
    MIN_PLUS,
    PLUS_TIMES,
    DistVec,
    Grid,
    LocalOnlyError,
    SpParMat,
    dist_spmv,
    dist_spmv_masked,
    read_mm_distributed,
    spgemm,
)
from combblas_tpu_torch.obs.sinks import psum_counters
from combblas_tpu_torch.ops.semiring_matmul import semiring_matmul
from combblas_tpu_torch.parallel import multihost
from combblas_tpu_torch.parallel.collectives import axis_reduce, axis_reduce_scatter
from combblas_tpu_torch.parallel.redistribute import from_device_coo, redistribute_coo
from combblas_tpu_torch.parallel.spgemm import (
    coo_has_duplicates,
    summa_capacities,
    summa_spgemm,
    summa_spgemm_mxu,
    summa_stage_flops,
)
from combblas_tpu_torch.parallel.spmat import CARRIED as SPMAT_CARRIED
from combblas_tpu_torch.parallel.vec import CARRIED as VEC_CARRIED

N = 48
# name: (pr, pc, the rank of each tile on two ranks; None: ``make_global_grid``'s).
# "2x2rr" is the reference's 2x2 subgrid of two processes of 4 devices each,
# taken round-robin across the processes (``multihost.py:60-79``).
GRIDS = {"2x4": (2, 4, None), "2x2": (2, 2, None), "2x2rr": (2, 2, (0, 1, 0, 1))}
# name: (semiring, value dtype)
CASES = {"plus_times": (PLUS_TIMES, np.float32), "min_plus": (MIN_PLUS, np.float32),
         "int": (PLUS_TIMES, np.int32)}
# the grids the per-tile methods run on (one process-major, one round-robin)
OPS_GRIDS = ("2x4", "2x2rr")
GENERIC_SUM = dataclasses.replace(PLUS_TIMES, name="plus_generic", add_kind="generic")


def matrix(case: str, n: int = N, seed: int = 0):
    """The reference worker's 48-node matrix (``default_rng(0)``, density
    0.15, values 1 + U[0, 1)); the integer case rounds 7 times the values."""
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < 0.15).astype(np.float32) * (
        1 + rng.random((n, n)).astype(np.float32))
    r, c = np.nonzero(d)
    v = d[r, c]
    if CASES[case][1] == np.int32:
        v = np.round(v * 7).astype(np.int32)
    return r.astype(np.int64), c.astype(np.int64), v


def coo(M: SpParMat):
    """Every entry in tile order, and the capacity."""
    r, c, v = M.to_global_coo()
    return r, c, v, M.capacity


def counters(grid) -> torch.Tensor:
    """Tile (i, j)'s counters [10 i + j, 1, 7]: ``[pr, pc, 3]`` on one
    process, the rank's own ``[k, 3]`` on several."""
    own = torch.tensor([[10 * i + j, 1, 7] for i, j in grid.owned_tiles()], dtype=torch.int64)
    return own.view(*grid.tiles_shape, 3).to(grid.device)


def global_chunks(grid, r, c, v, n: int):
    """The global tuples cut into one chunk a tile in row-major tile order
    (padding rows n), ``[pr, pc, chunk]``; on several processes the rank's
    own tiles' chunks ``[k, chunk]``."""
    chunk = -(-len(r) // grid.size)
    R = np.full(grid.size * chunk, n, np.int32)
    C = np.full(grid.size * chunk, n, np.int32)
    V = np.zeros(grid.size * chunk, v.dtype)
    R[:len(r)], C[:len(r)], V[:len(r)] = r, c, v
    own = [i * grid.pc + j for i, j in grid.owned_tiles()]

    def up(x):
        return torch.from_numpy(x.reshape(grid.size, chunk)[own].reshape(
            *grid.tiles_shape, chunk).copy()).to(grid.device)

    return up(R), up(C), up(V)


def outcome(fn):
    """``fn()``'s host value, or the exception it raised (type, message)."""
    try:
        return host(fn())
    except Exception as e:  # noqa: BLE001 - the outcome is the comparison
        return ("raised", type(e).__name__, str(e))


def host(x):
    if isinstance(x, SpParMat):
        return coo(x)
    if isinstance(x, DistVec):
        return x.blocks.cpu().numpy(), x.length, x.align
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return tuple(host(y) for y in x)
    return x


def _vec(grid, align: str, seed: int):
    return DistVec.from_global(
        grid, np.random.default_rng(seed).random(N).astype(np.float32) + 0.5, align=align)


# every method the slice carries beside the main path: (A, B, grid) -> result
OPS = {
    "tile_map": lambda A, B, g: A.tile_map(lambda t: t.apply(lambda v: v * 2)),
    "tile_map_ij": lambda A, B, g: A.tile_map_ij(lambda t, i, j: t.apply(lambda v: v + i - j)),
    "tile_map_indexed": lambda A, B, g: A.tile_map_indexed(
        lambda t, ro, co: t.select_ij(lambda r, c: (r + ro + c + co) % 2 == 0)),
    "keep_ij": lambda A, B, g: A.keep_ij(lambda r, c: (r + 2 * c) % 3 == 0),
    "tril": lambda A, B, g: A.tril(),
    "triu": lambda A, B, g: A.triu(strict=False),
    "remove_loops": lambda A, B, g: A.remove_loops(),
    "apply": lambda A, B, g: A.apply(torch.neg),
    "prune": lambda A, B, g: A.prune(lambda v: v > 1.5),
    "reduce_rows": lambda A, B, g: A.reduce(PLUS_TIMES, "rows"),
    "reduce_cols_min": lambda A, B, g: A.reduce(MIN_PLUS, "cols"),
    "nnz_per_column": lambda A, B, g: A.nnz_per_column(),
    "dim_apply": lambda A, B, g: A.dim_apply(_vec(g, "row", 3), torch.mul, "cols"),
    "tile_zip": lambda A, B, g: A.tile_zip(B, lambda a, b: a.apply(lambda v: v + 1)),
    "ewise_mult": lambda A, B, g: A.ewise_mult(B),
    "ewise_apply": lambda A, B, g: A.ewise_apply(B, torch.sub, allow_a_nulls=True,
                                                 allow_b_nulls=True),
    "ewise_add": lambda A, B, g: A.ewise_add(B, MIN_PLUS),
    "add_loops": lambda A, B, g: A.add_loops(3.0),
    "prune_column": lambda A, B, g: A.prune_column(_vec(g, "col", 4), torch.gt),
    "prune_rowcol": lambda A, B, g: A.prune_rowcol(
        _vec(g, "row", 5), _vec(g, "col", 6), lambda v, a, b: v > a * b),
    "with_capacity": lambda A, B, g: A.with_capacity(2 * A.capacity),
    "square": lambda A, B, g: A.square(MIN_PLUS),
    "from_dense": lambda A, B, g: SpParMat.from_dense(g, A.to_dense() + B.to_dense()),
    "to_dense": lambda A, B, g: A.to_dense(),
    "summa_spgemm_ring": lambda A, B, g: summa_spgemm(
        PLUS_TIMES, A, B, **dict(zip(("flop_capacity", "out_capacity"),
                                     summa_capacities(A, B))), ring=True, merge="runs"),
}


def compute(make_grid, mm_path: str) -> dict:
    """Every step of the slice on ``make_grid``'s grids: host values by
    key."""
    out = {}
    for gname, (pr, pc, owners) in GRIDS.items():
        grid = make_grid(pr, pc, owners)
        for case, (sr, dt) in CASES.items():
            key = f"{gname}/{case}"
            r, c, v = matrix(case)
            A = SpParMat.from_global_coo(grid, r, c, v, N, N)
            out[key + "/coo"] = coo(A)
            out[key + "/nnz"] = int(A.getnnz())
            out[key + "/imbalance"] = float(A.load_imbalance())
            x = DistVec.from_global(grid, np.arange(N, dtype=dt), align="col")
            out[key + "/spmv"] = dist_spmv(sr, A, x).blocks.cpu().numpy()
            act = DistVec.from_global(grid, np.arange(N) % 3 != 0, align="row")
            out[key + "/spmv_masked"] = dist_spmv_masked(sr, A, x, act).blocks.cpu().numpy()
            if grid.is_square:
                C = spgemm(sr, A, A)
                out[key + "/spgemm"] = coo(C)
                out[key + "/spgemm_caps"] = spgemm.last_capacities
                out[key + "/stage_flops"] = summa_stage_flops(A, A).cpu().numpy()
                if dt == np.float32:
                    C, over = summa_spgemm_mxu(sr, A, A, out_capacity=A.local_rows * A.local_cols)
                    out[key + "/mxu"] = (coo(C), int(over))
                    out[key + "/mxu_overflow"] = int(summa_spgemm_mxu(sr, A, A,
                                                                      out_capacity=8)[1])
        r, c, v = matrix("plus_times")
        out[gname + "/dups"] = (
            coo_has_duplicates(SpParMat.from_global_coo(grid, r, c, v, N, N)),
            coo_has_duplicates(SpParMat.from_global_coo(
                grid, np.r_[r, r[-1:]], np.r_[c, c[-1:]], np.r_[v, v[-1:]], N, N)))
        R, C_, V = global_chunks(grid, r, c, v, N)
        M, dropped = redistribute_coo(grid, R, C_, V, N, N, stage_capacity=64, tile_capacity=128)
        out[gname + "/redistribute"] = (coo(M), int(dropped))
        out[gname + "/redistribute_drops"] = int(redistribute_coo(
            grid, R, C_, V, N, N, stage_capacity=2, tile_capacity=4)[1])
        out[gname + "/from_device_coo"] = coo(from_device_coo(grid, R, C_, V, N, N,
                                                              slack=0.25))
        out[gname + "/mm"] = coo(read_mm_distributed(grid, mm_path))
        out[gname + "/mm_dedup"] = coo(read_mm_distributed(grid, mm_path, dedup_sr=PLUS_TIMES))
        out[gname + "/psum"] = psum_counters(grid, counters(grid)).cpu().numpy()
        if gname in OPS_GRIDS:
            A = SpParMat.from_global_coo(grid, r, c, v, N, N)
            B = SpParMat.from_global_coo(grid, *matrix("plus_times", seed=1), N, N)
            for name, fn in OPS.items():
                out[f"{gname}/op/{name}"] = outcome(lambda: fn(A, B, grid))
    return out


def _public(cls, carried):
    return sorted(n for n, a in vars(cls).items() if not n.startswith("_") and n not in carried
                  and not isinstance(a, property) and callable(getattr(cls, n)))


#: the public methods a grid over several processes does not carry
SPMAT_GUARDED = _public(SpParMat, SPMAT_CARRIED)
VEC_GUARDED = _public(DistVec, VEC_CARRIED)


def _apps():
    """Apps above the slice's classes: (A, x, grid) -> call."""
    from combblas_tpu_torch import (
        EllParMat,
        Grid3D,
        SpParMat3D,
        bfs,
        connected_components,
        dist_spmspv,
        kernel1_device,
        maximal_matching,
        mcl,
        mis,
        pagerank,
        rcm_ordering,
        spgemm_auto,
        spgemm_scan,
        spgemm_windowed,
        sssp,
        subsref,
        triangle_count,
    )
    from combblas_tpu_torch.parallel.dense import DenseParMat
    from combblas_tpu_torch.utils import threefry

    return {
        "bfs": lambda A, x, g: bfs(A, 0),
        "sssp": lambda A, x, g: sssp(A, 0),
        "pagerank": lambda A, x, g: pagerank(A),
        "connected_components": lambda A, x, g: connected_components(A),
        "mis": lambda A, x, g: mis(A),
        "triangle_count": lambda A, x, g: triangle_count(A),
        "mcl": lambda A, x, g: mcl(A),
        "maximal_matching": lambda A, x, g: maximal_matching(A),
        "rcm_ordering": lambda A, x, g: rcm_ordering(A),
        "subsref": lambda A, x, g: subsref(A, [0, 1], [0, 1]),
        "dist_spmspv": lambda A, x, g: dist_spmspv(
            PLUS_TIMES, A, x, DistVec.from_global(g, np.ones(N, bool), align="col")),
        "spgemm_auto": lambda A, x, g: spgemm_auto(PLUS_TIMES, A, A),
        "spgemm_scan": lambda A, x, g: spgemm_scan(PLUS_TIMES, A, A),
        "spgemm_windowed": lambda A, x, g: spgemm_windowed(PLUS_TIMES, A, A),
        "ellparmat": lambda A, x, g: EllParMat.from_spmat(A),
        "densparmat": lambda A, x, g: DenseParMat.zeros(g, N, 4),
        "spmat3d": lambda A, x, g: SpParMat3D.from_spmat(
            A, Grid3D.make(2, 1, 1, device=g.device)),
        "kernel1_device": lambda A, x, g: kernel1_device(g, 5, 4, threefry.key(1)),
    }


def distributed_only(grid) -> dict:
    """What has no one-process counterpart, on a grid over several
    processes: the tiles this rank holds, ``axis_reduce`` over the grid's
    row groups, and the calls that must raise ``LocalOnlyError``."""
    out = {"owners": grid.owners, "rank": grid.rank, "owned": grid.owned_tiles()}
    r, c, v = matrix("plus_times")
    A = SpParMat.from_global_coo(grid, r, c, v, N, N)
    out["tile_shapes"] = (tuple(A.rows.shape), tuple(A.vals.shape), tuple(A.nnz.shape))
    x = torch.tensor([grid.rank + 1.5, -float(grid.rank), 2.0 ** grid.rank], device=grid.device)
    for name, sr in (("sum", PLUS_TIMES), ("min", MIN_PLUS),
                     ("max", dataclasses.replace(PLUS_TIMES, add_kind="max", add=torch.maximum)),
                     ("generic", GENERIC_SUM)):
        out[f"axis_reduce/{name}"] = axis_reduce(sr, x, grid, "row", 0).cpu().numpy()
    y = torch.arange(4, dtype=torch.float32, device=grid.device) * (grid.rank + 1)
    out["axis_reduce_scatter"] = axis_reduce_scatter(PLUS_TIMES, y, grid, "row", 0).cpu().numpy()
    xv = DistVec.from_global(grid, np.arange(N, dtype=np.float32), align="col")
    calls = {}
    for name in SPMAT_GUARDED:
        args = ([A],) if name == "col_concatenate" else ()
        target = SpParMat if name == "col_concatenate" else A
        calls[f"SpParMat.{name}"] = (lambda t=target, n=name, a=args: getattr(t, n)(*a))
    for name in VEC_GUARDED:
        if name == "randperm":
            calls["DistVec.randperm"] = lambda: DistVec.randperm(grid, N)
        else:
            calls[f"DistVec.{name}"] = (lambda n=name: getattr(xv, n)())
    for name, fn in _apps().items():
        calls[f"app.{name}"] = (lambda f=fn: f(A, xv, grid))
    for name, fn in calls.items():
        try:
            fn()
            out[f"guard/{name}"] = ("returned",)
        except LocalOnlyError as e:
            out[f"guard/{name}"] = ("LocalOnlyError", str(e))
        except Exception as e:  # noqa: BLE001 - recorded for the test's message
            out[f"guard/{name}"] = (type(e).__name__, str(e))
    out["stats"] = dict(multihost.STATS)
    return out


def global_grid(pr: int, pc: int, owners) -> Grid:
    """The grid over the ranks: ``owners`` where given, else
    ``make_global_grid``'s layout."""
    if owners is None:
        return multihost.make_global_grid(pr, pc)
    return multihost.grid_of_owners(pr, pc, owners)


def job(mm_path: str) -> dict:
    """A rank's run: ``compute`` on the global grids, then
    ``distributed_only`` on the round-robin 2x2 grid; ``k1_launches`` counts
    the semiring GEMM's launches of ``compute`` (on a card)."""
    semiring_matmul.launches = 0
    out = compute(global_grid, mm_path)
    out["k1_launches"] = semiring_matmul.launches
    for gname, (pr, pc, owners) in GRIDS.items():
        out[f"owners/{gname}"] = global_grid(pr, pc, owners).owners
    out["owners/1x3"] = multihost.make_global_grid(1, 3).owners
    out["refused/1x1"] = outcome(lambda: multihost.make_global_grid(1, 1))
    out["refused/owners"] = outcome(lambda: multihost.grid_of_owners(2, 2, (0, 0, 0, 0)))
    out.update(distributed_only(global_grid(2, 2, GRIDS["2x2rr"][2])))
    return out


def fail_on_rank_one() -> None:
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if multihost.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    multihost.all_reduce_(torch.zeros(1))


def one_process(mm_path: str, device: str = "cpu") -> dict:
    """``compute`` on one-process grids on ``device``."""
    return compute(lambda pr, pc, owners: Grid.make(pr, pc, device=device), mm_path)


def loaded_jax() -> list:
    """The ``jax*`` and ``combblas_tpu`` modules this rank has loaded after
    a ``dist_spmv`` on a grid over the ranks."""
    import sys

    grid = multihost.make_global_grid(2, 2)
    r, c, v = matrix("plus_times")
    A = SpParMat.from_global_coo(grid, r, c, v, N, N)
    dist_spmv(PLUS_TIMES, A, DistVec.from_global(grid, np.ones(N, np.float32)))
    return [m for m in sys.modules if m.startswith("jax")
            or m == "combblas_tpu" or m.startswith("combblas_tpu.")]
