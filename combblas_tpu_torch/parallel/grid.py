"""Grid — the pr×pc process grid (≈ CommGrid), counterpart of
``combblas_tpu/parallel/grid.py``.

The owner math is the reference's: every tile is ``ceil(m/pr) ×
ceil(n/pc)`` and the owner of global row r is ``r // local_rows``.

A one-process grid (``Grid.make``) lives on one device: a distributed
matrix is held as ``[pr, pc, ...]`` tile tensors there, and the tiles are
walked in a loop, so the 2×2 parity cases run in one process.

A grid over several processes (``multihost.make_global_grid``) gives every
tile an owner, one process per rank under ``torch.distributed``: ``owners``
holds the rank of each tile in row-major order, and a rank holds only its
own tiles, as ``[k, ...]`` tensors in ``owned_tiles()`` order
(``tile_index`` maps a tile to its slot, ``tiles_shape`` is the leading
shape). ``fold_grid`` then computes each rank's own tiles, exchanges the
partials and folds them in grid order on every rank, so its result is the
one-process grid's bit for bit. What this slice does not carry across
ranks raises ``LocalOnlyError`` naming its ROADMAP sub-item
(``require_local``, ``guard_distributed``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..semiring import Semiring, _maxval, _minval


#: The remaining sub-items of ROADMAP item 12c, in order: what raises
#: ``LocalOnlyError`` on a grid over several processes names one of them.
ROADMAP_12C = {
    1: "the ELL/BFS path across ranks, with axis_ring_reduce's ring",
    2: "spgemm_auto, its other tiers and the tuner across ranks",
    3: "the 3D tier across ranks",
    4: "apps and serving on a distributed grid",
    5: "sharded vectors in place of replicated ones",
    6: "an NCCL run on a machine with several cards",
}


class LocalOnlyError(NotImplementedError):
    """A call that does not run on a grid over several processes yet."""


def local_only_message(what: str, item: int) -> str:
    return (f"{what} does not run on a grid over several processes yet "
            f"(ROADMAP item 12c.{item}: {ROADMAP_12C[item]})")


@dataclasses.dataclass(frozen=True)
class HostGrid:
    """Device-free grid carrying only the owner math. ``owners``: the rank
    of each tile in row-major order, None when one process holds them all;
    ``rank``: this process's rank; ``world``: the number of ranks."""

    pr: int
    pc: int
    owners: tuple | None = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return self.pr * self.pc

    @property
    def is_distributed(self) -> bool:
        return self.world > 1

    def owner(self, i: int, j: int) -> int:
        """The rank that holds tile (i, j)."""
        return 0 if self.owners is None else self.owners[i * self.pc + j]

    def owned_tiles(self) -> list[tuple[int, int]]:
        """This rank's tiles in row-major order (every tile on one
        process)."""
        return [(i, j) for i in range(self.pr) for j in range(self.pc)
                if self.owner(i, j) == self.rank]

    @functools.cached_property
    def _slots(self) -> dict:
        return {t: k for k, t in enumerate(self.owned_tiles())}

    @property
    def tiles_shape(self) -> tuple:
        """Leading shape of a tile tensor: ``(pr, pc)`` on one process,
        ``(k,)`` for a rank's k tiles."""
        if not self.is_distributed:
            return (self.pr, self.pc)
        return (len(self._slots),)

    def tile_index(self, i: int, j: int):
        """The index of tile (i, j) in a tile tensor: ``(i, j)`` on one
        process, the tile's slot on its owner. A tile another rank holds
        raises ``LocalOnlyError``."""
        if not self.is_distributed:
            return (i, j)
        k = self._slots.get((i, j))
        if k is None:
            raise LocalOnlyError(local_only_message(
                f"reading tile ({i}, {j}) (held by rank {self.owner(i, j)}) on rank "
                f"{self.rank}", 4))
        return k

    def ranks_of(self, tiles) -> list[int]:
        """The ranks that hold any of ``tiles``, ascending."""
        return sorted({self.owner(i, j) for i, j in tiles})

    def row_ranks(self, i: int) -> list[int]:
        return self.ranks_of((i, j) for j in range(self.pc))

    def col_ranks(self, j: int) -> list[int]:
        return self.ranks_of((i, j) for i in range(self.pr))

    @property
    def is_square(self) -> bool:
        return self.pr == self.pc

    def local_rows(self, nrows: int) -> int:
        return -(-nrows // self.pr)

    def local_cols(self, ncols: int) -> int:
        return -(-ncols // self.pc)

    def row_owner(self, nrows: int, gr):
        return gr // self.local_rows(nrows)

    def col_owner(self, ncols: int, gc):
        return gc // self.local_cols(ncols)


@dataclasses.dataclass(frozen=True)
class Grid(HostGrid):
    """A pr×pc grid whose tiles live on ``device``."""

    device: torch.device = torch.device("cuda")

    @staticmethod
    def make(pr: int, pc: int, device: str | torch.device | None = None) -> "Grid":
        """A pr×pc grid on ``device`` (default: the current CUDA card).
        Raises when CUDA is asked for, explicitly or by default, and is
        absent; pass ``device="cpu"`` to run on the CPU."""
        if pr < 1 or pc < 1:
            raise ValueError(f"grid dims must be positive, got {pr}x{pc}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return Grid(pr=pr, pc=pc, device=dev)

    @staticmethod
    def make_default(n_devices: int | None = None,
                     device: str | torch.device | None = None) -> "Grid":
        """The squarest pr×pc grid of ``n_devices`` tiles (≈ CommGrid's
        √p×√p), pr the largest divisor of n at most √n. ``n_devices``
        defaults to the world size of ``torch.distributed`` (1 when it is
        not initialised): after ``multihost.init_distributed`` the grid is
        the global one (``multihost.make_global_grid``), else one process
        holds every tile on ``device``."""
        from . import multihost

        n = n_devices if n_devices is not None else multihost.world_size()
        pr = int(math.isqrt(n))
        while n % pr:
            pr -= 1
        if multihost.world_size() > 1:
            return multihost.make_global_grid(pr, n // pr)
        return Grid.make(pr, n // pr, device=device)


def require_local(grid, what: str, item: int) -> None:
    """Raise ``LocalOnlyError`` for ``what`` on a grid over several
    processes; nothing on one process."""
    if getattr(grid, "is_distributed", False):
        raise LocalOnlyError(local_only_message(what, item))


def _grid_in(args, kwargs):
    """The first grid among the arguments: a grid, an object with a
    ``grid``, or the first element of a list or tuple of those."""
    for v in (*args, *kwargs.values()):
        if isinstance(v, (list, tuple)) and v:
            v = v[0]
        if isinstance(v, HostGrid):
            return v
        g = getattr(v, "grid", None)
        if isinstance(g, HostGrid):
            return g
    return None


def guard_distributed(cls, carried, item: int = 4):
    """Make every public method of ``cls`` outside ``carried`` raise
    ``LocalOnlyError`` (ROADMAP item 12c.``item``) when its object or
    arguments are on a grid over several processes, so that none reads a
    rank's own tensors as if they held the whole grid. Properties are left
    as they are. On one process the methods run as before."""
    for name, attr in list(vars(cls).items()):
        if name.startswith("_") or name in carried:
            continue
        static = isinstance(attr, staticmethod)
        fn = attr.__func__ if static else attr
        if not callable(fn) or isinstance(attr, (property, functools.cached_property)):
            continue

        def make(fn=fn, what=f"{cls.__name__}.{name}"):
            @functools.wraps(fn)
            def guarded(*args, **kwargs):
                require_local(_grid_in(args, kwargs), what, item)
                return fn(*args, **kwargs)
            return guarded

        setattr(cls, name, staticmethod(make()) if static else make())
    return cls


def combine_tiles(sr: Semiring, ys) -> torch.Tensor:
    """Combine per-tile results ``ys`` (one a grid column or a grid row, in
    grid order) with ``sr.add``: the reference's ``axis_reduce`` as it runs
    on the CPU. A running sum, a running ``sr.add`` for a generic monoid,
    and for min and max a pass from the dtype's extreme that takes a value
    only where it is strictly better. So over two or more tiles a NaN drops
    out and the first of two equal zeros stays; one tile's value passes as
    it is."""
    acc = ys[0]
    if sr.add_kind in ("min", "max") and len(ys) > 1:
        better = torch.lt if sr.add_kind == "min" else torch.gt
        acc = torch.full_like(acc, (_maxval if sr.add_kind == "min" else _minval)(acc.dtype))
        for y in ys:
            acc = torch.where(better(y, acc), y, acc)
        return acc
    for y in ys[1:]:
        acc = sr.add(acc, y)
    return acc


def fold_grid(sr: Semiring, grid: HostGrid, local, active=None,
              down_cols: bool = False) -> torch.Tensor:
    """``local(i, j)`` for every tile, combined with ``combine_tiles`` over
    each grid row in column order: ``[pr, ...]`` row-aligned blocks, each
    tile's result first masked by the row block ``active[i]`` where given.
    ``down_cols``: combined over each grid column in row order instead,
    ``[pc, ...]`` col-aligned blocks (no mask).

    On a grid over several processes each rank computes ``local(i, j)``
    only for its own tiles (masked where ``active`` is given), the
    partials are exchanged (``multihost.gather_tiles``) and every rank
    folds all of them in grid order: the one-process result bit for bit,
    for every semiring, on every rank."""
    if getattr(grid, "is_distributed", False):
        from . import multihost

        def own(i, j):
            y = local(i, j)
            if active is not None and not down_cols:
                y = torch.where(active[i], y, sr.zero(y.dtype))
            return y

        ys = multihost.gather_tiles(grid, own)
        if down_cols:
            return torch.stack([combine_tiles(sr, [ys[i, j] for i in range(grid.pr)])
                                for j in range(grid.pc)])
        return torch.stack([combine_tiles(sr, [ys[i, j] for j in range(grid.pc)])
                            for i in range(grid.pr)])
    if down_cols:
        return torch.stack([combine_tiles(sr, [local(i, j) for i in range(grid.pr)])
                            for j in range(grid.pc)])
    out = []
    for i in range(grid.pr):
        ys = [local(i, j) for j in range(grid.pc)]
        if active is not None:
            ys = [torch.where(active[i], y, sr.zero(y.dtype)) for y in ys]
        out.append(combine_tiles(sr, ys))
    return torch.stack(out)


def check_length(A, x) -> None:
    """Raise unless the vector ``x`` has one slot per column of ``A``."""
    if x.length != A.ncols:
        raise ValueError(f"vector of length {x.length} for a matrix of {A.ncols} columns")
