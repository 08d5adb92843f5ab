"""Distributed dense vectors (≈ FullyDistVec) — counterpart of
``combblas_tpu/parallel/vec.py``.

A vector is held as ``[pa, L]`` blocks (``DistMultiVec``: ``[pa, L, W]``
for W stacked vectors) on the grid's device, ``L = ceil(length / pa)``:

  * ``"col"``-aligned: ``pa = pc``, block j belongs to grid column j (what
    a product consumes);
  * ``"row"``-aligned: ``pa = pr``, block i belongs to grid row i (what a
    product produces).

A grid lives on one device, so ``realign`` moves no data between devices:
on a square grid block i of one alignment is block i of the other, and
on a rectangular grid the flattened blocks are zero-padded and cut anew.
Padding slots (past ``length``) must hold values that are inert for the
ops applied to them.

The op pack (``apply`` … ``randperm``, ``concatenate``) works on the
flattened blocks, as the reference's does on its global view. Every op but
``randperm`` gives the reference's blocks bit for bit: ``sort`` and
``uniq`` order floats as ``lax.sort`` does (-inf, …, ±0.0 as one value,
…, +inf, then every NaN as one value) through an order-preserving integer
key of their bits, and ties keep the slot order. ``randperm`` gives the
reference's permutation when it takes a threefry key; a
``torch.Generator`` gives another one.
Scatters that the reference runs with ``mode="drop"`` send the dropped
slots to a spread of sink slots past the end, cut off afterwards
(``segment_reduce_dropping``).

On a grid over several processes a vector's ``[pa, L]`` blocks are
replicated on every rank: ``from_global``, ``full`` and ``iota`` make
them whole on each rank, ``to_global`` reads the rank's copy and
``realign`` stays local. That costs n slots a rank where the reference
holds n/pr (its blocks sharded over a mesh axis); sharded vectors are
ROADMAP item 12c.5. The op pack (``apply`` ... ``randperm``) and
``concatenate`` raise ``LocalOnlyError`` there (item 12c.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.segment import float_bits, fold_dim, segment_reduce_dropping
from ..semiring import PLUS_TIMES, Semiring
from ..utils import threefry
from ..utils.threefry import ThreefryKey
from .grid import Grid, combine_tiles, guard_distributed, require_local


def _nblocks(grid: Grid, align: str) -> int:
    if align not in ("row", "col"):
        raise ValueError(f"align must be 'row' or 'col', got {align!r}")
    return grid.pr if align == "row" else grid.pc


def _reblock(blocks: torch.Tensor, grid: Grid, align: str) -> torch.Tensor:
    """``blocks`` ([pa, L, ...]) cut into the blocks of ``align``."""
    dst_pa = _nblocks(grid, align)
    if grid.is_square:
        return blocks
    tail = blocks.shape[2:]
    full = blocks.reshape(-1, *tail)
    L = -(-full.shape[0] // dst_pa)
    pad = dst_pa * L - full.shape[0]
    if pad:
        full = torch.cat([full, full.new_zeros((pad, *tail))])
    return full.reshape(dst_pa, L, *tail)


@dataclasses.dataclass(frozen=True)
class DistVec:
    """Dense distributed vector: ``blocks[pa, L]``."""

    blocks: torch.Tensor
    length: int
    align: str  # "row" | "col"
    grid: Grid

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_len(self) -> int:
        return self.blocks.shape[1]

    @staticmethod
    def from_global(grid: Grid, x, align: str = "col", fill=0) -> "DistVec":
        x = np.asarray(x)
        pa = _nblocks(grid, align)
        L = -(-x.shape[0] // pa)
        out = np.full((pa * L,), fill, dtype=x.dtype)
        out[: x.shape[0]] = x
        return DistVec(
            blocks=torch.from_numpy(out.reshape(pa, L)).to(grid.device),
            length=int(x.shape[0]), align=align, grid=grid,
        )

    @staticmethod
    def full(grid: Grid, length: int, value, dtype, align: str = "col") -> "DistVec":
        pa = _nblocks(grid, align)
        L = -(-length // pa)
        blocks = torch.full((pa, L), value, dtype=dtype, device=grid.device)
        return DistVec(blocks=blocks, length=length, align=align, grid=grid)

    @staticmethod
    def iota(grid: Grid, length: int, dtype=torch.int32, align: str = "col") -> "DistVec":
        """Reference: ``FullyDistVec::iota`` (padding slots count on)."""
        pa = _nblocks(grid, align)
        L = -(-length // pa)
        vals = torch.arange(pa * L, dtype=dtype, device=grid.device).reshape(pa, L)
        return DistVec(blocks=vals, length=length, align=align, grid=grid)

    def to_global(self) -> np.ndarray:
        return self.blocks.cpu().numpy().reshape(-1)[: self.length]

    def realign(self, align: str) -> "DistVec":
        if align == self.align:
            return self
        return DistVec(
            blocks=_reblock(self.blocks, self.grid, align),
            length=self.length, align=align, grid=self.grid,
        )

    def _with(self, blocks: torch.Tensor) -> "DistVec":
        return dataclasses.replace(self, blocks=blocks)

    def _gids(self) -> torch.Tensor:
        return torch.arange(self.blocks.numel(), dtype=torch.int32, device=self.blocks.device)

    # --- elementwise ------------------------------------------------------

    def apply(self, fn) -> "DistVec":
        """``fn`` on the blocks. Reference: ``FullyDistVec::Apply``."""
        return self._with(fn(self.blocks))

    def ewise(self, other: "DistVec", fn) -> "DistVec":
        """``fn(self, other)`` blockwise; alignments and lengths must match."""
        if (self.align, self.length) != (other.align, other.length):
            raise ValueError(f"ewise of a {self.align} vector of {self.length} with a "
                             f"{other.align} vector of {other.length}")
        return self._with(fn(self.blocks, other.blocks))

    def mask_padding(self, fill) -> "DistVec":
        """Padding slots (global index >= length) set to ``fill``."""
        gids = self._gids().view(self.blocks.shape)
        return self._with(torch.where(gids < self.length, self.blocks, fill))

    # --- indirect addressing ----------------------------------------------

    def gather(self, idx: "DistVec") -> "DistVec":
        """``out[k] = self[idx[k]]``, aligned like ``idx``. The index is
        clipped to the padded blocks, so an index out of ``[0, length)`` (and
        idx's own padding) reads some slot: callers mask those results."""
        full = self.blocks.reshape(-1)
        safe = torch.clamp(idx.blocks, 0, full.shape[0] - 1).long()
        return DistVec(blocks=full[safe], length=idx.length, align=idx.align, grid=idx.grid)

    def scatter_combine(self, sr: Semiring, idx: "DistVec", src: "DistVec") -> "DistVec":
        """``out[p] = sr.add(self[p], ⊕{src[k] : idx[k] == p})``: the
        padding slots of ``idx`` and ids outside ``[0, length)`` drop out,
        untouched slots keep their value (their fold is ``sr.zero``).
        Reference: ``FullyDistVec::ReduceAssign``."""
        if (idx.align, idx.length) != (src.align, src.length):
            raise ValueError("scatter_combine: idx and src must share alignment and length")
        n = self.blocks.numel()
        ids = idx.blocks.reshape(-1)
        pos = torch.arange(ids.shape[0], device=ids.device)
        keep = (pos < idx.length) & (ids >= 0) & (ids < self.length)
        contrib = segment_reduce_dropping(sr, src.blocks.reshape(-1), ids, keep, n)
        return self._with(sr.add(self.blocks.reshape(-1), contrib).view(self.blocks.shape))

    def reduce(self, sr: Semiring) -> torch.Tensor:
        """Fold of every slot with ``sr.add`` (a 0-dim tensor; padding must
        hold the identity): each block folded, then the blocks combined in
        order as the reference's cross-device reduction does on the CPU
        (``grid.combine_tiles``: over two or more blocks a min or max drops
        a NaN block result and keeps the first of equal zeros). Sums keep
        the blocks' dtype (bool counts as int32); a block's float min or
        max gives the reference's signed zeros. Reference:
        ``FullyDistVec::Reduce``."""
        return combine_tiles(sr, list(fold_dim(sr, self.blocks, 1)))

    # --- the sort / find / permute family ---------------------------------

    def sort(self) -> tuple["DistVec", "DistVec"]:
        """Ascending sort: (sorted values, their original global indices);
        padding slots go last whatever their value. Reference:
        ``FullyDistVec::sort``."""
        flat = self.blocks.reshape(-1)
        gids = self._gids()
        order = _lexsort([gids >= self.length, _order_key(flat)])
        return self._with(flat[order].view(self.blocks.shape)), \
            self._with(gids[order].view(self.blocks.shape))

    def find_inds(self, pred) -> tuple["DistVec", torch.Tensor]:
        """The global indices i < length (ascending) where ``pred(self[i])``,
        in a vector of the same blocks whose tail holds ``length``, and
        their count (0-dim int32). Reference: ``FullyDistVec::FindInds``."""
        flat = self.blocks.reshape(-1)
        mask = pred(flat) & (self._gids() < self.length)
        hits = torch.nonzero(mask).squeeze(1).to(torch.int32)
        out = torch.full_like(self._gids(), self.length)
        out[: hits.shape[0]] = hits
        return self._with(out.view(self.blocks.shape)), mask.sum(dtype=torch.int32)

    def invert(self, active: "DistVec", out_length: int, sr: Semiring) -> "DistVec":
        """``out[self[i]] = i`` for the active slots i; collisions resolve by
        ``sr.add``; untouched outputs are -1. The output has ``out_length``
        slots in blocks of ``ceil(out_length / pa)``. Reference:
        ``FullyDistSpVec::Invert``."""
        pa = self.blocks.shape[0]
        n = pa * -(-out_length // pa)
        flat = self.blocks.reshape(-1).to(torch.int32)
        gids = self._gids()
        ok = active.blocks.reshape(-1) & (gids < self.length)
        keep = ok & (flat >= 0) & (flat < out_length)
        contrib = segment_reduce_dropping(sr, gids, flat, keep, n)
        touched = segment_reduce_dropping(PLUS_TIMES, keep.to(torch.int32), flat, keep, n) > 0
        out = torch.where(touched, contrib, -1)
        return DistVec(blocks=out.view(pa, -1), length=out_length, align=self.align,
                       grid=self.grid)

    def uniq(self, active: "DistVec") -> "DistVec":
        """The active mask cut to the first occurrence of each value among
        the active slots (by value, then index). Reference:
        ``FullyDistSpVec::Uniq``; set difference is mask arithmetic,
        ``a & ~b``."""
        flat = self.blocks.reshape(-1)
        gids = self._gids()
        ok = active.blocks.reshape(-1) & (gids < self.length)
        order = _lexsort([~ok, _order_key(flat)])
        vals = flat[order]
        first = torch.ones_like(ok)
        first[1:] = vals[1:] != vals[:-1]
        keep_sorted = first & (torch.arange(ok.shape[0], device=ok.device) < ok.sum())
        keep = torch.zeros_like(ok)
        keep[order] = keep_sorted
        return active._with(keep.view(active.blocks.shape))

    @staticmethod
    def randperm(grid: Grid, length: int,
                 generator: "torch.Generator | ThreefryKey | None" = None,
                 align: str = "col") -> "DistVec":
        """A uniform random permutation of ``[0, length)``, the padding slots
        after it in order. Reference: ``FullyDistVec::RandPerm``.

        With a threefry key (``utils.threefry.ThreefryKey``) it is the
        reference's permutation bit for bit: the key splits in two, each
        half draws 32 bits a slot, and the slots sort by (padding last,
        first draw, second draw), stably. With a ``torch.Generator`` (or
        None: the default generator of the grid's device) it is
        ``torch.randperm`` on the generator's device, another permutation."""
        v = DistVec.iota(grid, length, torch.int32, align=align)
        if isinstance(generator, ThreefryKey):
            k1, k2 = threefry.split(generator)
            n = v.blocks.numel()
            dev = v.blocks.device
            pad = (v._gids() >= length).to(torch.int64)
            order = _lexsort([pad, threefry.bits(k1, (n,), dev), threefry.bits(k2, (n,), dev)])
            return v._with(v.blocks.reshape(-1)[order].view(v.blocks.shape))
        gen_dev = generator.device if generator is not None else v.blocks.device
        head = torch.randperm(length, generator=generator, device=gen_dev)
        flat = v.blocks.reshape(-1).clone()
        flat[:length] = head.to(device=flat.device, dtype=flat.dtype)
        return v._with(flat.view(v.blocks.shape))


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is ``lax.sort``'s order of ``v``: integers as
    they are; floats by their bits with the negative half flipped, after
    the reference's canonicalisation (-0.0 sorts as +0.0, every NaN as one
    value after +inf)."""
    if not v.is_floating_point():
        return v.long()
    v = torch.where(v == 0, 0.0, v).to(v.dtype)
    v = torch.where(v.isnan(), float("nan"), v).to(v.dtype)
    bits = float_bits(v).long()
    width = 8 * v.element_size()
    key = torch.where(bits < 0, bits ^ ((1 << (width - 1)) - 1), bits)
    return torch.where(v.isnan(), torch.iinfo(torch.int64).max, key)


def _lexsort(keys) -> torch.Tensor:
    """The permutation that sorts by ``keys`` (most significant first),
    ties in slot order: stable sorts from the least significant key up."""
    order = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order].to(torch.int64), stable=True).indices]
    return order


def concatenate(vecs, grid: Grid | None = None, align: str | None = None, fill=0) -> DistVec:
    """The vectors one after another (``Concatenate``, ParFriends.h): each
    one's blocks flattened and cut to its length, joined, padded with
    ``fill`` and laid out on ``grid`` (default: the first vector's) in
    ``align`` (default: the first vector's). Every grid lives on one device:
    the result moves to the target grid's."""
    if not vecs:
        raise ValueError("concatenate needs at least one vector")
    require_local(grid or vecs[0].grid, "concatenate", 4)
    grid = grid or vecs[0].grid
    align = align or vecs[0].align
    pa = _nblocks(grid, align)
    flat = torch.cat([v.blocks.reshape(-1)[: v.length].to(grid.device) for v in vecs])
    total = flat.shape[0]
    L = -(-total // pa)
    flat = torch.cat([flat, flat.new_full((pa * L - total,), fill)])
    return DistVec(blocks=flat.view(pa, L), length=total, align=align, grid=grid)


#: What a grid over several processes carries of ``DistVec``: the
#: replicated blocks' constructors, ``to_global`` and ``realign``.
CARRIED = frozenset({"from_global", "full", "iota", "to_global", "realign"})
guard_distributed(DistVec, CARRIED)


@dataclasses.dataclass(frozen=True)
class DistMultiVec:
    """W stacked distributed vectors: ``blocks[pa, L, W]`` — the carrier of
    batched frontiers. Same alignment and padding contract as DistVec."""

    blocks: torch.Tensor
    length: int
    align: str  # "row" | "col"
    grid: Grid

    @property
    def width(self) -> int:
        return self.blocks.shape[2]

    @property
    def block_len(self) -> int:
        return self.blocks.shape[1]

    @staticmethod
    def from_global(grid: Grid, x, align: str = "col", fill=0) -> "DistMultiVec":
        """x: [length, W] host array."""
        x = np.asarray(x)
        n, W = x.shape
        pa = _nblocks(grid, align)
        L = -(-n // pa)
        out = np.full((pa * L, W), fill, dtype=x.dtype)
        out[:n] = x
        return DistMultiVec(
            blocks=torch.from_numpy(out.reshape(pa, L, W)).to(grid.device),
            length=int(n), align=align, grid=grid,
        )

    def to_global(self) -> np.ndarray:
        b = self.blocks.cpu().numpy()
        return b.reshape(-1, b.shape[2])[: self.length]

    def realign(self, align: str) -> "DistMultiVec":
        if align == self.align:
            return self
        return DistMultiVec(
            blocks=_reblock(self.blocks, self.grid, align),
            length=self.length, align=align, grid=self.grid,
        )
