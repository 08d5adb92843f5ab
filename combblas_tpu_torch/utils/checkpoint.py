"""Checkpoints of distributed objects as ``.npz`` — counterpart of the
first part of ``combblas_tpu/utils/checkpoint.py`` (``save``, ``load``,
``_restore_vec``, ``_npz_to_tuples``: ≈ ParallelBinaryWrite, rebuilt from
files as the reference does).

A file holds the tile arrays (``rows``, ``cols``, ``vals``, ``nnz`` of an
``SpParMat``; ``blocks`` of a ``DistVec``) and a ``__meta__`` JSON of the
kind, dims and grid, written by ``np.savez_compressed`` with the
reference's names, dtypes and JSON, so each package loads the other's
files. A load onto a grid of the saved shape puts the arrays on the
grid's device verbatim; onto another shape it rebuilds from global tuples.
The reference's orbax checkpoints (item 13a) and its version snapshots
(items 14 and 15) are not ported yet.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from ..parallel.grid import Grid
from ..parallel.spmat import SpParMat
from ..parallel.vec import DistVec


def _meta_of(obj) -> dict:
    if isinstance(obj, SpParMat):
        return {
            "kind": "SpParMat",
            "nrows": obj.nrows,
            "ncols": obj.ncols,
            "grid": [obj.grid.pr, obj.grid.pc],
        }
    if isinstance(obj, DistVec):
        meta = {
            "kind": "DistVec",
            "length": obj.length,
            "align": obj.align,
            "grid": [obj.grid.pr, obj.grid.pc],
        }
        # the padding fill, so that a load onto another grid shape pads as
        # the vector was padded (the last slot is padding when any is)
        pa, L = obj.blocks.shape
        if pa * L > obj.length:
            meta["fill"] = obj.blocks[-1, -1].item()
        return meta
    raise TypeError(f"unsupported checkpoint object: {type(obj)}")


def save(path: str, obj) -> None:
    """Write an ``SpParMat`` or ``DistVec`` as a ``.npz`` checkpoint."""
    meta = _meta_of(obj)
    arrays = (
        {"rows": obj.rows, "cols": obj.cols, "vals": obj.vals, "nnz": obj.nnz}
        if meta["kind"] == "SpParMat"
        else {"blocks": obj.blocks}
    )
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **{k: v.cpu().numpy() for k, v in arrays.items()},
    )


def load(path: str, grid: Grid, fill=None):
    """Load a ``.npz`` checkpoint onto ``grid``: the saved grid shape puts
    the tile arrays on the device as they are; another shape rebuilds the
    matrix from its global tuples (``SpParMat.from_global_coo``) or the
    vector from its values (``fill``, where given, overrides the saved
    padding fill)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["kind"] == "SpParMat":
            pr, pc = meta["grid"]
            if (pr, pc) == (grid.pr, grid.pc):
                return SpParMat(
                    rows=torch.from_numpy(z["rows"]).to(grid.device),
                    cols=torch.from_numpy(z["cols"]).to(grid.device),
                    vals=torch.from_numpy(z["vals"]).to(grid.device),
                    nnz=torch.from_numpy(z["nnz"]).to(grid.device),
                    nrows=meta["nrows"], ncols=meta["ncols"], grid=grid,
                )
            rows, cols, vals = _npz_to_tuples(z, meta)
            return SpParMat.from_global_coo(
                grid, rows, cols, vals, meta["nrows"], meta["ncols"]
            )
        if meta["kind"] == "DistVec":
            return _restore_vec(np.asarray(z["blocks"]), meta, grid, fill)
        raise TypeError(meta["kind"])


def _restore_vec(blocks: np.ndarray, meta: dict, grid: Grid,
                 fill_override=None) -> DistVec:
    """A DistVec from saved blocks. The same number of blocks: the padded
    blocks as they are (their padding keeps the fill the vector was built
    with). Another number: rebuilt from the values with the saved fill (or
    ``fill_override``; 0, with a warning, when neither exists)."""
    pr, pc = meta["grid"]
    pa = pr if meta["align"] == "row" else pc
    pa_now = grid.pr if meta["align"] == "row" else grid.pc
    if pa == pa_now and blocks.shape[0] == pa_now:
        return DistVec(
            blocks=torch.from_numpy(blocks).to(grid.device),
            length=meta["length"], align=meta["align"], grid=grid,
        )
    flat = blocks.reshape(-1)[: meta["length"]]
    fill = meta.get("fill", fill_override)
    if fill_override is not None:
        fill = fill_override
    if fill is None:
        warnings.warn(
            "cross-grid checkpoint restore: the saved vector had no padding "
            "slot to record its fill value; padding with 0. If the vector "
            "was built with a non-zero fill (e.g. -1 parents), pass "
            "fill=... to load().",
            stacklevel=3,
        )
        fill = 0
    return DistVec.from_global(
        grid, flat, align=meta["align"],
        fill=np.asarray(fill, dtype=blocks.dtype),
    )


def _npz_to_tuples(z, meta):
    """Stored tile arrays → global host (rows, cols, vals), tile by tile."""
    pr, pc = meta["grid"]
    R, C, V = z["rows"], z["cols"], z["vals"]
    lr = -(-meta["nrows"] // pr)
    lc = -(-meta["ncols"] // pc)
    rs, cs, vs = [], [], []
    for i in range(pr):
        for j in range(pc):
            m = R[i, j] < lr
            rs.append(R[i, j, m].astype(np.int64) + i * lr)
            cs.append(C[i, j, m].astype(np.int64) + j * lc)
            vs.append(V[i, j, m])
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)
