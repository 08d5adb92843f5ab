"""Checkpoints of distributed objects — counterpart of the ``.npz`` and
sharded parts of ``combblas_tpu/utils/checkpoint.py`` (``save``, ``load``,
``_restore_vec``, ``_npz_to_tuples``: ≈ ParallelBinaryWrite, rebuilt from
files as the reference does; ``save_sharded`` / ``load_sharded``, the
twins of ``save_orbax`` / ``load_orbax``).

A file holds the tile arrays (``rows``, ``cols``, ``vals``, ``nnz`` of an
``SpParMat``; ``blocks`` of a ``DistVec``) and a ``__meta__`` JSON of the
kind, dims and grid, written by ``np.savez_compressed`` with the
reference's names, dtypes and JSON, so each package loads the other's
files. A load onto a grid of the saved shape puts the arrays on the
grid's device verbatim; onto another shape it rebuilds from global tuples.

The sharded form (``save_sharded``) writes a directory: one ``torch.save``
file per tile of each array (``<name>.<i>.<j>.pt`` for an ``SpParMat``,
``blocks.<i>.pt`` for a ``DistVec``) and the reference's
``cbtpu_meta.json``. The reference writes the same arrays through orbax,
which the port does not use. The reference's version snapshots (ROADMAP
items 14 and 15) are not ported yet, and with them its three ``obs`` sites
(``serve.recovery.snapshot_rejected``, ``serve.checkpoint.save_s`` and
``serve.checkpoint.load_s``), which sit in ``load_latest_version``,
``save_version`` and ``load_version``; the ported parts have none.
"""

from __future__ import annotations

import json
import os
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


# --- sharded (one file per tile) ----------------------------------------------


_META_FILE = "cbtpu_meta.json"


def _tile_arrays(obj, meta: dict) -> dict:
    if meta["kind"] == "SpParMat":
        return {"rows": obj.rows, "cols": obj.cols, "vals": obj.vals, "nnz": obj.nnz}
    return {"blocks": obj.blocks}


def save_sharded(path: str, obj) -> None:
    """Write an ``SpParMat`` or ``DistVec`` into the directory ``path``:
    one ``torch.save`` file per tile of each array and the
    ``cbtpu_meta.json`` sidecar. Twin of the reference's ``save_orbax``
    (which writes the same arrays through orbax)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = _meta_of(obj)
    for name, arr in _tile_arrays(obj, meta).items():
        for idx in np.ndindex(*arr.shape[: 2 if meta["kind"] == "SpParMat" else 1]):
            # clone: torch.save of a view writes its whole storage
            torch.save(arr[idx].detach().clone().cpu(),
                       os.path.join(path, ".".join([name, *map(str, idx)]) + ".pt"))
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


def _load_tiles(path: str, name: str, lead: tuple, device) -> torch.Tensor:
    tiles = [torch.load(os.path.join(path, ".".join([name, *map(str, idx)]) + ".pt"),
                        map_location=device, weights_only=True)
             for idx in np.ndindex(*lead)]
    return torch.stack(tiles).reshape(*lead, *tiles[0].shape)


def load_sharded(path: str, grid: Grid, fill=None):
    """Load a ``save_sharded`` directory onto ``grid``: an ``SpParMat``
    onto a grid of the saved shape only (the reference's ``load_orbax``
    rule; ``save`` / ``load`` restore across shapes), a ``DistVec`` onto
    any grid through ``_restore_vec``."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    pr, pc = meta["grid"]
    if meta["kind"] == "SpParMat":
        if meta["grid"] != [grid.pr, grid.pc]:
            raise ValueError(
                "orbax path restores onto the same grid shape; use save/load "
                "(.npz) for cross-shape restore"
            )
        arrays = {name: _load_tiles(path, name, (pr, pc), grid.device)
                  for name in ("rows", "cols", "vals", "nnz")}
        return SpParMat(**arrays, nrows=meta["nrows"], ncols=meta["ncols"], grid=grid)
    if meta["kind"] == "DistVec":
        pa = pr if meta["align"] == "row" else pc
        blocks = _load_tiles(path, "blocks", (pa,), "cpu").numpy()
        return _restore_vec(blocks, meta, grid, fill)
    raise TypeError(meta["kind"])
