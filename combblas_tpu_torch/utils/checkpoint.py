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
which the port does not use.

The serve ``GraphVersion`` snapshots (``save_version``, ``load_version``,
``load_latest_version``, the ``ckpt-*.npz`` naming and listing) write the
reference's ``.npz`` layout under its schema tag: the bucket arrays as
built (sticky slots and headroom padding included), the degree tables,
the dangling and feature blocks, the retained COO, and a JSON meta with
the WAL frontier. A snapshot either package writes loads in the other,
bucket arrays equal bit for bit. Two differences: the port writes the
archive uncompressed (``np.savez``: a scale-18 snapshot took 0.60 s for
277 MB on an H100's host, where ``savez_compressed``, the reference's,
took 15.28 s for 66 MB: 4.2 times the disk for every retained snapshot),
and where the reference places a restored array
with a ``NamedSharding``, the port puts it on the grid's device.
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


# --- GraphVersion snapshots (the serving fleet's warm start) --------------

#: Schema tag of ``save_version`` snapshots; a mismatched tag is refused at
#: load (the reference's tag, so each package loads the other's files).
VERSION_SCHEMA = "combblas_tpu.graph_version/v1"

#: The EllParMat fields of a GraphVersion, in a fixed serialization
#: order (absent twins are recorded as null bucket counts).
_VERSION_MATS = ("E", "E_weighted", "P_ell", "ET")


class SnapshotError(ValueError):
    """A snapshot that must not be loaded: corrupt, truncated, wrong
    schema, or wrong grid.  The message names the file — and
    ``load_latest_version`` treats any instance as "fall back to the
    previous retained snapshot"."""


def snapshot_name(wal_seq: int) -> str:
    """Canonical snapshot file name for a version at WAL frontier
    ``wal_seq``: zero-padded so lexicographic order IS recovery order."""
    return f"ckpt-{int(wal_seq) + 1:012d}.npz"


def snapshot_seq(path: str) -> int:
    """The ``wal_seq`` stamp encoded in a snapshot's file name (the
    inverse of ``snapshot_name``; no file read)."""
    name = os.path.basename(path)
    return int(name[len("ckpt-"):-len(".npz")]) - 1


def list_snapshots(dirpath: str) -> list[str]:
    """Retained ``save_version`` snapshots in ``dirpath``, OLDEST first
    (an in-flight atomic write, ``*.npz.tmp``, is not a snapshot)."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    return sorted(
        os.path.join(dirpath, nm) for nm in names
        if nm.startswith("ckpt-") and nm.endswith(".npz")
        and ".tmp" not in nm
    )


def load_latest_version(dirpath: str, grid, *, writable: bool = True):
    """The newest LOADABLE snapshot in ``dirpath`` as ``(version,
    path)`` — a corrupt/truncated newest file falls back to the previous
    retained snapshot with a warning naming the bad file.  A file that
    VANISHES between listing and open (a sibling's pruner) is skipped
    silently, and the directory is re-listed once.  Raises
    ``dynamic.wal.RecoveryError`` when no candidate loads."""
    candidates = []
    errors = []
    for _attempt in (0, 1):
        candidates = list_snapshots(dirpath)
        vanished = 0
        for path in reversed(candidates):
            try:
                return load_version(path, grid, writable=writable), path
            except FileNotFoundError:
                vanished += 1
                continue
            except SnapshotError as e:
                errors.append(str(e))
                from .. import obs

                obs.count("serve.recovery.snapshot_rejected")
                warnings.warn(
                    f"skipping unloadable snapshot (falling back to "
                    f"the previous retained one): {e}",
                    stacklevel=2,
                )
        if vanished == 0:
            break  # a re-list cannot surface anything new
    from ..dynamic.wal import RecoveryError

    raise RecoveryError(
        f"no loadable GraphVersion snapshot in {dirpath!r} "
        f"({len(candidates)} candidate(s)"
        + (f"; errors: {errors}" if errors else "")
        + ")"
    )


def save_version(path: str, version, *, extra_meta: dict | None = None) -> None:
    """Snapshot a serve ``GraphVersion`` to one self-describing .npz.

    The BUCKET ARRAYS are persisted exactly as built — per-class
    cols/vals/rowids including the headroom padding rows — so
    ``load_version`` re-uploads identical shapes with
    ``EllParMat.from_host_buckets`` (one upload per array, no dedup
    sort, no host bucket pass).  The host COO/weights ride along when
    the version retained them (``keep_coo=True``), so a restored
    version can still take merges.

    The write is ATOMIC — the .npz lands in a sibling tmp file, is
    fsynced and ``os.replace``d into place — and the version's WAL
    position (``version.wal_seq``) is stamped into the meta, so recovery
    replays exactly the log suffix this snapshot does not contain.
    ``extra_meta``: a JSON-able dict stored under ``meta["extra"]`` and
    surfaced as ``version.extra_meta`` on load.
    """
    import time

    from .. import obs

    t0 = time.perf_counter()
    meta = {
        "kind": "GraphVersion",
        "v": VERSION_SCHEMA,
        "nrows": int(version.nrows),
        "ncols": int(version.ncols),
        "nnz": int(version.nnz),
        "feat_dim": int(version.feat_dim),
        "headroom": version.headroom,
        "wal_seq": int(getattr(version, "wal_seq", -1)),
        "grid": [version.E.grid.pr, version.E.grid.pc],
        "mats": {},
    }
    if extra_meta is not None:
        meta["extra"] = extra_meta
    arrays: dict = {"deg": np.asarray(version.deg)}
    if version.outdeg is not None:
        arrays["outdeg"] = np.asarray(version.outdeg)
    for nm in _VERSION_MATS:
        M = getattr(version, nm)
        if M is None:
            meta["mats"][nm] = None
            continue
        meta["mats"][nm] = {
            "nbuckets": len(M.buckets),
            "nrows": int(M.nrows),
            "ncols": int(M.ncols),
        }
        for i, (bc, bv, br) in enumerate(M.buckets):
            arrays[f"{nm}.{i}.c"] = bc.cpu().numpy()
            arrays[f"{nm}.{i}.v"] = bv.cpu().numpy()
            arrays[f"{nm}.{i}.r"] = br.cpu().numpy()
    if version.dangling is not None:
        arrays["dangling"] = version.dangling.blocks.cpu().numpy()
    if version.X is not None:
        arrays["X"] = version.X.blocks.cpu().numpy()
    if version.host_coo is not None:
        rows, cols, _nc = version.host_coo
        arrays["coo_rows"] = np.asarray(rows)
        arrays["coo_cols"] = np.asarray(cols)
        if version.host_weights is not None:
            arrays["coo_weights"] = np.asarray(version.host_weights)
    # atomic: write a sibling tmp (same filesystem) through a FILE OBJECT
    # so np.savez cannot append its own .npz suffix, fsync, then replace;
    # uncompressed (module docstring)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                **arrays,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    obs.observe("serve.checkpoint.save_s", time.perf_counter() - t0)


def load_version(path: str, grid: Grid, *, writable: bool = True):
    """Restore a ``save_version`` snapshot onto ``grid`` (the SAME grid
    shape only) as a ``GraphVersion`` ready for ``GraphEngine(grid,
    version=...)`` or ``engine.swap()``: one upload per persisted array.

    ``writable=False`` skips retaining the host bucket arrays the lazy
    merge-state derivation needs (a read-only replica never merges).
    A corrupt or truncated file is REFUSED with a ``SnapshotError``
    naming it — never half-loaded.
    """
    try:
        return _load_version(path, grid, writable)
    except SnapshotError:
        raise  # already diagnostic (schema / grid mismatch)
    except FileNotFoundError:
        # vanished between listing and open: not corruption
        raise
    except Exception as e:
        raise SnapshotError(
            f"refusing corrupt or truncated GraphVersion snapshot "
            f"{path!r}: {type(e).__name__}: {e}"
        ) from e


def _load_version(path: str, grid: Grid, writable: bool = True):
    import time

    from .. import obs
    from ..parallel.ellmat import EllParMat
    from ..parallel.vec import DistMultiVec
    from ..serve.engine import GraphVersion

    t0 = time.perf_counter()
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("v") != VERSION_SCHEMA:
            raise SnapshotError(
                f"{path!r} is not a GraphVersion snapshot (schema "
                f"{meta.get('v')!r} != {VERSION_SCHEMA!r})"
            )
        pr, pc = meta["grid"]
        if (pr, pc) != (grid.pr, grid.pc):
            raise SnapshotError(
                f"snapshot was taken on a {pr}x{pc} grid; load_version "
                f"restores onto the SAME grid shape (got {grid.pr}x"
                f"{grid.pc}) — rebuild from COO to re-shard"
            )
        mats = {}
        host_mats = {}  # host (bc, bv, br) triples for the merge state
        for nm in _VERSION_MATS:
            info = meta["mats"].get(nm)
            if info is None:
                mats[nm] = None
                continue
            host_buckets = [
                (z[f"{nm}.{i}.c"], z[f"{nm}.{i}.v"], z[f"{nm}.{i}.r"])
                for i in range(info["nbuckets"])
            ]
            host_mats[nm] = host_buckets
            mats[nm] = EllParMat.from_host_buckets(
                grid, host_buckets, info["nrows"], info["ncols"]
            )
        dangling = None
        if "dangling" in z:
            dangling = DistVec(
                blocks=torch.from_numpy(z["dangling"]).to(grid.device),
                length=meta["ncols"], align="col", grid=grid,
            )
        X = None
        if "X" in z:
            X = DistMultiVec(
                blocks=torch.from_numpy(z["X"]).to(grid.device),
                length=meta["ncols"], align="row", grid=grid,
            )
        host_coo = None
        host_weights = None
        if "coo_rows" in z:
            host_coo = (
                np.asarray(z["coo_rows"]), np.asarray(z["coo_cols"]),
                meta["ncols"],
            )
            if "coo_weights" in z:
                host_weights = np.asarray(z["coo_weights"])
        deg_host = np.asarray(z["deg"])
        outdeg_host = np.asarray(z["outdeg"]) if "outdeg" in z else None
    version = GraphVersion(
        nrows=meta["nrows"], ncols=meta["ncols"], nnz=meta["nnz"],
        E=mats["E"], deg=deg_host, outdeg=outdeg_host,
        E_weighted=mats["E_weighted"], P_ell=mats["P_ell"],
        dangling=dangling, ET=mats["ET"],
        host_coo=host_coo, host_weights=host_weights,
        X=X, feat_dim=meta["feat_dim"], headroom=meta["headroom"],
        wal_seq=int(meta.get("wal_seq", -1)),
    )
    version.extra_meta = meta.get("extra")
    if host_coo is not None and writable:
        # the merge state must describe the RESTORED bucket layout,
        # sticky slots included (a fresh host_build of the COO would
        # patch against the wrong slot map); derived LAZILY on the first
        # merge, so read-only loads pay nothing for it
        e_buckets = host_mats["E"]
        t_buckets = host_mats.get("ET")

        def _dyn_source():
            from ..dynamic.merge import state_from_host_buckets

            return state_from_host_buckets(
                grid, e_buckets, t_buckets, host_coo,
                host_weights, deg_host, outdeg_host,
            )

        version.dyn_source = _dyn_source
    obs.observe("serve.checkpoint.load_s", time.perf_counter() - t0)
    return version
