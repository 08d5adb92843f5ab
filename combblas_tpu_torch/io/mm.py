"""Matrix Market, binary triple and vector I/O — counterpart of
``combblas_tpu/io/mm.py`` (≈ ParallelReadMM / ParallelWriteMM /
ParallelBinaryWrite, SpParMat.cpp:3980-4218, :620-714; vector
ParallelRead/Write, FullyDistSpVec.h:148-154).

Read path: the native C++ parser (``native/mmparse.cpp``, the port's copy
of the reference's, byte-range threaded: the FetchBatch scheme), built by
g++ at first use into build/combblas_tpu_torch/ (``_build.build_host``).
Unlike the reference, a failed build raises: there is no quiet numpy
fallback. Dense ``array`` files take the Python parser
(``_read_mm_python``), as in the reference. Symmetric/skew banners are
expanded to full storage, like the reference's reader.

Binary format (≈ FileHeader.h:109): 32-byte header
``b"CBTPUBIN" | uint64 nrows | uint64 ncols | uint64 nnz`` followed by
int64 rows, int64 cols, float64 vals arrays back to back.

Every writer writes the reference's bytes, and each package reads the
other's files.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

_MAGIC = b"CBTPUBIN"


def _load_native():
    """The built parser library (raises if it cannot be built)."""
    from .._build import load_host

    lib = load_host("mmparse")
    lib.mm_header.restype = ctypes.c_int
    lib.mm_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.mm_parse.restype = ctypes.c_int64
    lib.mm_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    return lib


def _read_mm_python(path):
    """The Python parser (header + body): the path of ``array`` files,
    and the native parser's cross-check.

    Handles both ``coordinate`` (sparse) and ``array`` (dense,
    column-major — ``src/mmio.c:60-70`` banner branch) formats; the dense
    body is converted to COO triplets of its NONZERO entries (this is a
    sparse library — explicit zeros in an array file carry no structure).
    """
    with open(path, "rb") as f:
        banner = f.readline().decode()
        assert banner.startswith("%%MatrixMarket"), f"not MatrixMarket: {path}"
        b = banner.lower()
        dense = "array" in b
        assert dense or "coordinate" in b, f"unknown MM format: {banner!r}"
        pattern = "pattern" in b
        assert not (dense and pattern), "array+pattern is invalid MatrixMarket"
        sym = (
            2 if "skew-symmetric" in b else 1 if "symmetric" in b
            else 3 if "hermitian" in b else 0
        )
        line = f.readline().decode()
        while line.startswith("%"):
            line = f.readline().decode()
        if dense:
            nrows, ncols = (int(x) for x in line.split()[:2])
            body = np.loadtxt(f, dtype=np.float64, ndmin=1).reshape(-1)
            if sym in (1, 2, 3):
                # packed lower triangle (incl. diagonal), column-major
                assert nrows == ncols, "symmetric array must be square"
                r_t, c_t = np.tril_indices(nrows)
                order = np.lexsort((r_t, c_t))  # column-major packing
                full = np.zeros((nrows, ncols), np.float64)
                full[r_t[order], c_t[order]] = body
            else:
                full = body.reshape((ncols, nrows)).T  # column-major
            rows, cols = np.nonzero(full)
            vals = full[rows, cols]
            return (rows.astype(np.int64), cols.astype(np.int64), vals,
                    nrows, ncols, sym)
        nrows, ncols, nnz = (int(x) for x in line.split()[:3])
        if pattern:
            data = np.loadtxt(f, dtype=np.int64, usecols=(0, 1), ndmin=2)
            rows, cols = data[:, 0] - 1, data[:, 1] - 1
            vals = np.ones(len(rows), np.float64)
        else:
            data = np.loadtxt(f, dtype=np.float64, usecols=(0, 1, 2), ndmin=2)
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            vals = data[:, 2]
    return rows, cols, vals, nrows, ncols, sym


def read_mm(path, *, expand_symmetric: bool = True, nthreads: int | None = None):
    """Parse a Matrix Market file: ``coordinate`` files with the native
    parser over ``nthreads`` byte ranges (default min(cores, 16); the
    output order does not depend on it), ``array`` files with the Python
    parser.

    Returns (rows, cols, vals, nrows, ncols): int64/int64/float64 arrays with
    symmetric/skew storage expanded to full (off-diagonal mirrored, negated
    for skew) when ``expand_symmetric``.
    """
    path = os.fspath(path)
    lib = _load_native()
    hdr = (ctypes.c_int64 * 6)()
    rc = lib.mm_header(path.encode(), hdr)
    if rc == 4:
        # the native parser is coordinate-only; dense "array" files take
        # the Python path (mmio.c:60-70 parity)
        rows, cols, vals, nrows, ncols, sym = _read_mm_python(path)
    elif rc != 0:
        raise ValueError(f"mm_header failed ({rc}) for {path}")
    else:
        nrows, ncols, nnz, _pattern, sym, _integer = (int(x) for x in hdr)
        rows = np.empty(max(nnz, 1), np.int64)
        cols = np.empty(max(nnz, 1), np.int64)
        vals = np.empty(max(nnz, 1), np.float64)
        nt = nthreads or min(os.cpu_count() or 1, 16)
        got = lib.mm_parse(
            path.encode(),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(rows),
            nt,
        )
        if got < 0:
            raise ValueError(f"mm_parse failed ({got}) for {path}")
        rows, cols, vals = rows[:got], cols[:got], vals[:got]

    if expand_symmetric and sym:
        rows, cols, vals = _expand_symmetric(rows, cols, vals, sym)
    return rows, cols, vals, nrows, ncols


def read_mm_spmat(grid, path, dtype=np.float32, dedup_sr=None, **kw):
    """read_mm → SpParMat on ``grid`` (the ParallelReadMM equivalent)."""
    from ..parallel.spmat import SpParMat

    rows, cols, vals, nrows, ncols = read_mm(path, **kw)
    return SpParMat.from_global_coo(
        grid, rows, cols, vals.astype(dtype), nrows, ncols, dedup_sr=dedup_sr
    )


def _expand_symmetric(rows, cols, vals, sym):
    """Mirror off-diagonal entries for symmetric (1) / skew (2) /
    hermitian-as-real (3) banners."""
    off = rows != cols
    mr, mc = cols[off], rows[off]
    mv = -vals[off] if sym == 2 else vals[off]
    return (
        np.concatenate([rows, mr]),
        np.concatenate([cols, mc]),
        np.concatenate([vals, mv]),
    )


def _mm_header_span(path):
    """(data_offset, nrows, ncols, nnz, pattern, sym) — the byte offset of
    the first data line plus the parsed size header."""
    with open(path, "rb") as f:
        banner = f.readline().decode()
        assert banner.startswith("%%MatrixMarket"), f"not MatrixMarket: {path}"
        b = banner.lower()
        assert "coordinate" in b, "only coordinate (sparse) format supported"
        pattern = "pattern" in b
        sym = (
            2 if "skew-symmetric" in b else 1 if "symmetric" in b
            else 3 if "hermitian" in b else 0
        )
        line = f.readline().decode()
        while line.startswith("%"):
            line = f.readline().decode()
        nrows, ncols, nnz = (int(x) for x in line.split()[:3])
        return f.tell(), nrows, ncols, nnz, pattern, sym


def read_mm_distributed(
    grid, path, dtype=np.float32, *, expand_symmetric: bool = True,
    dedup_sr=None,
):
    """Matrix Market read whose tuples reach their owner tiles on the
    device: the file is parsed whole (``read_mm``), cut into one chunk a
    tile in the grid's row-major tile order (padding slots (nrows, ncols,
    0)), uploaded as ``[pr, pc, chunk]`` arrays and routed by
    ``redistribute.from_device_coo``. This is the reference's
    single-process case; its byte-range read over several processes
    (``mm.py:238-338``) comes with the grids over several cards (ROADMAP
    item 12c). Returns an SpParMat on ``grid``.
    """
    from ..parallel.redistribute import from_device_coo

    _mm_header_span(path)  # the reference's header checks (coordinate only)
    rows, cols, vals, nrows, ncols = read_mm(path, expand_symmetric=expand_symmetric)
    ntiles = grid.size
    chunk = max(-(-len(rows) // ntiles), 1)
    pr_ = np.full((ntiles * chunk,), nrows, np.int64)
    pc_ = np.full((ntiles * chunk,), ncols, np.int64)
    pv_ = np.zeros((ntiles * chunk,), np.float64)
    pr_[: len(rows)], pc_[: len(rows)], pv_[: len(rows)] = rows, cols, vals
    shape = (grid.pr, grid.pc, chunk)

    def up(arr, dt):
        return torch.from_numpy(np.ascontiguousarray(arr.astype(dt)).reshape(shape)).to(grid.device)

    return from_device_coo(
        grid, up(pr_, np.int32), up(pc_, np.int32), up(pv_, dtype), nrows, ncols,
        dedup_sr=dedup_sr,
    )


def write_mm(path, mat, *, comment: str | None = None):
    """Write an SpParMat (or (rows, cols, vals, nrows, ncols)) as MM
    coordinate real general — the ``ParallelWriteMM`` equivalent."""
    if hasattr(mat, "to_global_coo"):
        rows, cols, vals = mat.to_global_coo()
        nrows, ncols = mat.nrows, mat.ncols
    else:
        rows, cols, vals, nrows, ncols = mat
    order = np.lexsort((rows, cols))  # column-major like the reference
    rows, cols, vals = rows[order], cols[order], vals[order]
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for ln in comment.splitlines():
                f.write(f"% {ln}\n")
        f.write(f"{nrows} {ncols} {len(rows)}\n")
    with open(path, "ab") as f:  # vectorized body append
        np.savetxt(
            f,
            np.column_stack(
                [rows + 1, cols + 1, np.asarray(vals, np.float64)]
            ),
            fmt="%d %d %.10g",
        )


def write_binary(path, mat):
    """Raw binary triple dump (≈ ParallelBinaryWrite, SpParMat.cpp:620-714)."""
    if hasattr(mat, "to_global_coo"):
        rows, cols, vals = mat.to_global_coo()
        nrows, ncols = mat.nrows, mat.ncols
    else:
        rows, cols, vals, nrows, ncols = mat
    with open(path, "wb") as f:
        f.write(_MAGIC)
        np.array([nrows, ncols, len(rows)], np.uint64).tofile(f)
        rows.astype(np.int64).tofile(f)
        cols.astype(np.int64).tofile(f)
        vals.astype(np.float64).tofile(f)


def read_binary(path):
    """Inverse of ``write_binary`` → (rows, cols, vals, nrows, ncols)."""
    with open(path, "rb") as f:
        assert f.read(8) == _MAGIC, f"bad magic in {path}"
        nrows, ncols, nnz = (int(x) for x in np.fromfile(f, np.uint64, 3))
        rows = np.fromfile(f, np.int64, nnz)
        cols = np.fromfile(f, np.int64, nnz)
        vals = np.fromfile(f, np.float64, nnz)
    return rows, cols, vals, nrows, ncols


def write_vec(path, vec, active=None):
    """Text "index value" dump of a DistVec (≈ FullyDistSpVec::ParallelWrite
    with 1-based ids). ``active`` (bool DistVec) selects a sparse subset."""
    x = vec.to_global()
    mask = (
        np.asarray(active.to_global(), bool)
        if active is not None
        else np.ones(len(x), bool)
    )
    with open(path, "w") as f:
        f.write(f"{len(x)} {int(mask.sum())}\n")
        for i in np.nonzero(mask)[0]:
            f.write(f"{i + 1} {x[i]}\n")


def read_vec(grid, path, dtype=np.float32, align="row", fill=0):
    """Inverse of ``write_vec`` → (DistVec, active bool DistVec)."""
    from ..parallel.vec import DistVec

    with open(path) as f:
        n, _nnz = (int(t) for t in f.readline().split()[:2])
        vals = np.full(n, fill, dtype)
        mask = np.zeros(n, bool)
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            raw = int(parts[0])
            if not (1 <= raw <= n):  # 1-based ids; reject instead of wrapping
                raise ValueError(
                    f"vector index {raw} out of range 1..{n} in {path}"
                )
            tok = parts[1]
            # Parse numerically first: np.bool_("False") is True (any
            # non-empty string is truthy), which silently corrupted bool
            # round-trips through write_vec.
            if tok in ("True", "False"):
                v = tok == "True"
            else:
                try:
                    v = int(tok)  # exact for int64-range values
                except ValueError:
                    v = float(tok)
                    if np.issubdtype(vals.dtype, np.integer):
                        # Keep the old loud failure: silently truncating
                        # 3.7 -> 3 into an int vector corrupts data.
                        raise ValueError(
                            f"non-integer value {tok!r} for integer dtype "
                            f"{vals.dtype} in {path}"
                        )
            vals[raw - 1] = v
            mask[raw - 1] = True
    return (
        DistVec.from_global(grid, vals, align=align, fill=fill),
        DistVec.from_global(grid, mask, align=align, fill=False),
    )
