"""String-labeled tuple ingestion (≈ ReadGeneralizedTuples) — counterpart
of ``combblas_tpu/io/labels.py``.

The reference reads "label1 label2 [value]" triples (e.g. HipMCL protein
networks), hashes the labels (``hash.cpp`` MurmurHash), performs a
distributed relabeling to dense integer ids, and returns the permutation
alongside the matrix (``SpParMat.h:286-287``, ``TupleRead1stPassNExchange``).
Host counterpart: stable first-appearance interning (the role the
hash+exchange plays), returning (matrix, labels list, label→id dict).
"""

from __future__ import annotations

import numpy as np


def read_labeled_tuples(path, *, default_value: float = 1.0):
    """Parse "src dst [weight]" lines with string vertex labels.

    Returns (rows, cols, vals, labels): integer ids are assigned by first
    appearance (deterministic for a given file — the analog of the
    reference's deterministic relabeling), ``labels[i]`` is the string for
    id i.
    """
    ids: dict[str, int] = {}
    rows, cols, vals = [], [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith(("%", "#")):
                continue
            if len(parts) < 2:
                raise ValueError(
                    f"{path}:{lineno}: expected 'src dst [weight]', "
                    f"got {line.strip()!r}"
                )
            a, b = parts[0], parts[1]
            w = float(parts[2]) if len(parts) > 2 else default_value
            ia = ids.setdefault(a, len(ids))
            ib = ids.setdefault(b, len(ids))
            rows.append(ia)
            cols.append(ib)
            vals.append(w)
    labels = [None] * len(ids)
    for s, i in ids.items():
        labels[i] = s
    return (
        np.asarray(rows, np.int64),
        np.asarray(cols, np.int64),
        np.asarray(vals, np.float64),
        labels,
    )


def read_labeled_spmat(grid, path, dtype=np.float32, symmetrize=False,
                       dedup_sr=None):
    """read_labeled_tuples → (SpParMat over ``grid``, labels).

    ``symmetrize`` mirrors each edge (the HipMCL default for undirected
    protein networks, MCL.cpp's -I handling).
    """
    from ..parallel.spmat import SpParMat

    rows, cols, vals, labels = read_labeled_tuples(path)
    n = len(labels)
    if symmetrize:
        # Mirror off-diagonal edges, but DROP mirrored copies whose
        # coordinate already appears in the file (files often list both
        # directions; blindly mirroring would double those weights). Only
        # mirror-induced duplicates are dropped — genuine same-direction
        # multi-edges still reach ``dedup_sr`` untouched.
        orig_keys = np.unique(rows * np.int64(n) + cols)
        off = rows != cols
        mr, mc, mv = cols[off], rows[off], vals[off]
        fresh = ~np.isin(mr * np.int64(n) + mc, orig_keys)
        rows = np.concatenate([rows, mr[fresh]])
        cols = np.concatenate([cols, mc[fresh]])
        vals = np.concatenate([vals, mv[fresh]])
    A = SpParMat.from_global_coo(
        grid, rows, cols, vals.astype(dtype), n, n, dedup_sr=dedup_sr
    )
    return A, labels
