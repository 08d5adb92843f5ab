"""Deterministic Graph500 v2.1 R-MAT generator (≈ RefGen21.h:88-323) —
counterpart of ``combblas_tpu/utils/refgen21.py``, a copy of its numpy
code (the port imports nothing of the JAX package).

Bit-identical reimplementation of the reference's ``packed=true`` generator
path (``include/CombBLAS/RefGen21.h`` wrapping the vendored graph500-1.2
generator): the L'Ecuyer 5-term multiple recursive generator (MRG) over
Z_{2^31-1} with leapfrog skip matrices, the 4-way Bernoulli square picker
(a=0.57, b=c=0.19 as integer fractions), clip-and-flip, and the two-round
multiplicative bit-reverse vertex scramble.

Everything is vectorized numpy over edges in exact uint64 integer
arithmetic — products of Z_{2^31-1} residues stay below 2^62, so plain
``uint64`` multiplication is exact; the 2^64 wraparound of the scramble's
multiplies is numpy's native uint64 behavior (matching C).

The skip table (A^(256^byte * k) for byte < 24, k < 256 — the reference's
generated ``mrg_transitions.c``) is recomputed here from the transition
algebra at first use and cached in-process; identical by construction
(verified by the golden-edge test against output of the reference
generator, tests/test_refgen21.py; the port's copy is held against the
same golden edges).

Edge semantics match ``RefGen21::make_graph`` (RefGen21.h:246-283): edge
``ei`` of ``M`` total is generated from state ``skip(seeded, 0, ei, 0)``,
so any sub-range [start, end) of the global stream can be produced on any
host/device independently — the same property the MPI code exploits, and
what makes multi-host generation embarrassingly parallel here.
"""

from __future__ import annotations

import numpy as np

_P = np.uint64(0x7FFFFFFF)  # 2^31 - 1
_X = np.uint64(107374182)
_Y = np.uint64(104480)
_A_NUM = 5700
_BC_NUM = 1900
_DENOM = 10000
_REJECT_LIMIT = np.uint64(0xFFFFFFFF % _DENOM)


def _mod(a):
    return a % _P


def _mod_mul(a, b):
    return (a * b) % _P  # operands < 2^31, product < 2^62: exact in uint64


def _mat_cache(m):
    """m: dict with s,t,u,v,w → adds a,b,c,d (the Toeplitz completion)."""
    m = dict(m)
    m["a"] = _mod(_X * m["s"] + m["t"])
    m["b"] = _mod(_X * m["a"] + m["u"])
    m["c"] = _mod(_X * m["b"] + m["v"])
    m["d"] = _mod(_X * m["c"] + m["w"])
    return m


def _mat_identity():
    z = np.uint64(0)
    return _mat_cache({"s": z, "t": z, "u": z, "v": z, "w": np.uint64(1)})


def _mat_A():
    z = np.uint64(0)
    return _mat_cache({"s": z, "t": z, "u": z, "v": np.uint64(1), "w": z})


def _mat_mul(m, n):
    """Transition-matrix product in the 5-parameter representation
    (splittable_mrg.c:85-100)."""
    y = _Y
    s = _mod(
        _mod_mul(m["s"], n["d"]) + _mod_mul(m["t"], n["c"])
        + _mod_mul(m["u"], n["b"]) + _mod_mul(m["v"], n["a"])
        + _mod_mul(m["w"], n["s"])
    )
    t = _mod(
        _mod_mul(_mod_mul(m["s"], n["s"]), y) + _mod_mul(m["t"], n["w"])
        + _mod_mul(m["u"], n["v"]) + _mod_mul(m["v"], n["u"])
        + _mod_mul(m["w"], n["t"])
    )
    u = _mod(
        _mod_mul(_mod(_mod_mul(m["s"], n["a"]) + _mod_mul(m["t"], n["s"])), y)
        + _mod_mul(m["u"], n["w"]) + _mod_mul(m["v"], n["v"])
        + _mod_mul(m["w"], n["u"])
    )
    v = _mod(
        _mod_mul(
            _mod(
                _mod_mul(m["s"], n["b"]) + _mod_mul(m["t"], n["a"])
                + _mod_mul(m["u"], n["s"])
            ),
            y,
        )
        + _mod_mul(m["v"], n["w"]) + _mod_mul(m["w"], n["v"])
    )
    w = _mod(
        _mod_mul(
            _mod(
                _mod_mul(m["s"], n["c"]) + _mod_mul(m["t"], n["b"])
                + _mod_mul(m["u"], n["a"]) + _mod_mul(m["v"], n["s"])
            ),
            y,
        )
        + _mod_mul(m["w"], n["w"])
    )
    return _mat_cache({"s": s, "t": t, "u": u, "v": v, "w": w})


_SKIP_TABLE = None  # [24, 256, 9] uint64, lazily built


def _mat_to_row(m):
    return [m[k] for k in ("s", "t", "u", "v", "w", "a", "b", "c", "d")]


def skip_table() -> np.ndarray:
    """A^(256^i * j) for i < 24, j < 256 — [24, 256, 9] uint64.

    Recomputes the reference's generated mrg_transitions.c table from the
    transition algebra (dump_mrg_powers, splittable_mrg.c:238-260):
    row i, col j is A^(256^i)^j, built by cumulative products.
    """
    global _SKIP_TABLE
    if _SKIP_TABLE is not None:
        return _SKIP_TABLE
    table = np.zeros((24, 256, 9), np.uint64)
    base = _mat_A()
    for i in range(24):
        cur = _mat_identity()
        table[i, 0] = _mat_to_row(cur)
        for j in range(1, 256):
            cur = _mat_mul(cur, base)
            table[i, j] = _mat_to_row(cur)
        # next byte level: base = base^256 = (cur = base^255) * base
        base = _mat_mul(cur, base)
    _SKIP_TABLE = table
    return table


def make_mrg_seed(userseed1: int, userseed2: int) -> np.ndarray:
    """utils.c:83-89 — spread two 64-bit seeds into five MRG residues."""
    u1, u2 = np.uint64(userseed1), np.uint64(userseed2)
    return np.array(
        [
            (u1 & np.uint64(0x3FFFFFFF)) + np.uint64(1),
            ((u1 >> np.uint64(30)) & np.uint64(0x3FFFFFFF)) + np.uint64(1),
            (u2 & np.uint64(0x3FFFFFFF)) + np.uint64(1),
            ((u2 >> np.uint64(30)) & np.uint64(0x3FFFFFFF)) + np.uint64(1),
            ((u2 >> np.uint64(60)) << np.uint64(4))
            + (u1 >> np.uint64(60)) + np.uint64(1),
        ],
        np.uint64,
    )


def _apply_transition(mat, z):
    """mrg_apply_transition (splittable_mrg.c:121-168), vectorized.

    mat: [..., 9] uint64 rows (s,t,u,v,w,a,b,c,d); z: [..., 5] states.
    """
    s, t, u, v, w, a, b, c, d = (mat[..., k] for k in range(9))
    z1, z2, z3, z4, z5 = (z[..., k] for k in range(5))
    y = _Y

    def mac(*pairs):
        acc = np.zeros_like(z1)
        for p, q in pairs:
            acc = _mod(acc + _mod_mul(p, q))
        return acc

    o1 = _mod(
        _mod_mul(d, z1)
        + _mod_mul(mac((s, z2), (a, z3), (b, z4), (c, z5)), y)
    )
    o2 = _mod(
        mac((c, z1), (w, z2)) + _mod_mul(mac((s, z3), (a, z4), (b, z5)), y)
    )
    o3 = _mod(
        mac((b, z1), (v, z2), (w, z3))
        + _mod_mul(mac((s, z4), (a, z5)), y)
    )
    o4 = _mod(
        mac((a, z1), (u, z2), (v, z3), (w, z4)) + _mod_mul(_mod_mul(s, z5), y)
    )
    o5 = mac((s, z1), (t, z2), (u, z3), (v, z4), (w, z5))
    return np.stack([o1, o2, o3, o4, o5], axis=-1)


def _skip(z, high: int, middle, low: int):
    """mrg_skip (splittable_mrg.c:190-206): advance by the 192-bit count
    high·2^128 + middle·2^64 + low. ``middle`` may be a vector (per-edge
    stream offsets); the per-byte matrices come from the skip table."""
    tab = skip_table()
    middle = np.asarray(middle, np.uint64)
    scalarish = middle.ndim == 0
    if scalarish:
        middle = middle[None]
        z = z[None]
    for byte_index in range(8):
        val = (np.uint64(low) >> np.uint64(8 * byte_index)) & np.uint64(0xFF)
        if val:
            z = _apply_transition(tab[byte_index, int(val)], z)
    for byte_index in range(8):
        vals = (middle >> np.uint64(8 * byte_index)) & np.uint64(0xFF)
        if np.any(vals):
            z = _apply_transition(tab[8 + byte_index][vals], z)
    for byte_index in range(8):
        val = (np.uint64(high) >> np.uint64(8 * byte_index)) & np.uint64(0xFF)
        if val:
            z = _apply_transition(tab[16 + byte_index, int(val)], z)
    return z[0] if scalarish else z


def _get_uint_orig(z):
    """mrg_orig_step + return z1 (vectorized, in place semantics)."""
    new_elt = _mod(_mod_mul(_X, z[..., 0]) + _mod_mul(_Y, z[..., 4]))
    z = np.concatenate([new_elt[..., None], z[..., :4]], axis=-1)
    return new_elt, z


def _bitreverse64(x):
    """RefGen21::bitreverse (RefGen21.h:135-180), 64-bit path."""
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    m = np.uint64(0x0000FFFF0000FFFF)
    x = ((x >> np.uint64(16)) & m) | ((x & m) << np.uint64(16))
    m = np.uint64(0x00FF00FF00FF00FF)
    x = ((x >> np.uint64(8)) & m) | ((x & m) << np.uint64(8))
    m = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x >> np.uint64(4)) & m) | ((x & m) << np.uint64(4))
    m = np.uint64(0x3333333333333333)
    x = ((x >> np.uint64(2)) & m) | ((x & m) << np.uint64(2))
    m = np.uint64(0x5555555555555555)
    x = ((x >> np.uint64(1)) & m) | ((x & m) << np.uint64(1))
    return x


def _scramble(v, lgN: int, val0, val1):
    """RefGen21::scramble (RefGen21.h:184-196)."""
    v = v.astype(np.uint64)
    with np.errstate(over="ignore"):
        v = v + (val0 + val1)
        v = v * (val0 | np.uint64(0x4519840211493211))
        v = _bitreverse64(v) >> np.uint64(64 - lgN)
        v = v * (val1 | np.uint64(0x3050852102C843A5))
        v = _bitreverse64(v) >> np.uint64(64 - lgN)
    return v.astype(np.int64)


def _bernoulli4(z):
    """generate_4way_bernoulli (RefGen21.h:103-131), vectorized with exact
    rejection semantics: redraw while raw < (2^32 - 1) % 10000 = 7295 —
    the reference's UINT32_C(0xFFFFFFFF) % INITIATOR_DENOMINATOR, NOT
    2^32 % 10000; changing this constant silently breaks bit fidelity."""
    val, z = _get_uint_orig(z)
    pending = val < _REJECT_LIMIT
    while np.any(pending):
        redraw, z2 = _get_uint_orig(z[pending])
        # only the pending lanes advance their state
        znew = z.copy()
        znew[pending] = z2
        z = znew
        vnew = val.copy()
        vnew[pending] = redraw
        val = vnew
        pending = val < _REJECT_LIMIT
    val = val % np.uint64(_DENOM)
    sq = np.full(val.shape, 3, np.int64)
    v = val.astype(np.int64)
    sq = np.where(v < _BC_NUM, 1, sq)
    v2 = v - _BC_NUM
    sq = np.where((v >= _BC_NUM) & (v2 < _BC_NUM), 2, sq)
    v3 = v2 - _BC_NUM
    sq = np.where((v2 >= _BC_NUM) & (v3 < _A_NUM), 0, sq)
    return sq, z


def generate_kronecker_range(
    seed5: np.ndarray, logN: int, start_edge: int, end_edge: int
) -> tuple[np.ndarray, np.ndarray]:
    """RefGen21::generate_kronecker_range (RefGen21.h:246-263):
    edges [start_edge, end_edge) of the global deterministic stream.
    Returns (src, dst) int64 arrays of length end_edge - start_edge.
    """
    nverts = np.int64(1) << np.int64(logN)
    state = seed5.astype(np.uint64)

    # MakeScrambleValues (RefGen21.h:228-241)
    zs = _skip(state.copy(), 50, 7, 0)
    v0a, zs = _get_uint_orig(zs)
    v0b, zs = _get_uint_orig(zs)
    v1a, zs = _get_uint_orig(zs)
    v1b, zs = _get_uint_orig(zs)
    with np.errstate(over="ignore"):
        val0 = v0a * np.uint64(0xFFFFFFFF) + v0b
        val1 = v1a * np.uint64(0xFFFFFFFF) + v1b

    ei = np.arange(start_edge, end_edge, dtype=np.uint64)
    E = len(ei)
    z = np.broadcast_to(state, (E, 5)).copy()
    z = _skip(z, 0, ei, 0)

    base_src = np.zeros(E, np.int64)
    base_tgt = np.zeros(E, np.int64)
    nv = np.int64(nverts)
    for _level in range(logN):
        sq, z = _bernoulli4(z)
        src_offset = sq // 2
        tgt_offset = sq % 2
        # clip-and-flip for undirected graphs (make_one_edge)
        flip = (base_src == base_tgt) & (src_offset > tgt_offset)
        src_offset, tgt_offset = (
            np.where(flip, tgt_offset, src_offset),
            np.where(flip, src_offset, tgt_offset),
        )
        nv = nv // 2
        base_src = base_src + nv * src_offset
        base_tgt = base_tgt + nv * tgt_offset

    return (
        _scramble(base_src, logN, val0, val1),
        _scramble(base_tgt, logN, val0, val1),
    )


def graph500_edges(
    scale: int,
    nedges: int | None = None,
    userseed: int = 0xDECAFBAD,
    edgefactor: int = 16,
    start_edge: int = 0,
    end_edge: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The DistEdgeList::GenGraph500Data packed path
    (``DistEdgeList.cpp:223-330`` via RefGen21::make_graph): deterministic
    edge list for a scale-``scale`` Kronecker graph.

    ``userseed`` defaults to the reference's fallback constant
    (``init_random``, RefGen21.h:305-316: 0xDECAFBAD when no SEED env);
    pass 0 for the reference's ``-DDETERMINISTIC`` builds
    (TopDownBFS.cpp:29). Any [start_edge, end_edge) sub-range of the
    stream can be generated independently (multi-host sharding).
    """
    if nedges is None:
        nedges = edgefactor << scale
    if end_edge is None:
        end_edge = nedges
    seed5 = make_mrg_seed(userseed, userseed)
    return generate_kronecker_range(seed5, scale, start_edge, end_edge)


# --- native (C++) path ------------------------------------------------------
#
# ``io/native/graphgen.cpp`` is this module's native twin (the same
# MRG/skip/scramble stream, threaded over edges), built by g++ at first use
# into build/combblas_tpu_torch/ (``_build.build_host``). Unlike the
# reference's, a failed build raises: there is no quiet numpy fallback.


def _load_native():
    """The built generator library (raises if it cannot be built)."""
    import ctypes

    from .._build import load_host

    lib = load_host("graphgen")
    lib.cbtpu_graph500_edges.restype = ctypes.c_int
    lib.cbtpu_graph500_edges.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    return lib


def graph500_edges_native(
    scale: int,
    nedges: int | None = None,
    userseed: int = 0xDECAFBAD,
    edgefactor: int = 16,
    start_edge: int = 0,
    end_edge: int | None = None,
    nthreads: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``graph500_edges`` through the native generator (bit-identical;
    threaded C++ over ``nthreads``, default min(cores, 16))."""
    import ctypes
    import os

    if nedges is None:
        nedges = edgefactor << scale
    if end_edge is None:
        end_edge = nedges
    lib = _load_native()
    m = end_edge - start_edge
    src = np.empty(m, np.int64)
    dst = np.empty(m, np.int64)
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, 16)
    rc = lib.cbtpu_graph500_edges(
        ctypes.c_uint64(userseed), scale, start_edge, end_edge,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nthreads,
    )
    if rc != 0:
        raise ValueError(f"native generator failed (rc={rc})")
    return src, dst
