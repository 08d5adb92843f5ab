"""Parity of the port's single-root Graph500 search (``bfs_single``,
``parse_tier_spec``, ``single_traversed_edges``) with ``combblas_tpu`` on
the CPU. Parents, levels and counts are integers: every comparison is
exact.

Each distinct tier tuple of the reference compiles its own program (about
ten seconds here), so tier-1 runs three of them, once per module: 1×1
always-dense, 1×1 mixed ladder, 2×2 mixed ladder. The other regimes (pure
top-down, pure bottom-up, ``DEFAULT_SEQ_TIERS``, forced dense, 2×4 grids,
a directed graph) are held against ``oracle_search`` below, a numpy
re-statement of the reference's rules (step selection, walks cut to the
class's ladder rung, max-id parents); under ``-m slow`` against the
reference as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.models import bfs as jax_bfs
from combblas_tpu.parallel import ellmat as jax_ellmat
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import (
    BFS_CLASS_LADDER,
    DEFAULT_SEQ_TIERS,
    PLUS_TIMES,
    DistVec,
    EllParMat,
    Grid,
    bfs_single,
    build_csc_companion,
    build_csr_companion,
    ones_i32,
    parse_tier_spec,
    rmat_symmetric_coo_host,
    single_traversed_edges,
)

N = 256
BIG = (N,) * 6
TIERS = {
    "dense": (),
    "forced-dense": (("td", (1, 0, 0, 0, 0, 0)),),
    "td": (("td", BIG),),
    "bu": (("bu", BIG),),
    # on this graph's roots: td0 first, td2 or dense at the peak, bu1 after
    # it (class 0 holds the 56 isolated vertices, never discovered)
    "mixed": (("td", (4, 2, 1, 0, 0, 0)), ("bu", (120, 8, 2, 0, 0, 0)),
              ("td", (40, 20, 4, 0, 0, 0))),
    "default": parse_tier_spec(DEFAULT_SEQ_TIERS),
}


def symmetric_graph():
    r, c = rmat_symmetric_coo_host(31, 8, 6)
    key = np.unique(r * N + c)
    return key // N, key % N


def directed_graph():
    """Random directed edges plus four broadcasters: out-degree about 40,
    in-degree at most 2. With the fallback ``coldeg`` (the row degree,
    which counts in-edges) a broadcaster is in class 0, so a top-down walk
    covers only 8 of its out-edges."""
    rng = np.random.default_rng(5)
    d = rng.random((N, N)) < 0.02
    np.fill_diagonal(d, False)
    hubs = np.array([3, 77, 140, 201])
    d[:, hubs] |= rng.random((N, 4)) < 0.16  # column = source of the edge
    d[hubs] &= rng.random((4, N)) < 0.005
    np.fill_diagonal(d, False)
    r, c = np.nonzero(d)
    return r.astype(np.int64), c.astype(np.int64)


def roots_of(r, k=3):
    deg = np.bincount(r, minlength=N)
    return [int(s) for s in np.flatnonzero(deg > 0)[[0, 7, 40][:k]]]


def structures(shape, r, c, device="cpu"):
    grid = Grid.make(*shape, device=device)
    E = EllParMat.from_host_coo(grid, r, c, np.ones(len(r), np.float32), N, N)
    return E, build_csc_companion(grid, r, c, N, N), build_csr_companion(grid, r, c, N, N)


def oracle_search(r, c, shape, source, tiers, rowdeg, coldeg, max_iters=None):
    """The reference's single-root search restated in numpy: per level the
    step its rule picks, then the dense sweep, or the walk of every active
    column's CSC range (td) / undiscovered row's CSR range (bu) in each
    tile, cut to ``BFS_CLASS_LADDER[class]`` entries. Returns parents,
    levels, the level count, the steps and the readbacks the port's host
    loop makes."""
    pr, pc = shape
    lr, lc = -(-N // pr), -(-N // pc)
    order = np.lexsort((r, c))  # by column, rows ascending: the CSC order
    col_rows, row_cols = {}, {}
    for rr, cc in zip(r[order], c[order]):
        col_rows.setdefault((rr // lr, cc), []).append(rr)
    for rr, cc in zip(r, c):  # r, c sorted by (row, col): the CSR order
        row_cols.setdefault((cc // lc, rr), []).append(cc)
    ladder = np.asarray(BFS_CLASS_LADDER)
    nc = len(ladder)
    ccls = np.searchsorted(ladder, coldeg)  # how many rungs lie below the degree
    rcls = np.searchsorted(ladder, rowdeg)
    parents = np.full(N, -1)
    levels = np.full(N, -1)
    parents[source], levels[source] = source, 0
    frontier = np.zeros(N, bool)
    frontier[source] = True
    steps, readbacks, level, found = [], 0, 0, True
    iters = max_iters if max_iters is not None else N
    while level < iters:
        undisc = parents < 0
        if tiers or level:
            readbacks += 1
            if not found:
                break
        step = "dense"
        for t, (kind, budgets) in enumerate(tiers):
            cls = ccls[frontier] if kind == "td" else rcls[undisc]
            cnt = np.bincount(cls, minlength=nc + 1)
            if cnt[nc] == 0 and all(cnt[k] <= budgets[k] for k in range(nc)):
                step = f"{kind}{t}"
                break
        cand = np.full(N, -1)
        if step == "dense":
            hit = frontier[c] & undisc[r]
            np.maximum.at(cand, r[hit], c[hit])
        elif step.startswith("td"):
            for v in np.flatnonzero(frontier):
                for i in range(pr):
                    for u in col_rows.get((i, v), [])[:ladder[ccls[v]]]:
                        cand[u] = max(cand[u], v)
        else:
            for u in np.flatnonzero(undisc):
                for j in range(pc):
                    for v in row_cols.get((j, u), [])[:ladder[rcls[u]]]:
                        if frontier[v]:
                            cand[u] = max(cand[u], v)
        new = (cand >= 0) & undisc
        parents[new] = cand[new]
        level += 1
        levels[new] = level
        frontier, found = new, bool(new.any())
        steps.append(step)
    return parents, levels, level, steps, readbacks


def max_id_bfs(r, c, source):
    """Plain BFS, parent = the max-id in-neighbour one level up."""
    levels = np.full(N, -1)
    levels[source] = 0
    frontier, depth = np.array([source]), 0
    while len(frontier):
        depth += 1
        hit = np.isin(c, frontier) & (levels[r] < 0)
        frontier = np.unique(r[hit])
        levels[frontier] = depth
    up = (levels[r] > 0) & (levels[c] == levels[r] - 1)
    parents = np.full(N, -1)
    np.maximum.at(parents, r[up], c[up])
    parents[source] = source
    return parents, levels


def check_against_oracle(shape, r, c, tiers, roots, rowdeg=None, coldeg=None, **kw):
    E, csc, csr = structures(shape, r, c)
    deg = np.bincount(r, minlength=N)
    for s in roots:
        p, lv, it = bfs_single(E, s, csc, csr=csr, tiers=tiers, rowdeg=rowdeg, coldeg=coldeg,
                               **kw)
        want = oracle_search(r, c, shape, s, tiers, deg if rowdeg is None else rowdeg_of(rowdeg),
                             deg if coldeg is None else rowdeg_of(coldeg), **kw)
        assert p.blocks.dtype == lv.blocks.dtype == torch.int32
        np.testing.assert_array_equal(p.to_global(), want[0], err_msg=f"parents, root {s}")
        np.testing.assert_array_equal(lv.to_global(), want[1], err_msg=f"levels, root {s}")
        assert it == want[2]
        assert bfs_single.last_run == {"readbacks": want[4], "steps": want[3]}
    return want


def rowdeg_of(blocks):
    return blocks.reshape(-1)[:N].numpy()


# --- the reference's programs, three per module ------------------------------

REF_CONFIGS = {"1x1-dense": ((1, 1), "dense"), "1x1-mixed": ((1, 1), "mixed"),
               "2x2-mixed": ((2, 2), "mixed")}


@pytest.fixture(scope="module")
def reference_runs():
    """Per config and root: the reference's (parents, levels, niter) with
    its fallbacks (rowdeg from ``E.reduce``, coldeg realigned), and its
    EllParMat."""
    r, c = symmetric_graph()
    out = {}
    for name, (shape, tiers) in REF_CONFIGS.items():
        grid = JaxGrid.make(*shape)
        E = jax_ellmat.EllParMat.from_host_coo(grid, r, c, np.ones(len(r), np.float32), N, N)
        csc = jax_ellmat.build_csc_companion(grid, r, c, N, N)
        csr = jax_ellmat.build_csr_companion(grid, r, c, N, N)
        for s in roots_of(r):
            p, lv, it = jax_bfs.bfs_single(E, s, csc, csr=csr, tiers=TIERS[tiers])
            out[name, s] = (np.asarray(p.blocks), np.asarray(lv.blocks), int(it), p, E)
    return out


@pytest.mark.parametrize("name", list(REF_CONFIGS))
def test_bfs_single_matches_reference(reference_runs, name):
    shape, tiers = REF_CONFIGS[name]
    r, c = symmetric_graph()
    E, csc, csr = structures(shape, r, c)
    deg = np.bincount(r, minlength=N)
    kinds = set()
    for s in roots_of(r):
        p, lv, it = bfs_single(E, s, csc, csr=csr, tiers=TIERS[tiers])
        wp, wl, wit = reference_runs[name, s][:3]
        np.testing.assert_array_equal(p.blocks.numpy(), wp, err_msg=f"parents, root {s}")
        np.testing.assert_array_equal(lv.blocks.numpy(), wl, err_msg=f"levels, root {s}")
        assert it == wit and isinstance(it, int)
        # the selection rule and readbacks, recomputed in numpy
        want = oracle_search(r, c, shape, s, TIERS[tiers], deg, deg)
        assert bfs_single.last_run == {"readbacks": want[4], "steps": want[3]}
        np.testing.assert_array_equal(p.to_global(), max_id_bfs(r, c, s)[0])
        kinds |= {step[:2] for step in bfs_single.last_run["steps"]}
    # the mixed ladder ran every kind of step
    assert kinds == ({"td", "bu", "de"} if tiers == "mixed" else {"de"}), kinds


def test_single_traversed_edges_matches_reference(reference_runs):
    """On 2×2 with the row degrees of the fallback (``E.reduce``)."""
    r, c = symmetric_graph()
    E, csc, csr = structures((2, 2), r, c)
    degb = E.reduce(PLUS_TIMES, "cols", map_fn=ones_i32).blocks
    deg = np.bincount(r, minlength=N)
    for s in roots_of(r):
        wp, _, _, jp, jE = reference_runs["2x2-mixed", s]
        from combblas_tpu.parallel.spmat import ones_i32 as jax_ones_i32
        from combblas_tpu.semiring import PLUS_TIMES as JAX_PLUS_TIMES

        jdeg = jE.reduce(JAX_PLUS_TIMES, "cols", map_fn=jax_ones_i32).blocks
        np.testing.assert_array_equal(degb.numpy(), np.asarray(jdeg))
        want = int(np.asarray(jax_bfs.single_traversed_edges(jdeg, jp)))
        p, _, _ = bfs_single(E, s, csc, csr=csr, tiers=TIERS["mixed"])
        got = single_traversed_edges(degb, p)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == want == int(deg[p.to_global() >= 0].sum()) // 2


def test_single_traversed_edges_sums_past_int32():
    """Degree sums between 2**31 and 2**32 are right (the reference sums in
    uint32, the port in int64)."""
    grid = Grid.make(1, 1, device="cpu")
    deg = torch.full((1, 4), 2**30 - 1, dtype=torch.int32)
    p = DistVec(blocks=torch.tensor([[0, 0, 0, -1]], dtype=torch.int32), length=4, align="row",
                grid=grid)
    want = jax_bfs.single_traversed_edges(
        jnp.asarray(deg.numpy()),
        JaxDistVec(blocks=jnp.asarray(p.blocks.numpy()), length=4, align="row",
                   grid=JaxGrid.make(1, 1)))
    assert int(single_traversed_edges(deg, p)) == 3 * (2**30 - 1) // 2 == int(np.asarray(want))


# --- the other regimes, against the numpy oracle ------------------------------

GRIDS = [(1, 1), (2, 2), (2, 4)]


@pytest.mark.parametrize("tiers", ["forced-dense", "td", "bu", "default", "mixed"])
@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_bfs_single_matches_oracle(shape, tiers):
    r, c = symmetric_graph()
    want = check_against_oracle(shape, r, c, TIERS[tiers], roots_of(r))
    np.testing.assert_array_equal(want[0], max_id_bfs(r, c, roots_of(r)[-1])[0])
    if tiers in ("td", "bu"):
        assert set(want[3]) == {tiers + "0"}


def test_bfs_single_with_degrees_passed_and_max_iters():
    """Degrees passed as blocks (the true column degrees), and a search cut
    after two levels."""
    r, c = symmetric_graph()
    E, _, _ = structures((2, 4), r, c)
    deg = np.bincount(r, minlength=N).astype(np.int32)
    rowdeg = DistVec.from_global(E.grid, deg, align="row").blocks
    coldeg = DistVec.from_global(E.grid, np.bincount(c, minlength=N).astype(np.int32),
                                 align="col").blocks
    check_against_oracle((2, 4), r, c, TIERS["mixed"], roots_of(r), rowdeg=rowdeg,
                         coldeg=coldeg)
    want = check_against_oracle((2, 4), r, c, TIERS["mixed"], roots_of(r)[:1], max_iters=2)
    assert want[2] == 2 and want[1].max() == 2
    check_against_oracle((1, 1), r, c, (), roots_of(r)[:1], max_iters=2)


def test_isolated_root():
    """A root without edges: one level that finds nothing."""
    r, c = symmetric_graph()
    lone = int(np.flatnonzero(np.bincount(r, minlength=N) == 0)[0])
    want = check_against_oracle((2, 2), r, c, TIERS["mixed"], [lone])
    assert want[2] == 1 and (want[0] >= 0).sum() == 1
    check_against_oracle((1, 1), r, c, (), [lone])


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_directed_graph_cuts_walks_by_the_fallback_degree(shape):
    """No ``coldeg``: the fallback takes the row degrees, which undercount a
    broadcaster's out-edges, and a top-down walk stops at the class's rung
    (8 entries for class 0), as the reference's does. The search then
    differs from a plain BFS; the oracle, which cuts the same way, agrees
    with the port."""
    r, c = directed_graph()
    tiers = TIERS["td"]
    roots = [3, 77]
    want = check_against_oracle(shape, r, c, tiers, roots)
    assert not np.array_equal(want[1], max_id_bfs(r, c, roots[-1])[1])
    # with the true column degrees nothing is cut
    E, _, _ = structures(shape, r, c)
    coldeg = DistVec.from_global(E.grid, np.bincount(c, minlength=N).astype(np.int32),
                                 align="col").blocks
    E, csc, csr = structures(shape, r, c)
    p, lv, _ = bfs_single(E, roots[-1], csc, tiers=tiers, coldeg=coldeg)
    np.testing.assert_array_equal(lv.to_global(), max_id_bfs(r, c, roots[-1])[1])
    np.testing.assert_array_equal(p.to_global(), max_id_bfs(r, c, roots[-1])[0])


def test_parse_tier_spec_matches_reference():
    assert BFS_CLASS_LADDER == jax_bfs.BFS_CLASS_LADDER
    assert DEFAULT_SEQ_TIERS == jax_bfs.DEFAULT_SEQ_TIERS
    for spec in (DEFAULT_SEQ_TIERS, "", "td:1,2,3,4,5,6", "|bu:0,0,0,0,0,9|"):
        assert parse_tier_spec(spec) == jax_bfs.parse_tier_spec(spec)
    assert parse_tier_spec("") == ()
    for bad in ("xx:1,2,3,4,5,6", "td:1,2,3", "bu:"):
        with pytest.raises(ValueError) as want:
            jax_bfs.parse_tier_spec(bad)
        with pytest.raises(ValueError) as got:
            parse_tier_spec(bad)
        assert str(got.value) == str(want.value)


def test_bottom_up_tiers_need_csr():
    r, c = symmetric_graph()
    E, csc, _ = structures((1, 1), r, c)
    with pytest.raises(ValueError) as got:
        bfs_single(E, 0, csc, tiers=TIERS["mixed"])
    jE = jax_ellmat.EllParMat.from_host_coo(JaxGrid.make(1, 1), r, c,
                                            np.ones(len(r), np.float32), N, N)
    with pytest.raises(ValueError) as want:
        jax_bfs.bfs_single(jE, 0, jax_ellmat.build_csc_companion(jE.grid, r, c, N, N),
                           tiers=TIERS["mixed"])
    assert str(got.value) == str(want.value)
    bfs_single(E, roots_of(r)[0], csc, tiers=TIERS["td"])  # td tiers alone need no csr


# --- the full sweep against the reference -----------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("graph", ["symmetric", "directed"])
@pytest.mark.parametrize("tiers", ["forced-dense", "td", "bu", "default", "mixed"])
@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_bfs_single_full_sweep_against_reference(shape, tiers, graph):
    r, c = symmetric_graph() if graph == "symmetric" else directed_graph()
    grid = JaxGrid.make(*shape)
    jE = jax_ellmat.EllParMat.from_host_coo(grid, r, c, np.ones(len(r), np.float32), N, N)
    jcsc = jax_ellmat.build_csc_companion(grid, r, c, N, N)
    jcsr = jax_ellmat.build_csr_companion(grid, r, c, N, N)
    E, csc, csr = structures(shape, r, c)
    for s in (roots_of(r) if graph == "symmetric" else [3, 77]):
        wp, wl, wit = jax_bfs.bfs_single(jE, s, jcsc, csr=jcsr, tiers=TIERS[tiers])
        p, lv, it = bfs_single(E, s, csc, csr=csr, tiers=TIERS[tiers])
        np.testing.assert_array_equal(p.blocks.numpy(), np.asarray(wp.blocks))
        np.testing.assert_array_equal(lv.blocks.numpy(), np.asarray(wl.blocks))
        assert it == int(wit)
