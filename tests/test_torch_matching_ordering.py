"""Parity of the port's bipartite matchings and orderings with
``combblas_tpu`` on the CPU, bit for bit (every value is an int32 or a
comparison of weights).

Matchings: ``_matching_round`` (greedy and Karp-Sipser, by column id and
by weight, from empty and from a partial state), ``maximal_matching`` in
every mode, ``_mcm_phase`` (one phase, then to the end),
``maximum_matching`` on the device and through the host oracle, and
``awpm``, on 1x1 and 2x2 grids (the augmenting phases need ``transpose``,
so a square grid), ``maximal_matching`` also on 2x4; the host validators.
The host oracle on 1x1 and minimum degree on 2x2 run under ``-m slow``
(one eager step a layer or a vertex in the reference).
Orderings: ``_rcm_sort`` on random keys with ties and unreachable slots,
``rcm_ordering`` with and without a root (the pseudo-peripheral probe) on
connected and disconnected graphs on 1x1, 2x2 and 2x4, and
``minimum_degree_ordering`` on 1x1 and 2x2.

Inputs come from fixed numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.models import matching as jm
from combblas_tpu.models import ordering as jo
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.parallel.spmat import SpParMat as JaxSpParMat
from combblas_tpu.parallel.vec import DistVec as JaxDistVec
from combblas_tpu_torch import DistVec, Grid, SpParMat
from combblas_tpu_torch.models import matching as tm
from combblas_tpu_torch.models import ordering as to

SQUARE = [(1, 1), (2, 2)]
ALL = [(1, 1), (2, 2), (2, 4)]


def ids(shapes):
    return [f"{a}x{b}" for a, b in shapes]


def same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def same_vec(got: DistVec, want):
    assert (got.length, got.align) == (want.length, want.align)
    same(got.blocks, want.blocks)


def both(shape, dense):
    dense = np.asarray(dense, np.float32)
    return (JaxSpParMat.from_dense(JaxGrid.make(*shape), dense),
            SpParMat.from_dense(Grid.make(*shape, device="cpu"), dense))


def bipartite(seed, nr=26, nc=21, density=0.14, weighted=False):
    """A random bipartite pattern; weighted: distinct weights in [0.1, 1.1)
    (no two equal), else ones."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nr, nc)) < density
    w = rng.permutation(nr * nc).reshape(nr, nc).astype(np.float32) / (nr * nc) + 0.1
    return np.where(mask, w if weighted else 1.0, 0.0).astype(np.float32)


def tied_weights(seed, n=18):
    """Weights from {1, 2, 3}: rows with equal maxima over several free
    columns, so the least column id must win (SELECT2ND_MIN)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 4, (n, n)) * (rng.random((n, n)) < 0.3)).astype(np.float32)


# --- matchings -------------------------------------------------------------------


@pytest.mark.parametrize("shape", ALL, ids=ids(ALL))
@pytest.mark.parametrize("heaviest", [False, True])
def test_matching_round_matches_reference(shape, heaviest):
    """One round from the empty matching and one from a partial state, both
    rules (Karp-Sipser degree-1 and greedy): mates and counts exact."""
    d = tied_weights(3) if heaviest else bipartite(1)
    JA, TA = both(shape, d)
    jaid, taid = jm._colid_matrix(JA), tm._colid_matrix(TA)
    same(taid.vals, jaid.vals)
    jw, tw = (JA, TA) if heaviest else (None, None)
    nr, nc = d.shape
    jr = JaxDistVec.full(JA.grid, nr, -1, jnp.int32, align="row").blocks
    jc = JaxDistVec.full(JA.grid, nc, -1, jnp.int32, align="col").blocks
    tr = DistVec.full(TA.grid, nr, -1, torch.int32, align="row").blocks
    tc = DistVec.full(TA.grid, nc, -1, torch.int32, align="col").blocks
    for deg1 in (True, False, True):
        jr, jc, jn = jm._matching_round(jaid, jw, jr, jc, jnp.bool_(deg1), heaviest=heaviest)
        tr, tc, tn = tm._matching_round(taid, tw, tr, tc, deg1, heaviest=heaviest)
        same(tr, jr)
        same(tc, jc)
        assert int(tn) == int(jn)


@pytest.mark.parametrize("shape", ALL, ids=ids(ALL))
@pytest.mark.parametrize("mode", ["greedy", "karp_sipser", "weighted", "weighted_ties"])
def test_maximal_matching_matches_reference(shape, mode):
    d = tied_weights(4) if mode == "weighted_ties" else bipartite(2, weighted=mode == "weighted")
    JA, TA = both(shape, d)
    kw = dict(karp_sipser=mode != "greedy", weighted=mode.startswith("weighted"))
    jr, jc = jm.maximal_matching(JA, **kw)
    tr, tc = tm.maximal_matching(TA, **kw)
    same_vec(tr, jr)
    same_vec(tc, jc)
    mr, mc = tr.to_global(), tc.to_global()
    assert tm.is_valid_matching(d, mr, mc) and tm.is_maximal(d, mr, mc)


@pytest.mark.parametrize("shape", SQUARE, ids=ids(SQUARE))
def test_mcm_phase_matches_reference(shape):
    """One augmenting phase from the greedy maximal matching, then phases
    until none augments: mates and counts exact at every phase."""
    d = bipartite(5, 30, 30, 0.09)
    JA, TA = both(shape, d)
    jr, jc = jm.maximal_matching(JA, karp_sipser=False)
    tr, tc = tm.maximal_matching(TA, karp_sipser=False)
    jat, tat = JA.transpose().apply(jm.ones_f32), TA.transpose().apply(tm.ones_f32)
    phases = 0
    while True:
        jr, jc, jn = jm._mcm_phase(jat, jr, jc)
        tr, tc, tn = tm._mcm_phase(tat, tr, tc)
        same_vec(tr, jr)
        same_vec(tc, jc)
        assert int(tn) == int(jn)
        phases += 1
        if int(jn) == 0:
            break
    assert phases >= 2  # the case augments at least once


@pytest.mark.parametrize("shape,device", [
    ((1, 1), True), ((2, 2), True), ((2, 2), False),
    # the reference's host oracle runs one eager SpMV a layer: 11 s more
    pytest.param((1, 1), False, marks=pytest.mark.slow),
], ids=["1x1-device", "2x2-device", "2x2-host", "1x1-host"])
def test_maximum_matching_matches_reference(shape, device):
    d = bipartite(6, 24, 20, 0.15)
    JA, TA = both(shape, d)
    jr, jc = jm.maximum_matching(JA, device=device)
    tr, tc = tm.maximum_matching(TA, device=device)
    same_vec(tr, jr)
    same_vec(tc, jc)
    mr, mc = tr.to_global(), tc.to_global()
    assert tm.is_valid_matching(d, mr, mc)
    if device:
        assert tm.maximum_matching_device.last_run["phases"] >= 1


@pytest.mark.parametrize("shape", SQUARE, ids=ids(SQUARE))
def test_awpm_matches_reference(shape):
    d = bipartite(7, 20, 20, 0.25, weighted=True)
    np.fill_diagonal(d, np.maximum(d.diagonal(), 0.05))  # a perfect matching exists
    JA, TA = both(shape, d)
    jr, jc = jm.awpm(JA)
    tr, tc = tm.awpm(TA)
    same_vec(tr, jr)
    same_vec(tc, jc)
    mr = tr.to_global()
    assert int((mr >= 0).sum()) == 20
    assert tm.matching_weight(d, mr) == jm.matching_weight(d, jr.to_global())


def test_host_validators_match_reference():
    d = bipartite(8, 8, 8, 0.4)
    rng = np.random.default_rng(8)
    for _ in range(20):
        mr = rng.integers(-1, 8, 8)
        mc = rng.integers(-1, 8, 8)
        for name in ("is_valid_matching", "is_maximal"):
            assert getattr(tm, name)(d, mr, mc) == getattr(jm, name)(d, mr, mc)
        assert tm.matching_weight(d, mr) == jm.matching_weight(d, mr)


# --- orderings -------------------------------------------------------------------


def graph(kind, n=40, seed=0):
    """Symmetric 0/1 patterns: a shuffled band, two components with
    isolated vertices, a shuffled path."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    if kind == "band":
        for i in range(n):
            for j in range(max(0, i - 3), min(n, i + 4)):
                if i != j and rng.random() < 0.7:
                    d[i, j] = d[j, i] = 1
    elif kind == "disconnected":
        h = n // 2 - 3
        for lo in (0, h):
            blk = (rng.random((h, h)) < 0.2).astype(np.float32)
            d[lo:lo + h, lo:lo + h] = np.maximum(blk, blk.T)
        np.fill_diagonal(d, 0)
    else:  # path
        for i in range(n - 1):
            d[i, i + 1] = d[i + 1, i] = 1
    sigma = rng.permutation(n)
    return d[np.ix_(sigma, sigma)]


def test_rcm_sort_matches_reference():
    """Random levels (with -1) and degrees full of ties, padding slots past
    the length: the permutations are equal."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        pa, L = (1, 2, 4)[seed % 3], int(rng.integers(3, 40))
        n = pa * L - int(rng.integers(0, L))
        lv = rng.integers(-1, 4, (pa, L)).astype(np.int32)
        dg = rng.integers(0, 3, (pa, L)).astype(np.int32)
        want = jo._rcm_sort(jnp.asarray(lv), jnp.asarray(dg), n)
        same(to._rcm_sort(torch.from_numpy(lv), torch.from_numpy(dg), n), want)


@pytest.mark.parametrize("shape", ALL, ids=ids(ALL))
@pytest.mark.parametrize("kind", ["band", "disconnected", "path"])
@pytest.mark.parametrize("root", [None, 0])
def test_rcm_ordering_matches_reference(shape, kind, root):
    d = graph(kind)
    JA, TA = both(shape, d)
    jp = jo.rcm_ordering(JA, root=root)
    tp = to.rcm_ordering(TA, root=root)
    same_vec(tp, jp)
    p = tp.to_global()
    np.testing.assert_array_equal(np.sort(p), np.arange(d.shape[0]))
    if root is None:
        assert to.pseudo_peripheral_vertex(TA) == jo.pseudo_peripheral_vertex(JA)
    assert to.bandwidth(d[np.ix_(p, p)]) == jo.bandwidth(d[np.ix_(p, p)])


@pytest.mark.parametrize("shape", [
    (1, 1),
    # one host step a vertex, each with a product in both packages: 10 s more
    pytest.param((2, 2), marks=pytest.mark.slow),
], ids=ids(SQUARE))
def test_minimum_degree_ordering_matches_reference(shape):
    d = graph("disconnected", n=20, seed=3)
    JA, TA = both(shape, d)
    jp = jo.minimum_degree_ordering(JA)
    tp = to.minimum_degree_ordering(TA)
    same_vec(tp, jp)
    np.testing.assert_array_equal(np.sort(tp.to_global()), np.arange(20))
    # a cut run stops early and appends the live vertices in id order
    same_vec(to.minimum_degree_ordering(TA, max_steps=5),
             jo.minimum_degree_ordering(JA, max_steps=5))
