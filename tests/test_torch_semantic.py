"""Parity of the port's ``semantic.py`` (``SemanticGraph``, its two filter
modes, ``filtered_bfs``, ``filtered_mis``, ``FILTERED_SELECT2ND_MAX``) with
``combblas_tpu/semantic.py`` on the CPU, on 1×1 and 2×2 grids: the filtered
matrices array by array (rows, cols, vals, nnz, capacity), the searches'
parents, levels and level counts bit for bit in both modes. ``filtered_mis``
draws its priorities from a ``torch.Generator`` where the reference takes a
key, so its set is checked for independence and maximality in the filtered
graph, and the rounds bit for bit through ``_mis_rounds`` fed the
reference's priorities.
"""

import jax
import numpy as np
import pytest
import torch

from combblas_tpu.models.bfs import validate_bfs_tree
from combblas_tpu.parallel.grid import Grid as JaxGrid
from combblas_tpu.semantic import SemanticGraph as JaxSemanticGraph
from combblas_tpu.semantic import filtered_bfs as jax_filtered_bfs
from combblas_tpu.semantic import filtered_mis as jax_filtered_mis
from combblas_tpu_torch import (
    FILTERED_SELECT2ND_MAX,
    SELECT2ND_MAX,
    Grid,
    SemanticGraph,
    bfs,
    filtered_bfs,
    filtered_mis,
)
from combblas_tpu_torch.models import mis as mis_mod


def twitterish_graph(seed, n, density=0.25):
    """Symmetric structure with per-edge (latest, followers) attributes,
    symmetric so that the filtered graph stays symmetric (the reference's
    test graph)."""
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density).astype(np.float32)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0)
    r, c = np.nonzero(d)
    latest = ((r * 131 + c * 17) % 100 + ((c * 131 + r * 17) % 100)).astype(np.float32)
    followers = ((r + c) % 7).astype(np.int32)
    return r, c, {"latest": latest, "followers": followers}


def keep_early(attrs):
    return attrs["latest"] < 100


def keep_many(attrs):
    return (attrs["followers"] >= 2) & (attrs["latest"] < 150)


def both(p, r, c, attrs, n):
    return (JaxSemanticGraph.from_edges(JaxGrid.make(p, p), r, c, attrs, n, n),
            SemanticGraph.from_edges(Grid.make(p, p, device="cpu"), r, c, attrs, n, n))


def assert_same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def assert_same_mat(got, want):
    assert (got.nrows, got.ncols, got.capacity) == (want.nrows, want.ncols, want.capacity)
    for f in ("rows", "cols", "vals", "nnz"):
        assert_same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("p", [1, 2])
def test_materialize_and_mask_match_reference(p):
    """Both filter modes array by array; the attributes upload slot-aligned
    with the structure."""
    r, c, attrs = twitterish_graph(0, 16)
    jg, tg = both(p, r, c, attrs, 16)
    assert_same_mat(tg.structure, jg.structure)
    for k in attrs:
        assert_same(tg.attrs[k], jg.attrs[k])
    for pred in (keep_early, keep_many):
        assert_same_mat(tg.materialize(pred), jg.materialize(pred))
        assert_same_mat(tg.mask(pred), jg.mask(pred))
    keep = attrs["latest"] < 100
    expect = np.zeros((16, 16), np.float32)
    expect[r[keep], c[keep]] = 1.0
    np.testing.assert_array_equal(tg.materialize(keep_early).to_dense(), expect)
    np.testing.assert_array_equal(tg.mask(keep_early).to_dense(), expect)


@pytest.mark.parametrize("p", [1, 2])
def test_filtered_bfs_matches_reference_in_both_modes(p):
    """Parents, levels and level counts bit for bit in both modes, which
    agree with each other and give valid trees of the filtered graph."""
    r, c, attrs = twitterish_graph(1, 20)
    jg, tg = both(p, r, c, attrs, 20)
    filt = tg.materialize(keep_early).to_dense()
    for materialize in (True, False):
        for source in (0, 7):
            tp, tl, tn = filtered_bfs(tg, keep_early, source, materialize=materialize)
            jp, jl, jn = jax_filtered_bfs(jg, keep_early, source, materialize=materialize)
            assert_same(tp.blocks, jp.blocks)
            assert_same(tl.blocks, jl.blocks)
            assert tn == int(jn)
            assert not validate_bfs_tree(filt, source, tp.to_global(), tl.to_global())
    l1 = filtered_bfs(tg, keep_early, 0, materialize=True)[1].to_global()
    l2 = filtered_bfs(tg, keep_early, 0, materialize=False)[1].to_global()
    np.testing.assert_array_equal(l1, l2)


def test_filter_changes_the_search():
    """A tighter filter reaches a different level set than the whole
    graph, as in the reference."""
    r, c, attrs = twitterish_graph(2, 20, density=0.4)
    jg, tg = both(2, r, c, attrs, 20)
    _, l_all, _ = bfs(tg.structure, 0)
    _, l_f, _ = filtered_bfs(tg, lambda a: a["latest"] < 40, 0)
    _, jl_f, _ = jax_filtered_bfs(jg, lambda a: a["latest"] < 40, 0)
    assert not np.array_equal(l_all.to_global(), l_f.to_global())
    assert_same(l_f.blocks, jl_f.blocks)


def test_filtered_semiring_masks_per_dtype():
    """An edge of value 0 sends the additive identity of x's dtype."""
    a = torch.tensor([1.0, 0.0, 2.0])
    for x, zero in ((torch.tensor([3, 4, 5], dtype=torch.int32), -1),
                    (torch.tensor([3.0, 4.0, 5.0]), -np.inf)):
        y = FILTERED_SELECT2ND_MAX.mul(a, x)
        assert y.dtype == x.dtype and y[1].item() == zero and y[2].item() == x[2].item()
    assert FILTERED_SELECT2ND_MAX.zero(torch.int32) == SELECT2ND_MAX.zero(torch.int32)


@pytest.mark.parametrize("p", [1, 2])
def test_filtered_mis_is_independent_and_maximal(p):
    """``filtered_mis`` on the filtered graph: independent and maximal
    there; the rounds bit for bit with the reference's set through
    ``_mis_rounds`` fed the reference's priorities."""
    r, c, attrs = twitterish_graph(3, 16, density=0.3)
    jg, tg = both(p, r, c, attrs, 16)
    filt = tg.materialize(keep_early).to_dense() != 0
    status, rounds = filtered_mis(tg, keep_early, torch.Generator().manual_seed(0))
    s = status.to_global() == 1
    assert not filt[np.ix_(s, s)].any()
    assert ((filt[:, s].any(1)) | s).all()
    assert rounds >= 1
    # the reference's set from the reference's priorities
    key = jax.random.key(0)
    jstatus, jrounds = jax_filtered_mis(jg, keep_early, key)
    L = -(-16 // p)
    prio = np.asarray(jax.random.permutation(key, p * L)).reshape(p, L)
    tstatus, trounds = mis_mod._mis_rounds(tg.materialize(keep_early),
                                           torch.from_numpy(prio.astype(np.int32)))
    assert_same(tstatus.blocks, jstatus.blocks)
    assert trounds == int(jrounds)
