"""Parity of the port's dense -> sparse extraction (``combblas_tpu_torch``)
with the JAX package (``combblas_tpu``): ``dense_to_tuples_arrays`` /
``dense_to_sptuples`` (the compaction kernel K2), ``expand_ranges``,
``sparsify`` and ``dense_support_nnz``.

The inputs are every case of ``tests/test_pallas_sparsify.py``, built from
the same seeds, plus a four-panel case that shows the greedy panel
placement, a case with -0.0 and NaN cells, panels whose counts sit on the
``rows_used8`` steps (1024 and 1025 nonzeros), a first panel that
overflows while later ones are written, an input that is zero but for its
last cell, and 8-row panels alternately empty and full. The JAX package runs its
Pallas kernel in interpret mode, as its own tests do, once per case;
the port runs on the CPU, where the kernel's plain PyTorch version runs.
Every comparison is exact (tolerance 0).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.ops import pallas_sparsify
from combblas_tpu.ops.pallas_sparsify import dense_to_sptuples as jax_dense_to_sptuples
from combblas_tpu.ops.pallas_sparsify import dense_to_tuples_arrays as jax_dense_to_arrays
from combblas_tpu.ops.segment import expand_ranges as jax_expand_ranges
from combblas_tpu.ops.spgemm import dense_support_nnz as jax_dense_support_nnz
from combblas_tpu.ops.spgemm import sparsify as jax_sparsify
from combblas_tpu_torch import (
    dense_support_nnz,
    dense_to_sptuples,
    dense_to_tuples_arrays,
    expand_ranges,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
    sparsify,
)
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS, chunk_rows, kernel_variant

INF = float(np.inf)


def _pack_matches_nonzero(density, pr):
    rng = np.random.default_rng(int(density * 10) + pr)
    M, N = 32, 256
    x = np.where(
        rng.random((M, N)) < density, rng.integers(1, 100, (M, N)).astype(np.float32), 0.0
    ).astype(np.float32)
    return x, M, N, 0.0, int((x != 0).sum()) + 256, pr


def _rowmajor():
    rng = np.random.default_rng(3)
    x = np.where(rng.random((64, 512)) < 0.2, 1.0, 0.0).astype(np.float32)
    return x, 64, 512, 0.0, 1 << 15, 32


def _zero_inf():
    rng = np.random.default_rng(4)
    M, N = 16, 128
    x = np.full((M, N), np.inf, np.float32)
    mask = rng.random((M, N)) < 0.3
    x[mask] = rng.integers(0, 5, (M, N)).astype(np.float32)[mask]
    return x, M, N, INF, 4096, 8


def _truncation():
    rng = np.random.default_rng(5)
    x = (rng.random((64, 256)) < 0.5).astype(np.float32)
    return x, 64, 256, 0.0, 64, 8


def _padded_dims():
    x = np.zeros((32, 256), np.float32)
    x[:20, :200] = 1.0
    return x, 20, 200, 0.0, 8192, 8


def _gcd_panels():
    return np.eye(24, 128, dtype=np.float32), 24, 128, 0.0, 256, 16


def _bucket_roundup(total_nnz, pr):
    rng = np.random.default_rng(total_nnz + pr)
    x = np.zeros((pr, 128), np.float32)
    x.reshape(-1)[rng.choice(pr * 128, size=total_nnz, replace=False)] = 1.0
    return x, pr, 128, 0.0, total_nnz, pr


def _multi_panel():
    rng = np.random.default_rng(9)
    x = np.where(rng.random((32, 256)) < 0.35, 1.0, 0.0).astype(np.float32)
    return x, 32, 256, 0.0, int((x != 0).sum()), 32


#: Four panels of 32 flat rows (4096 cells) holding 3000 / 100 / 3000 / 100
#: nonzeros.
GREEDY_COUNTS = (3000, 100, 3000, 100)


def _greedy(capacity):
    rng = np.random.default_rng(11)
    flat = np.zeros(4 * 4096, np.float32)
    for p, k in enumerate(GREEDY_COUNTS):
        cells = p * 4096 + rng.choice(4096, size=k, replace=False)
        flat[cells] = rng.integers(1, 100, k).astype(np.float32)
    return flat.reshape(64, 256), 64, 256, 0.0, capacity, 32


def _signed_zero_nan():
    """-0.0 is the zero (the float compare), NaN is a nonzero."""
    rng = np.random.default_rng(12)
    x = np.where(rng.random((16, 128)) < 0.3, 2.0, 0.0).astype(np.float32)
    x[rng.random((16, 128)) < 0.2] = -0.0
    x[rng.random((16, 128)) < 0.05] = np.nan
    return x, 16, 128, 0.0, 1024, 8


def _panels_with_counts(counts, pr, seed):
    """Consecutive panels of ``pr`` flat rows holding ``counts[p]``
    nonzeros each (values 1..99 at random cells), as a ``[R/2, 256]``
    matrix."""
    rng = np.random.default_rng(seed)
    cells = pr * 128
    flat = np.zeros(len(counts) * cells, np.float32)
    for p, k in enumerate(counts):
        flat[p * cells + rng.choice(cells, size=k, replace=False)] = rng.integers(1, 100, k)
    return flat.reshape(-1, 256)


#: Panel counts on either side of the rows_used8 steps (8 rows per 1024).
USED8_COUNTS = (1024, 1025, 1023, 2048)


def _used8_steps(capacity):
    """Four panels of 16 rows with 1024 / 1025 / 1023 / 2048 nonzeros (8,
    16, 8 and 16 rows used). At the exact count all are written; at 1024
    (40 output rows) the first three fill 32 rows and the last is dropped."""
    x = _panels_with_counts(USED8_COUNTS, 16, 21)
    return x, x.shape[0], x.shape[1], 0.0, capacity, 16


def _first_overflows():
    """Panels of 64 rows with 7000 / 100 / 1500 / 50 nonzeros at capacity
    64 (40 output rows): the first (56 rows) is dropped, the rest written."""
    x = _panels_with_counts((7000, 100, 1500, 50), 64, 22)
    return x, x.shape[0], x.shape[1], 0.0, 64, 64


def _last_cell_only():
    """All zero but the last cell, panels of 8 rows (16 panels)."""
    x = np.zeros((64, 256), np.float32)
    x[-1, -1] = 7.0
    return x, 64, 256, 0.0, 1, 8


def _pr8_alternating():
    """pr = 8 with 16 panels, alternately empty and full."""
    x = _panels_with_counts((0, 1024) * 8, 8, 23)
    return x, x.shape[0], x.shape[1], 0.0, int((x != 0).sum()), 8


CASES = {
    **{
        f"nonzero-d{d}-pr{pr}": functools.partial(_pack_matches_nonzero, d, pr)
        for d in (0.0, 0.05, 0.5, 1.0)
        for pr in (8, 16)
    },
    "rowmajor": _rowmajor,
    "zero-inf": _zero_inf,
    "truncation": _truncation,
    "padded-dims": _padded_dims,
    "gcd-panels": _gcd_panels,
    **{
        f"bucket-{t}-pr{pr}": functools.partial(_bucket_roundup, t, pr)
        for t, pr in ((5120, 64), (1152, 32), (4224, 64))
    },
    "multi-panel": _multi_panel,
    "greedy-cap64": functools.partial(_greedy, 64),
    "greedy-cap3100": functools.partial(_greedy, 3100),
    "signed-zero-nan": _signed_zero_nan,
    "used8-steps-exact": functools.partial(_used8_steps, sum(USED8_COUNTS)),
    "used8-steps-cap1024": functools.partial(_used8_steps, 1024),
    "first-overflows": _first_overflows,
    "last-cell-only": _last_cell_only,
    "pr8-alternating": _pr8_alternating,
}


@functools.cache
def _jax_results(name):
    """Both JAX entry points on one case. The Pallas kernel runs once, in
    interpret mode; ``dense_to_sptuples`` then post-processes that run's
    arrays (its call to ``dense_to_tuples_arrays`` is handed them), since
    each interpret-mode run costs about a second."""
    x, nrows, ncols, zero, cap, pr = CASES[name]()
    kw = dict(zero=zero, capacity=cap, panel_rows=pr, interpret=True)
    arrays = jax_dense_to_arrays(jnp.asarray(x), **kw)  # one compile per op: eager
    with mock.patch.object(pallas_sparsify, "dense_to_tuples_arrays", return_value=arrays):
        t, total = jax.jit(lambda x: jax_dense_to_sptuples(x, nrows, ncols, **kw))(x)
    sp = tuple(np.asarray(a) for a in (t.rows, t.cols, t.vals, t.nnz, total))
    return tuple(np.asarray(a) for a in arrays), sp


def _port_args(name):
    x, nrows, ncols, zero, cap, pr = CASES[name]()
    return torch.from_numpy(x), nrows, ncols, dict(zero=zero, capacity=cap, panel_rows=pr)


@pytest.mark.parametrize("name", CASES)
def test_flat_arrays_match_reference(name):
    """idx and vals below ``end_row * 128``, ``total`` and ``end_row`` are
    equal; the port's slots past ``end_row * 128`` hold -1 and ``zero``."""
    (fi, fv, total, end_row), _ = _jax_results(name)
    x, _, _, kw = _port_args(name)
    launches = flat_to_tuples_arrays.launches
    got = dense_to_tuples_arrays(x, **kw)
    assert flat_to_tuples_arrays.launches == launches  # CPU tensors: plain version
    gi, gv, gtotal, gend = (a.numpy() for a in got)
    assert gi.shape == fi.shape and gi.dtype == fi.dtype and gv.dtype == fv.dtype
    assert (int(gtotal), int(gend)) == (int(total), int(end_row))
    live = int(end_row) * 128
    np.testing.assert_array_equal(gi[:live], fi[:live])
    np.testing.assert_array_equal(gv[:live], fv[:live])
    assert (gi[live:] == -1).all() and (gv[live:] == np.float32(kw["zero"])).all()


@pytest.mark.parametrize("name", CASES)
def test_sptuples_match_reference(name):
    """rows, cols, vals, nnz and total are equal array for array."""
    _, want = _jax_results(name)
    x, nrows, ncols, kw = _port_args(name)
    t, total = dense_to_sptuples(x, nrows, ncols, **kw)
    got = (t.rows, t.cols, t.vals, t.nnz, total)
    for field, g, w in zip(("rows", "cols", "vals", "nnz", "total"), got, want):
        assert g.numpy().dtype == w.dtype, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


def test_greedy_placement_drops_only_the_panel_that_does_not_fit():
    """At capacity 64 (40 output rows) panels 0, 1 and 3 are written and
    panel 2 is dropped, in both packages; at 3100 all four are."""
    for cap, kept in ((64, (0, 1, 3)), (3100, (0, 1, 2, 3))):
        name = f"greedy-cap{cap}"
        (fi, _, total, end_row), _ = _jax_results(name)
        x, _, _, kw = _port_args(name)
        gi, _, gtotal, gend = dense_to_tuples_arrays(x, **kw)
        for idx, tot, end in ((fi, total, end_row), (gi.numpy(), gtotal, gend)):
            live = idx[: int(end) * 128]
            live = live[live >= 0]
            assert sorted(set((live // 4096).tolist())) == list(kept)
            assert len(live) == sum(GREEDY_COUNTS[p] for p in kept)
            assert int(tot) == sum(GREEDY_COUNTS)


@pytest.mark.parametrize(
    "name, panel_cells, counts, kept",
    [
        ("used8-steps-exact", 2048, USED8_COUNTS, (0, 1, 2, 3)),
        ("used8-steps-cap1024", 2048, USED8_COUNTS, (0, 1, 2)),
        ("first-overflows", 8192, (7000, 100, 1500, 50), (1, 2, 3)),
    ],
)
def test_greedy_cases_keep_the_expected_panels(name, panel_cells, counts, kept):
    """The panels written (by the live indices' panel) and ``total``, in
    both packages: a dropped panel is dropped whole and later ones are
    still written."""
    (fi, _, total, end_row), _ = _jax_results(name)
    x, _, _, kw = _port_args(name)
    gi, _, gtotal, gend = dense_to_tuples_arrays(x, **kw)
    for idx, tot, end in ((fi, total, end_row), (gi.numpy(), gtotal, gend)):
        live = idx[: int(end) * 128]
        live = live[live >= 0]
        assert sorted(set((live // panel_cells).tolist())) == list(kept)
        assert len(live) == sum(counts[p] for p in kept)
        assert int(tot) == sum(counts)


@pytest.mark.parametrize(
    "pr, resident, rows, variant",
    [
        (8192, 660, 64, "single"),  # the main path's panels: 128 chunks
        (1 << 15, 660, 64, "single"),  # the tall panel: 512 chunks
        (1 << 15, 396, 64, "two_pass"),  # the same on a card that holds fewer blocks
        (1 << 16, 660, 64, "two_pass"),  # 1024 chunks
        (64, 1, 64, "single"),  # gcd(8000, 8192): one chunk a panel
        (8, 1, 8, "single"),
        (24, 2, 8, "two_pass"),  # three chunks of 8 rows
        (48, 3, 16, "single"),
        (96, 3, 32, "single"),
    ],
)
def test_kernel_variant_choice(pr, resident, rows, variant):
    """The chunk is the largest of 64, 32, 16, 8 rows dividing the panel;
    single-pass when the panel's chunks fit in the resident blocks."""
    assert chunk_rows(pr) == rows
    assert kernel_variant(pr, resident) == variant


def test_cpu_path_takes_a_variant_and_checks_it():
    """On CPU tensors either variant runs the plain version (no launch);
    an unknown name raises."""
    x, _, _, kw = _port_args("first-overflows")
    want = flat_to_tuples_arrays_reference(x.reshape(-1, 128), **kw)
    launches = flat_to_tuples_arrays.launches
    for variant in VARIANTS:
        got = flat_to_tuples_arrays(x.reshape(-1, 128), variant=variant, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert flat_to_tuples_arrays.launches == launches
    with pytest.raises(ValueError, match="unknown variant"):
        flat_to_tuples_arrays(x.reshape(-1, 128), variant="three_pass", **kw)


def test_reference_shape_rules_raise():
    with pytest.raises(ValueError, match="multiple of 8"):
        flat_to_tuples_arrays(torch.zeros(12, 128), capacity=16)
    with pytest.raises(ValueError, match=r"\[R, 128\]"):
        flat_to_tuples_arrays(torch.zeros(8, 64), capacity=16)
    with pytest.raises(ValueError, match="rows of 128"):
        dense_to_tuples_arrays(torch.zeros(3, 5), capacity=16)
    with pytest.raises(ValueError, match="int32"):  # checked before any allocation
        flat_to_tuples_arrays_reference(torch.empty(1 << 24, 128, device="meta"), capacity=16)


@pytest.mark.parametrize(
    "lens, capacity",
    [
        ([3, 0, 2, 5, 0, 0, 1], 16),  # zero-length sources, slack slots
        ([4, 4, 4, 4], 10),  # the count exceeds the capacity
        ([0, 0, 7], 7),
        (list(range(40)), 900),
        ([0, 0, 0], 5),  # nothing to place
        ([0, 3, 0, 0, 9, 2, 0, 4], 8),  # starts at and past the capacity
        ([1], 1),
        (np.random.default_rng(0).integers(0, 4, 300).tolist(), 256),
    ],
)
def test_expand_ranges_matches_reference(lens, capacity):
    lens = np.asarray(lens, np.int32)
    want = jax_expand_ranges(jnp.asarray(lens), capacity)
    got = expand_ranges(torch.from_numpy(lens), capacity)
    for field, g, w in zip(("owner", "offset", "valid", "total"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


SPARSIFY_CASES = {
    "exact": ("nonzero-d0.5-pr8", None),
    "padded-dims": ("padded-dims", None),
    "zero-inf": ("zero-inf", None),
    "over-capacity": ("truncation", 700),  # 8192 nonzeros into 700 slots
    "slack": ("rowmajor", 8000),
}


@pytest.mark.parametrize("name", SPARSIFY_CASES)
def test_sparsify_and_support_count_match_reference(name):
    case, capacity = SPARSIFY_CASES[name]
    x, nrows, ncols, zero, cap, _ = CASES[case]()
    capacity = capacity or cap
    want_t, want_total = jax.jit(jax_sparsify, static_argnums=(1, 2, 3, 4))(
        x, zero, nrows, ncols, capacity
    )
    got_t, got_total = sparsify(torch.from_numpy(x), zero, nrows, ncols, capacity)
    for field in ("rows", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(
            getattr(got_t, field).numpy(), np.asarray(getattr(want_t, field)), err_msg=field
        )
    assert int(got_total) == int(want_total)
    nnz = dense_support_nnz(torch.from_numpy(x), zero, nrows, ncols)
    want_nnz = jax_dense_support_nnz(jnp.asarray(x), zero, nrows, ncols)
    assert nnz.dtype == torch.int32 and int(nnz) == int(want_nnz) == int(want_total)
