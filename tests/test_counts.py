"""Rank-membership count kernels (ops.matrix) vs the numpy host scans
(cluster.breakpoints._host_*_counts), including the RankCounts device
path that part 1 takes above ``_HOST_N`` rows."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from hic_genome_assembler_tpu.cluster import breakpoints as bp
from hic_genome_assembler_tpu.ops import matrix as dev


@pytest.fixture(scope="module")
def rank_mat():
    rng = np.random.default_rng(0)
    n = 603  # deliberately not a power of two
    m = rng.random((n, n))
    return np.argsort(-m, axis=1).astype(np.int32)


@pytest.mark.parametrize("start", [0, 1, 7, 300, 601])
def test_growing_counts_match_host(rank_mat, start):
    got = np.asarray(
        dev.growing_window_counts(jnp.asarray(rank_mat), jnp.int32(start))
    )
    np.testing.assert_array_equal(got, bp._host_growing_counts(rank_mat, start))


@pytest.mark.parametrize("start,cut", [(0, 5), (3, 77), (100, 400), (0, 602)])
def test_fixed_counts_match_host(rank_mat, start, cut):
    got = np.asarray(
        dev.fixed_window_counts(
            jnp.asarray(rank_mat), jnp.int32(start), jnp.int32(cut)
        )
    )
    np.testing.assert_array_equal(got, bp._host_fixed_counts(rank_mat, start, cut))


def test_counts_many_mixed_batch_matches_host(rank_mat):
    """One batched dispatch of growing (flag=1) and fixed (flag=0) rows
    equals the per-window host scans."""
    params = np.array(
        [[0, 0, 1], [7, 0, 1], [300, 0, 1], [0, 5, 0], [3, 77, 0], [100, 400, 0]],
        dtype=np.int32,
    )
    got = np.asarray(dev.counts_many(jnp.asarray(rank_mat), jnp.asarray(params)))
    for row, (s, c, flag) in zip(got, params):
        want = (
            bp._host_growing_counts(rank_mat, s)
            if flag
            else bp._host_fixed_counts(rank_mat, s, c)
        )
        np.testing.assert_array_equal(row, want, err_msg=f"{s},{c},{flag}")


def test_counts_column_sliced_rectangular():
    """prefetch_fixed_pairs dispatches fixed windows on column-sliced
    (rectangular) views of the rank matrix — counts must equal the
    full-matrix scan for every window narrower than the slice."""
    rng = np.random.default_rng(5)
    n = 3000
    rank = np.argsort(-rng.random((n, n)), axis=1).astype(np.int32)
    b = 2048  # the smallest column bucket
    full = jnp.asarray(rank)
    sliced = full[:, :b]
    assert sliced.shape == (n, b)
    for start, cut in ((0, 5), (3, 77), (100, 640), (900, 2500), (2940, 2999)):
        assert cut - start <= b
        params = jnp.asarray(np.array([[start, cut, 0]], dtype=np.int32))
        part = np.asarray(dev.counts_many(sliced, params))[0]
        np.testing.assert_array_equal(
            part, bp._host_fixed_counts(rank, start, cut), err_msg=f"{start},{cut}"
        )


def test_rankcounts_device_path_matches_host(monkeypatch):
    """With _HOST_N at 0 every RankCounts takes the device path: direct
    calls, speculative growing batches, and width-bucketed fixed batches
    (uint16 readback) must all equal the host scans."""
    monkeypatch.setattr(bp, "_HOST_N", 0)
    rng = np.random.default_rng(2)
    n = 2300  # wider than one 2048-column bucket
    rank = np.argsort(rng.random((n, n)), axis=1).astype(np.int32)
    counts = bp.RankCounts(rank)
    assert counts._host is None

    starts = [0, 9, 1100, n - 5]
    counts.prefetch_growing(starts)
    assert counts._pending
    for s in starts:
        np.testing.assert_array_equal(
            counts.growing(s), bp._host_growing_counts(rank, s)
        )
    assert not counts._pending

    pairs = [(0, 5), (40, 2200), (2200, 40), (n - 3, n - 1)]
    counts.prefetch_fixed_pairs(pairs)
    assert all(p in counts._cache for p in pairs)
    for s, c in pairs:
        np.testing.assert_array_equal(
            counts.fixed(s, c), bp._host_fixed_counts(rank, s, c)
        )
    # uncached single windows go through the per-call kernels
    np.testing.assert_array_equal(
        counts.fixed(17, 600), bp._host_fixed_counts(rank, 17, 600)
    )
    np.testing.assert_array_equal(
        counts.growing(333), bp._host_growing_counts(rank, 333)
    )
