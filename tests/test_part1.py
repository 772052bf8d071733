"""Part 1 clustering: components + end-to-end grouping recovery."""

import numpy as np
import pytest

from hic_genome_assembler_tpu.cluster import breakpoints, louvain, upgma
from hic_genome_assembler_tpu.io import filebus
from hic_genome_assembler_tpu.models import part1_cluster
from hic_genome_assembler_tpu.ops import oracle
from hic_genome_assembler_tpu.utils import fixtures


# ---- hypergeometric machinery -------------------------------------------

def test_hyper_geom_sf_matches_scalar():
    import scipy.stats

    got = breakpoints.hyper_geom_sf([3, 5], 100, 10, 10)
    want = [scipy.stats.hypergeom.sf(2, 100, 10, 10), scipy.stats.hypergeom.sf(4, 100, 10, 10)]
    np.testing.assert_allclose(got, want)


def test_sliding_window_break_signals():
    # doc example: [1,1,1,1,1, 0,1,0,0,0] window 3 -> max contrast 2 at i=2
    sig = np.array([1, 1, 1, 1, 1, 0, 1, 0, 0, 0])
    out = breakpoints.sliding_window_break_signals(sig, 3)
    assert len(out) == 7
    # i=2: left=[1,1,1]=3, right=[0,1,0]=1 -> 2
    assert out[2] == 2
    # truncated right half scores 0 (i=5: right=[0,0] shorter than 3)
    assert out[5] == 0
    # window >= len -> empty (the "NA" path)
    assert len(breakpoints.sliding_window_break_signals(sig, 10)) == 0


def _block_rank_matrix(sizes, seed=0):
    """Rank matrix of a block-diagonal similarity structure."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    same = labels[:, None] == labels[None, :]
    m = np.where(same, 10.0 + rng.random((n, n)), rng.random((n, n)) * 0.1)
    m = np.triu(m) + np.triu(m, 1).T
    return oracle.rank_matrix_desc(m)


def test_breakpoint_scan_finds_block_boundaries():
    sizes = (20, 15, 12)
    ranks = _block_rank_matrix(sizes)
    counts = breakpoints.RankCounts(ranks)
    cuts = breakpoints.pre_process_all_matrix_breakpoints(counts, min_size=5, min_frac=0.05)
    # aggressive cuts must include the true boundaries 20 and 35
    assert 20 in cuts and 35 in cuts
    filtered = breakpoints.filter_noisy_breakpoints(counts, cuts)
    assert filtered == [20, 35]


def test_filter_noisy_empty():
    ranks = _block_rank_matrix((8, 8))
    counts = breakpoints.RankCounts(ranks)
    assert breakpoints.filter_noisy_breakpoints(counts, []) == []


def test_pure_modularity_mode_returns_no_cuts():
    ranks = _block_rank_matrix((8, 8))
    counts = breakpoints.RankCounts(ranks)
    assert breakpoints.pre_process_all_matrix_breakpoints(counts, min_frac=1) == []


# ---- Louvain -------------------------------------------------------------

def test_louvain_two_cliques():
    n = 12
    adj = np.zeros((n, n))
    adj[:6, :6] = 5.0
    adj[6:, 6:] = 5.0
    adj[5, 6] = adj[6, 5] = 0.1  # weak bridge
    np.fill_diagonal(adj, 1.0)
    part = louvain.best_partition(adj, seed=1)
    labels = np.asarray([part[i] for i in range(n)])
    assert len(set(labels[:6])) == 1
    assert len(set(labels[6:])) == 1
    assert labels[0] != labels[-1]
    q = louvain.modularity(labels, adj)
    assert q > 0.3


def test_louvain_deterministic():
    rng = np.random.default_rng(4)
    adj = rng.random((20, 20))
    adj = adj + adj.T
    a = louvain.best_partition(adj, seed=7)
    b = louvain.best_partition(adj, seed=7)
    assert a == b


def test_modularity_matches_networkx():
    import networkx as nx

    rng = np.random.default_rng(5)
    adj = np.triu(rng.random((10, 10)), 0)
    adj = adj + np.triu(adj, 1).T
    labels = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 2])
    g = nx.from_numpy_array(adj)
    want = nx.community.modularity(
        g, [set(np.nonzero(labels == c)[0]) for c in range(3)], weight="weight"
    )
    got = louvain.modularity(labels, adj)
    assert got == pytest.approx(want, rel=1e-9)


# ---- UPGMA ---------------------------------------------------------------

def test_upgma_groups_blocks():
    sizes = (6, 5)
    rng = np.random.default_rng(6)
    n = sum(sizes)
    labels = np.repeat(np.arange(2), sizes)
    same = labels[:, None] == labels[None, :]
    dist = np.where(same, 1.0 + rng.random((n, n)) * 0.05, 1.9 + rng.random((n, n)) * 0.05)
    names = [f"b{i}" for i in range(n)]
    dendro = upgma.average_cluster_leaf_order(dist, names)
    leaves = dendro["leaves"]
    # the two blocks must come out contiguous
    leaf_labels = labels[leaves]
    switches = int((np.diff(leaf_labels) != 0).sum())
    assert switches == 1


# ---- end-to-end ----------------------------------------------------------

@pytest.fixture(scope="module")
def p1_genome():
    # chromosome blocks must be large enough that the growing-window scan
    # has wide windows at any dendrogram-order discontinuity; tiny
    # chromosomes genuinely over-cut (a property shared with the
    # reference algorithm, which has min_size*resolution as its floor).
    return fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13,
        noise=0.005,
        cross_noise_frac=0.001,
    )


def test_part1_pipeline_recovers_groups(tmp_path, p1_genome):
    """Hypergeom-only grouping (modularity=0): exact group recovery.

    With modularity > 0 the Louvain step runs on everything past the
    LAST cut — which, when the scan resolves all chromosomes, is the
    entire final chromosome, which Louvain then subdivides.  That is
    faithful reference behavior (modularity_remaining_data starts at
    cutIndices[-1], scaffoldToChromosomes.py:280); its intended regime
    (small unresolved tail) is covered by
    test_modularity_tail_resolves_small_chromosomes.
    """
    g = p1_genome
    paths = fixtures.write_hicpro_files(g, str(tmp_path / "hicpro"))
    out = {
        "dendro": tmp_path / "dendro.txt",
        "bins": tmp_path / "bingroups.txt",
        "assess": tmp_path / "assessment.txt",
        "groups": tmp_path / "chromgroups.txt",
    }
    part1_cluster.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        str(out["dendro"]), "", "",
        str(out["bins"]), str(out["assess"]), str(out["groups"]),
        hyper_geom=True, hmm=False, min_size=5, modularity=0,
        louvain_rounds=3, psig=0.05, convergence_rounds=5, look_ahead=0.2,
        resolution=g.resolution,
    )
    groups = filebus.read_chroms_from_file(str(out["groups"]))
    got = [frozenset(name for _b, name in grp) for grp in groups]
    want = [frozenset(names) for _c, names in sorted(g.true_groups().items())]
    assert sorted(got, key=sorted) == sorted(want, key=sorted), (got, want)
    # assessment file reports zero error on clean fixture
    text = out["assess"].read_text()
    assert "Error rate ~0.0%" in text


def test_modularity_tail_resolves_small_chromosomes():
    """The Louvain tail step's intended regime: cuts resolve the big
    chromosomes; the unresolved tail holds two small ones."""
    from hic_genome_assembler_tpu.io import hicpro as hp

    rng = np.random.default_rng(21)
    sizes = (30, 8, 7)  # head chromosome + two small tail chromosomes
    n = sum(sizes)
    labels = np.repeat(np.arange(3), sizes)
    same = labels[:, None] == labels[None, :]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    m = np.where(same, 100.0 / (1.0 + dist), rng.random((n, n)) * 0.05)
    m = np.triu(m) + np.triu(m, 1).T
    # the pipeline hands the modularity step the log10 similarity matrix
    # (scaffoldToChromosomes.py:1135,1150-1152)
    from hic_genome_assembler_tpu.ops import oracle

    m = oracle.log_transform(m, log_base=10, plus_one=True)
    bins = [hp.Bin(i, f"s{i}", 0, 10, 1.0, float(m[i].sum())) for i in range(n)]
    adj, bins2, cuts = part1_cluster.modularity_remaining_data(
        m, bins, [30], n_rounds=3, seed=0
    )
    assert cuts[0] == 30
    # tail must be split into exactly the two planted chromosomes
    assert len(cuts) == 2
    tail_labels = [labels[int(b.ID[1:]) if isinstance(b.ID, str) else b.ID] for b in bins2[30:]]
    first_group = set(tail_labels[: cuts[1] - 30])
    second_group = set(tail_labels[cuts[1] - 30 :])
    assert first_group in ({1}, {2}) and second_group in ({1}, {2})
    assert first_group != second_group
    # head order untouched
    assert [b.ID for b in bins2[:30]] == list(range(30))


def test_pending_speculation_matches_host_counts():
    """The deferred-readback speculation machinery (prefetch_growing /
    prefetch_fixed_pairs / pending materialization) must produce counts
    identical to the direct host scan, and pre_process/filter must give
    identical cuts with and without it (the 16K path exercises it on
    the GPU; here the XLA-CPU device path at n > _HOST_N)."""
    from hic_genome_assembler_tpu.cluster import breakpoints as bp

    rng = np.random.default_rng(4)
    n = bp._HOST_N + 160
    # valid rank matrix: each row a permutation (what rank_matrix_desc yields)
    rank = np.argsort(rng.random((n, n)), axis=1).astype(np.int32)

    dev = bp.RankCounts(rank)            # n >= _HOST_N -> device path
    assert dev._host is None
    host = np.asarray(rank, dtype=np.int32)

    starts = [0, 7, 123, 2049, n - 9]
    dev.prefetch_growing(starts)
    assert dev._pending
    for s in starts:
        np.testing.assert_array_equal(
            dev.growing(s), bp._host_growing_counts(host, s)
        )
    assert not dev._pending  # materialized wholesale

    pairs = [(0, 5), (17, 900), (900, 17), (5, n - 1), (n - 2, n - 1)]
    dev.prefetch_fixed_pairs(pairs)
    for s, c in pairs:
        np.testing.assert_array_equal(
            dev.fixed(s, c), bp._host_fixed_counts(host, s, c)
        )
