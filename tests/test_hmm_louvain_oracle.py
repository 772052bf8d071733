"""Independent validation of the two re-implemented dependencies
(VERDICT r2 missing #3).

The reference depends on hmmlearn (scaffoldToChromosomes.py:797-801) and
python-louvain (:253); neither is installable in this offline image, so:

* GaussianHMM2 is validated against a from-the-math numpy EM oracle
  (ops/oracle.py) with a DIFFERENT numerical route (scaled probability-
  space forward-backward instead of log-space scans) under identical
  initialization, plus a k-means-init sensitivity quantification
  (hmmlearn's KMeans(random_state=None) vs the pinned seed);
* the dense Louvain is validated against networkx 3.x — a real
  third-party implementation of the same algorithm
  (nx.community.louvain_communities) — via the modularity functional
  (nx.community.modularity, including the self-loop convention) and
  partition quality across seeds, plus brute-force-optimal partitions
  on small graphs.
"""

import itertools

import numpy as np
import pytest

from hic_genome_assembler_tpu.cluster import louvain
from hic_genome_assembler_tpu.ops.gaussian_hmm import GaussianHMM2
from hic_genome_assembler_tpu.ops.oracle import (
    gaussian_hmm_em_fit,
    gaussian_hmm_log_density,
    gaussian_hmm_viterbi,
)


def _regime_data(rng, T=220, sep=4.0):
    """Two-regime 1-D sequence like the reference's HMM input."""
    states = np.zeros(T, dtype=int)
    pos = 0
    while pos < T:
        ln = int(rng.integers(15, 45))
        states[pos : pos + ln] = rng.integers(0, 2)
        pos += ln
    x = rng.normal(0.0, 1.0, T) + states * sep
    return x[:, None], states


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_gaussian_hmm_matches_numpy_oracle(seed):
    """Identical init -> the JAX EM and the probability-space numpy EM
    must converge to the same parameters and the same Viterbi path."""
    rng = np.random.default_rng(seed)
    X, _truth = _regime_data(rng)
    model = GaussianHMM2(seed=0)
    # pin identical initialization on both sides
    means0, covars0 = model._init_params(X)
    trans0 = model.transmat_init.copy()
    model._init_params = lambda _x: (means0.copy(), covars0.copy())
    model.fit(X)
    m_np, c_np, t_np = gaussian_hmm_em_fit(
        X, means0.copy(), covars0.copy(), trans0, model.startprob, 1e-2, 1000
    )
    np.testing.assert_allclose(model.means_, m_np, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(model.covars_, c_np, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(model.transmat_, t_np, rtol=5e-3, atol=5e-3)
    path_jax = model.predict(X)
    path_np = gaussian_hmm_viterbi(
        gaussian_hmm_log_density(X, m_np, c_np), model.startprob, t_np
    )
    assert (path_jax == path_np).all()


def test_gaussian_hmm_recovers_planted_regimes():
    rng = np.random.default_rng(7)
    X, truth = _regime_data(rng, sep=5.0)
    model = GaussianHMM2(seed=0).fit(X)
    path = model.predict(X)
    # label-invariant agreement with the planted regimes
    agree = max((path == truth).mean(), (path != truth).mean())
    assert agree > 0.97


def test_gaussian_hmm_kmeans_seed_sensitivity():
    """hmmlearn initializes KMeans with random_state=None; GaussianHMM2
    pins a seed.  Quantify the gap: on regime-structured data the final
    Viterbi path must be identical for every k-means seed (EM washes
    the init out), so the pinned seed is a determinism win, not a
    behavioral divergence."""
    rng = np.random.default_rng(11)
    X, _ = _regime_data(rng, sep=3.0)
    paths = []
    for seed in range(6):
        m = GaussianHMM2(seed=seed).fit(X)
        p = m.predict(X)
        # canonicalize labels by the state means so label swaps from
        # k-means ordering do not read as disagreement
        if m.means_[0, 0] > m.means_[1, 0]:
            p = 1 - p
        paths.append(p)
    for p in paths[1:]:
        assert (p == paths[0]).all()


# ---------------------------------------------------------------------------
# Louvain vs networkx (real third-party implementation)
# ---------------------------------------------------------------------------


def _random_block_graph(rng, n_blocks=4, per=8, p_in=0.7, p_out=0.05):
    n = n_blocks * per
    truth = np.repeat(np.arange(n_blocks), per)
    a = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            p = p_in if truth[i] == truth[j] else p_out
            if rng.random() < p:
                a[i, j] = a[j, i] = rng.integers(1, 5)
    return a, truth


def _nx_graph(a):
    import networkx as nx

    g = nx.Graph()
    n = a.shape[0]
    g.add_nodes_from(range(n))
    for i in range(n):
        for j in range(i, n):
            if a[i, j] > 0:
                g.add_edge(i, j, weight=float(a[i, j]))
    return g


def _nx_modularity(a, labels):
    import networkx as nx

    comms = [set(np.nonzero(labels == c)[0].tolist()) for c in np.unique(labels)]
    return nx.community.modularity(_nx_graph(a), comms, weight="weight")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_modularity_functional_matches_networkx(seed):
    """Including self-loops — the convention the dense implementation
    claims to share with networkx/python-louvain."""
    rng = np.random.default_rng(seed)
    a, _ = _random_block_graph(rng)
    np.fill_diagonal(a, rng.integers(0, 3, a.shape[0]).astype(float))
    labels = rng.integers(0, 3, a.shape[0])
    q_ours = louvain.modularity(labels, a)
    q_nx = _nx_modularity(a, labels)
    assert q_ours == pytest.approx(q_nx, abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_louvain_partition_quality_matches_networkx(seed):
    """The dense Louvain must find partitions at least as good (in its
    own exactly-validated modularity) as networkx's Louvain, and
    recover planted blocks."""
    import networkx as nx

    rng = np.random.default_rng(seed)
    a, truth = _random_block_graph(rng)
    part = louvain.best_partition(a, seed=seed)
    labels = np.asarray([part[i] for i in range(a.shape[0])])
    q_ours = louvain.modularity(labels, a)

    nx_comms = nx.community.louvain_communities(
        _nx_graph(a), weight="weight", seed=seed
    )
    nx_labels = np.empty(a.shape[0], dtype=int)
    for c, nodes in enumerate(nx_comms):
        for v in nodes:
            nx_labels[v] = c
    q_nx = louvain.modularity(nx_labels, a)
    assert q_ours >= q_nx - 1e-9
    # planted-block recovery: near-perfect label-invariant agreement
    # (under p_out noise the modularity optimum can legitimately move a
    # node or two off the planted blocks — both implementations agree
    # on the same optimum, which is the claim that matters)
    from itertools import permutations

    k = len(np.unique(truth))
    if len(np.unique(labels)) == k:
        best = max(
            (np.asarray([p[t] for t in truth]) == labels).mean()
            for p in permutations(range(k))
        )
        assert best >= 0.9


def test_louvain_reaches_bruteforce_optimum_small_graphs():
    """n=8: enumerate EVERY partition (Bell(8)=4140) and assert the
    Louvain result attains the global modularity optimum."""

    def partitions(collection):
        if len(collection) == 1:
            yield [collection]
            return
        first = collection[0]
        for smaller in partitions(collection[1:]):
            for i, subset in enumerate(smaller):
                yield smaller[:i] + [[first] + subset] + smaller[i + 1 :]
            yield [[first]] + smaller

    for seed in range(3):
        rng = np.random.default_rng(seed)
        a, _ = _random_block_graph(rng, n_blocks=2, per=4, p_in=0.9, p_out=0.1)
        n = a.shape[0]
        best_q = -np.inf
        for part in partitions(list(range(n))):
            labels = np.empty(n, dtype=int)
            for c, grp in enumerate(part):
                labels[grp] = c
            best_q = max(best_q, louvain.modularity(labels, a))
        part = louvain.best_partition(a, seed=seed)
        labels = np.asarray([part[i] for i in range(n)])
        assert louvain.modularity(labels, a) == pytest.approx(best_q, abs=1e-9)


def test_native_louvain_sweep_bit_identical_to_numpy_oracle():
    """The production native sweep (native/louvain_sweep.cpp) must
    produce BIT-identical partitions to the numpy oracle sweep at the
    multi-level best_partition granularity, across matrix families
    engineered to stress tie-breaking (integer weights = exact float
    ties; block structure = the realistic case; uniform noise)."""
    from hic_genome_assembler_tpu.io import native

    if not native.available():
        pytest.skip("native toolchain unavailable")

    def run(level_fn, adj, seed):
        rng = np.random.default_rng(seed)
        a = np.asarray(adj, dtype=np.float64)
        mapping = np.arange(a.shape[0])
        a_tilde, _k, _m = louvain._prep(a)
        level_adj = a_tilde
        while True:
            comm = level_fn(
                level_adj, level_adj.sum(axis=1), float(level_adj.sum()), rng
            )
            collapsed, relabel = louvain._aggregate(level_adj, comm)
            mapping = relabel[mapping]
            if collapsed.shape[0] == level_adj.shape[0]:
                break
            level_adj = collapsed
        return mapping

    rng0 = np.random.default_rng(0)
    for trial in range(12):
        n = int(rng0.integers(20, 200))
        kind = trial % 3
        if kind == 0:
            a = rng0.random((n, n))
        elif kind == 1:
            labels = rng0.integers(0, int(rng0.integers(2, 6)), n)
            a = 0.05 * rng0.random((n, n)) + 1.0 * (
                labels[:, None] == labels[None, :]
            )
        else:  # integer weights: exact-tie-heavy
            a = rng0.integers(0, 4, (n, n)).astype(float)
        a = np.triu(a) + np.triu(a, 1).T
        for seed in (0, 1):
            m_np = run(louvain._one_level_numpy, a, seed)
            m_nat = run(louvain._one_level, a, seed)
            assert np.array_equal(m_np, m_nat), (trial, kind, n, seed)
