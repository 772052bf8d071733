"""JAX Gaussian HMM + HMM cut strategy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hic_genome_assembler_tpu.cluster import hmm_cuts
from hic_genome_assembler_tpu.ops import gaussian_hmm
from hic_genome_assembler_tpu.ops.gaussian_hmm import GaussianHMM2, kmeans2


def two_segment_obs(seed=0, t1=40, t2=40, d=6, sep=4.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 1.0, (t1, d))
    b = rng.normal(sep, 1.0, (t2, d))
    return np.vstack([a, b])


def test_hmm_segments_two_states():
    X = two_segment_obs()
    model = GaussianHMM2(seed=0).fit(X)
    states = model.predict(X)
    # one contiguous switch, segments pure
    assert len(set(states[:40])) == 1
    assert len(set(states[40:])) == 1
    assert states[0] != states[-1]


def test_hmm_transmat_reestimated():
    X = two_segment_obs(seed=1)
    model = GaussianHMM2(seed=0).fit(X)
    assert model.transmat_.shape == (2, 2)
    np.testing.assert_allclose(model.transmat_.sum(axis=1), [1.0, 1.0], rtol=1e-9)
    # startprob stays uniform (the reference's startmat_ typo behavior)
    np.testing.assert_allclose(model.startprob, [0.5, 0.5])


def test_identify_boundary():
    states = np.array([0] * 20 + [1] * 20)
    cut = hmm_cuts.identify_boundary(states, [0], switch_count=5)
    assert cut == 20
    # offset by previous cut
    cut = hmm_cuts.identify_boundary(states, [0, 100], switch_count=5)
    assert cut == 120
    # no sustained switch -> 0
    noisy = np.array([0, 1] * 20)
    assert hmm_cuts.identify_boundary(noisy, [0], switch_count=5) == 0


def test_hmm_cut_strategy_on_blocks():
    """Two-chromosome log-similarity structure -> boundary recovered."""
    rng = np.random.default_rng(3)
    sizes = (35, 30)
    n = sum(sizes)
    labels = np.repeat(np.arange(2), sizes)
    same = labels[:, None] == labels[None, :]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    m = np.where(same, 2.0 - np.log10(1.0 + dist), 0.0) + rng.random((n, n)) * 0.01
    m = np.triu(m) + np.triu(m, 1).T

    cuts = hmm_cuts.identify_chromosome_groups_hmm(
        m, None, min_size=5, modularity=0.05, convergence_rounds=5, look_ahead=False
    )
    assert any(abs(c - 35) <= 2 for c in cuts), cuts


def test_part1_pipeline_hmm_branch_recovers_groups(tmp_path):
    """End-to-end part1 with the HMM cut strategy (run_pipeline's
    hmm=True branch, scaffoldToChromosomes.py:1138-1141).

    Fixture design follows the HMM mode's operating assumptions (shared
    with the reference algorithm — proven line-identical by the golden
    parity test in test_reference_parity.py):

    * within-chromosome contact is flat (decay_alpha=0).  With distance
      decay, rows of ONE chromosome are genuinely bimodal over the
      look-ahead window, so ANY faithful 2-state HMM cuts inside it —
      the reference does this too; its default pipeline relies on the
      modularity tail to absorb that, not the HMM;
    * chromosome sizes (UPGMA orders them small->large via
      count_sort='ascending') are chosen so that after the last true
      boundary the remainder satisfies remaining/2 < minSize, hitting
      the clean "NA" termination (scaffoldToChromosomes.py:777-779)
      instead of the terminal-0 oscillation.
    """
    from hic_genome_assembler_tpu.io import filebus
    from hic_genome_assembler_tpu.models import part1_cluster
    from hic_genome_assembler_tpu.utils import fixtures

    g = fixtures.make_genome(
        chrom_scaffold_bins=((7, 6, 4, 3), (6, 5, 5), (4, 4, 2, 2)),
        seed=5,
        noise=0.004,
        cross_noise_frac=0.001,
        decay_alpha=0.0,
    )
    paths = fixtures.write_hicpro_files(g, str(tmp_path / "hicpro"))
    out = {k: str(tmp_path / f"{k}.txt") for k in
           ("dendro", "bins", "assess", "groups")}
    part1_cluster.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        out["dendro"], "", "",
        out["bins"], out["assess"], out["groups"],
        hyper_geom=False, hmm=True, min_size=11, modularity=0,
        louvain_rounds=3, psig=0.05, convergence_rounds=5, look_ahead=0.5,
        resolution=g.resolution,
    )
    groups = filebus.read_chroms_from_file(out["groups"])
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(names) for names in g.true_groups().values())
    assert got == want, (got, want)


def test_hmm_fast_and_exact_modes_agree_on_segmentation():
    """fast (shape-bucketed masked EM, fused Viterbi) and exact
    (unpadded) modes are different XLA programs, so floats differ in
    ULPs — but on a well-separated 2-state signal the segmentation
    decision must be identical."""
    rng = np.random.default_rng(5)
    X = np.concatenate(
        [rng.normal(0.0, 0.3, (40, 6)), rng.normal(4.0, 0.3, (35, 6))]
    )
    fast = GaussianHMM2(seed=0, mode="fast").fit(X)
    exact = GaussianHMM2(seed=0, mode="exact").fit(X)
    assert np.array_equal(fast.predict(X), exact.predict(X))


def test_hmm_fast_predict_cache_and_miss():
    """fit() caches the fused-decode path; predict on the SAME
    observations returns it, predict on OTHER observations computes a
    fresh Viterbi of the right length."""
    rng = np.random.default_rng(6)
    X = np.concatenate(
        [rng.normal(0.0, 0.2, (30, 4)), rng.normal(3.0, 0.2, (30, 4))]
    )
    m = GaussianHMM2(seed=0, mode="fast").fit(X)
    path = m.predict(X)
    # cache hit: equals the fused-decode path but is a FRESH array (a
    # caller mutating the result must not corrupt the cache)
    assert np.array_equal(path, m._fit_path)
    assert path is not m._fit_path
    path[:] = 9
    assert not np.array_equal(path, m._fit_path)
    other = rng.normal(1.5, 0.2, (17, 4))
    fresh = m.predict(other)
    assert fresh.shape == (17,)
    assert fresh is not m._fit_path


def test_hmm_fast_mode_padding_is_inert():
    """A fit whose shape lands exactly on the bucket floor and one that
    pads heavily must segment a clean signal identically — the masked
    pads contribute nothing."""
    rng = np.random.default_rng(7)
    base = np.concatenate(
        [rng.normal(0.0, 0.25, (128, 8)), rng.normal(5.0, 0.25, (128, 8))]
    )
    small = base[:100]  # pads 100 -> 256 frames
    m = GaussianHMM2(seed=0, mode="fast").fit(small)
    assert m.predict(small).shape == (100,)
    assert set(np.unique(m.predict(base[:100]))) <= {0, 1}


def _dot_precisions(jaxpr):
    """precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


def _hmm_programs():
    T, D = 16, 3
    X = jnp.ones((T, D))
    mk = jnp.ones((2, D))
    trans = jnp.full((2, 2), 0.5)
    log_start = jnp.log(jnp.full((2,), 0.5))
    return {
        "masked_fit": (
            lambda: gaussian_hmm._fit_predict_masked(
                X, T, D, mk, mk, trans, log_start, 1e-2, n_iter=5)
        ),
        "exact_fit": (
            lambda: gaussian_hmm._em_fit(X, mk, mk, trans, log_start, 1e-2, n_iter=5)
        ),
        "predict_density": lambda: gaussian_hmm._log_gaussian_diag(X, mk, mk),
    }


@pytest.mark.parametrize("name", ["masked_fit", "exact_fit", "predict_density"])
def test_hmm_matmuls_pin_highest_precision(name):
    """Every f32 product of the HMM step runs at HIGHEST (a GPU would
    otherwise run it in TF32)."""
    jaxpr = jax.make_jaxpr(_hmm_programs()[name])().jaxpr
    precisions = _dot_precisions(jaxpr)
    assert precisions, "no dot_general found"
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions


def test_kmeans2_deterministic_and_separates():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0.0, 0.3, (50, 3)), rng.normal(4.0, 0.3, (40, 3))])
    a = kmeans2(X, seed=1, n_init=3)
    b = kmeans2(X, seed=1, n_init=3)
    np.testing.assert_array_equal(a, b)
    centers = a[np.argsort(a[:, 0])]
    np.testing.assert_allclose(centers[0], X[:50].mean(axis=0), atol=1e-12)
    np.testing.assert_allclose(centers[1], X[50:].mean(axis=0), atol=1e-12)
    # a constant input has one center however it is seeded
    np.testing.assert_array_equal(kmeans2(np.ones((5, 2)), seed=3), np.ones((2, 2)))
