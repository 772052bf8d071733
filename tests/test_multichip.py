"""Multi-device paths: sharded scorers and the fused pipeline step must
agree with single-device results on the 8-device CPU mesh."""

import numpy as np
import pytest

from hic_genome_assembler_tpu.ops import cost, perms
from hic_genome_assembler_tpu.parallel import mesh as pm


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh((8, 1))


def _problem(seed=0, sizes=(5, 4, 3, 2)):
    rng = np.random.default_rng(seed)
    C = sum(sizes)
    m = rng.random((C, C))
    m = np.triu(m, 1)
    m = m + m.T + np.diag(rng.random(C))
    return m, list(sizes)


def test_block_scorer_sharded_equals_local(mesh8):
    m, sizes = _problem()
    orders = perms.order_batch(len(sizes))
    orients = perms.orient_batch(len(sizes))
    local = cost.BlockScorer(m, sizes, dtype=np.float64).score_batch(orders, orients)
    sharded = cost.BlockScorer(m, sizes, dtype=np.float64, mesh=mesh8).score_batch(
        orders, orients
    )
    np.testing.assert_allclose(sharded, local, rtol=1e-12)


def test_score_pairs_sharded_equals_local(mesh8):
    """The greedy/sliding-window per-candidate kernel DP-shards its
    batch over the mesh and matches the local path exactly (batch of 13:
    exercises the repeat-last padding)."""
    m, sizes = _problem(1)
    rng = np.random.default_rng(2)
    S = len(sizes)
    orders = np.stack([rng.permutation(S) for _ in range(13)]).astype(np.int32)
    orients = rng.integers(0, 2, orders.shape).astype(np.int32)
    local = cost.BlockScorer(m, sizes, dtype=np.float64).score_pairs(orders, orients)
    sharded = cost.BlockScorer(m, sizes, dtype=np.float64, mesh=mesh8).score_pairs(
        orders, orients
    )
    np.testing.assert_allclose(sharded, local, rtol=1e-12)


def test_part2_chromosome_with_mesh(mesh8):
    """order_chromosome under a mesh context gives the identical result."""
    from hic_genome_assembler_tpu.io import hicpro
    from hic_genome_assembler_tpu.models import part2_order
    from hic_genome_assembler_tpu.utils import fixtures

    g = fixtures.make_genome(
        chrom_scaffold_bins=((8, 6, 4, 3),), seed=23, noise=0.002, cross_noise_frac=0.0
    )
    bins = [
        hicpro.Bin(bid, s.name, 0, 0, 1.0, 0.0)
        for s in g.scaffolds
        for bid in s.bin_ids
    ]
    group = []
    for name in g.true_groups()[0]:
        s = g.scaffold(name)
        group.extend([bid, name] for bid in s.bin_ids)

    ctx_local = part2_order._ChromosomeContext(g.matrix, bins)
    ctx_mesh = part2_order._ChromosomeContext(g.matrix, bins, mesh=mesh8)
    rec_local = part2_order.order_chromosome(group, ctx_local, 3, 3)
    local = [(s.name, s.orientation) for s in rec_local]
    rec_mesh = part2_order.order_chromosome(group, ctx_mesh, 3, 3)
    sharded = [(s.name, s.orientation) for s in rec_mesh]
    assert local == sharded


def test_fused_step_runs_on_mesh(mesh8):
    from hic_genome_assembler_tpu.parallel import pipeline_step

    step = pipeline_step.make_fused_step(mesh8)
    inputs = pipeline_step.example_inputs(mesh8)
    dist, counts, costs, best = step(*inputs)
    assert len(dist.sharding.device_set) == 8
    assert counts.shape == (64,)
    assert 0 <= int(best) < costs.shape[0]
    # its f32 contraction pins HIGHEST (no TF32 on a GPU)
    import jax

    jaxpr = jax.make_jaxpr(pipeline_step._step)(*inputs).jaxpr
    dots = [e.params["precision"] for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    highest = jax.lax.Precision.HIGHEST
    assert dots and all(p == (highest, highest) for p in dots)


def test_rank_counts_sharded_equals_local(mesh8):
    """RankCounts over the 2-D sharded rank matrix == local (VERDICT r1
    item 5: the SP count kernels as a mesh product, not a demo).

    Integer counts, so equality is exact."""
    from hic_genome_assembler_tpu.cluster.breakpoints import RankCounts
    from hic_genome_assembler_tpu.ops import oracle

    rng = np.random.default_rng(7)
    n = 45  # deliberately not a multiple of the mesh: exercises padding
    m = rng.random((n, n))
    m = np.triu(m, 1) + np.triu(m, 1).T + np.diag(rng.random(n))
    rank = oracle.rank_matrix_desc(m)

    local = RankCounts(rank)
    sharded = RankCounts(rank, mesh=mesh8)
    assert len(sharded._dev.sharding.device_set) == 8
    for start in (0, 3, 17):
        np.testing.assert_array_equal(sharded.growing(start), local.growing(start))
    for start, cut in ((0, 10), (5, 30), (17, 44)):
        np.testing.assert_array_equal(
            sharded.fixed(start, cut), local.fixed(start, cut)
        )
    # batch prefetch path
    sharded2 = RankCounts(rank, mesh=mesh8)
    sharded2.prefetch_fixed(2, [8, 21, 40])
    for cut in (8, 21, 40):
        np.testing.assert_array_equal(
            sharded2.fixed(2, cut), local.fixed(2, cut)
        )


def test_rank_counts_sharded_2d_mesh():
    """Same equality on a (4, 2) mesh where the model axis is real and
    the per-row count reduction psums across it."""
    from hic_genome_assembler_tpu.cluster.breakpoints import RankCounts
    from hic_genome_assembler_tpu.ops import oracle

    mesh42 = pm.make_mesh((4, 2))
    rng = np.random.default_rng(9)
    n = 37
    m = rng.random((n, n))
    m = np.triu(m, 1) + np.triu(m, 1).T + np.diag(rng.random(n))
    rank = oracle.rank_matrix_desc(m)
    local = RankCounts(rank)
    sharded = RankCounts(rank, mesh=mesh42)
    np.testing.assert_array_equal(sharded.growing(4), local.growing(4))
    np.testing.assert_array_equal(sharded.fixed(4, 20), local.fixed(4, 20))
