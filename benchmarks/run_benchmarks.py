"""Benchmark harness for the five BASELINE.json configs.

Each config prints ONE JSON line:
  {"config": N, "name": ..., "metrics": {...}}

Usage:
  python benchmarks/run_benchmarks.py --config 1      # one config
  python benchmarks/run_benchmarks.py --all           # all five
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/run_benchmarks.py --all       # 8-device CPU mesh

Configs (BASELINE.json):
  1. working-example-scale end-to-end parts 1+2+4 on synthetic data with
     planted truth (wall-clock + grouping/order truth match);
  2. part1 dense stages at 1.6 Gb scale (16K x 16K loci): distance
     transform, rank matrix, growing-window membership counts —
     single-device and (when >1 device) mesh-sharded;
  3. part2 brute-force permutation scoring, data-parallel over the
     mesh's data axis (the bench.py workload, plus the DP variant);
  4. part3 validPairs streaming rate (native C++ scanner vs python);
  5. multi-resolution sweep: full pipeline at 3 bin resolutions,
     replicated vs mesh-sharded scoring, FASTA byte-equality between
     the two runs.

Scale note: config 2 uses the full 16K x 16K (1 GiB f32) matrix unless
--small is passed.  Every emitted line names the platform, device kind
and device count (and, on a GPU, each card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hic_genome_assembler_tpu.parallel import runtime  # noqa: E402


def _emit(config: int, name: str, metrics: dict) -> None:
    """One JSON line per config, naming the device it ran on (a CPU
    run's times are CPU times, never device metrics)."""
    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if device["platform"] == "gpu":
        device["card"] = runtime.nvidia_smi_identity()
    print(
        json.dumps(
            {"config": config, "name": name, "device": device, "metrics": metrics}
        ),
        flush=True,
    )


# ---------------------------------------------------------------------------
# config 1 — end-to-end parts 1+2+4 with planted truth
# ---------------------------------------------------------------------------


def config1(workdir: str = "/tmp/hic_bench_c1") -> None:
    from hic_genome_assembler_tpu.io import fasta, filebus
    from hic_genome_assembler_tpu.models import part1_cluster, part2_order, part4_fasta
    from hic_genome_assembler_tpu.utils import fixtures

    os.makedirs(workdir, exist_ok=True)
    # the golden-parity fixture shape (tests/test_reference_parity.py):
    # empirically recoverable by the reference ALGORITHM — the original
    # 141-bin layout's largest scaffolds formed UPGMA sub-clusters the
    # growing-window scan legitimately cuts (the reference does too)
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13,
        noise=0.005,
        cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    files = lambda n: os.path.join(workdir, n)  # noqa: E731

    start = time.time()
    part1_cluster.run_pipeline(
        hic_pro_bed_file=paths["bed"],
        hic_pro_bias_file=paths["bias"],
        hic_pro_matrix_file=paths["matrix"],
        hic_pro_scaff_size_file=paths["sizes"],
        dendrogram_order_file=files("dendro.txt"),
        avg_cluster_plot="",
        avg_cluster_plot_outlined="",
        bin_group_file=files("bingroups.txt"),
        assessment_file=files("assessment.txt"),
        chromosome_group_file=files("chromgroups.txt"),
        hyper_geom=True,
        hmm=False,
        min_size=5,
        modularity=0,
        louvain_rounds=3,
        psig=0.05,
        convergence_rounds=10,
        look_ahead=0.5,
        resolution=genome.resolution,
        louvain_seed=0,
    )
    t_part1 = time.time() - start

    start = time.time()
    part2_order.run_pipeline(
        hic_pro_bed_file=paths["bed"],
        hic_pro_bias_file=paths["bias"],
        hic_pro_matrix_file=paths["matrix"],
        chromosome_group_file=files("chromgroups.txt"),
        chromosome_order_file=files("chromorder.txt"),
        save_plots_directory="",
        chromosome_plot_suffix="",
        full_genome_plot="",
        full_genome_plot_title="",
        plot_order_file=files("plotorder.txt"),
        n_scaffolds=5,
        scan_scaffolds=4,
        resolution=genome.resolution,
    )
    t_part2 = time.time() - start

    start = time.time()
    part4_fasta.run_pipeline(
        original_fasta_file=paths["fasta"],
        final_ordering_file=files("chromorder.txt"),
        assembled_fasta_file=files("assembled.fasta"),
    )
    t_part4 = time.time() - start

    # chromosome group file stores per-chromosome scaffold rows
    got_groups = []
    for chrom in filebus.read_chroms_from_file(files("chromgroups.txt")):
        got_groups.append(sorted({row[1] for row in chrom}))
    want_groups = [sorted(g) for g in genome.true_groups().values()]
    groups_match = sorted(map(tuple, got_groups)) == sorted(map(tuple, want_groups))

    entries = fasta.read_fasta(files("assembled.fasta"))
    _emit(
        1,
        "end-to-end parts 1+2+4 (planted truth)",
        {
            "bins": genome.matrix.shape[0],
            "part1_s": round(t_part1, 2),
            "part2_s": round(t_part2, 2),
            "part4_s": round(t_part4, 2),
            "total_s": round(t_part1 + t_part2 + t_part4, 2),
            "groups_match_truth": bool(groups_match),
            "assembled_entries": len(entries),
        },
    )


# ---------------------------------------------------------------------------
# config 2 — part1 dense stages at 1.6 Gb scale (16K x 16K)
# ---------------------------------------------------------------------------


def config2(n: int = 16384) -> None:
    from hic_genome_assembler_tpu.ops import matrix as dev
    from hic_genome_assembler_tpu.parallel import mesh as pm

    rng = np.random.default_rng(0)
    # block-structured synthetic contact map (f32: n^2 * 4 bytes)
    m = rng.random((n, n), dtype=np.float32) * 0.01
    pos = np.arange(n, dtype=np.float32)
    m += 100.0 / (1.0 + np.abs(pos[:, None] - pos[None, :]))
    m = np.triu(m) + np.triu(m, 1).T

    devices = jax.devices()
    t_up = time.time()
    m_dev = jnp.asarray(m)
    jax.block_until_ready(m_dev)
    t_up = time.time() - t_up

    import functools

    def timed_chain(body, carry0, iters=16):
        """Per-kernel device time via a device-resident chain.

        Run the op inside one jitted fori_loop (each iteration's output
        feeds the next or an accumulated scalar, so nothing is elided or
        hoisted), pull ONE scalar back, and difference two chain lengths
        so dispatch and the single sync cancel.
        """

        @functools.partial(jax.jit, static_argnums=1)
        def chain(carry, k):
            out = jax.lax.fori_loop(0, k, body, carry)
            return jnp.asarray(jax.tree_util.tree_leaves(out)[-1]).ravel()[0]

        for k in (1, iters + 1):
            float(chain(carry0, k))  # compile both lengths
        best = None
        for _ in range(2):
            t1 = time.time()
            float(chain(carry0, 1))
            t1 = time.time() - t1
            tk = time.time()
            float(chain(carry0, iters + 1))
            tk = time.time() - tk
            d = (tk - t1) / iters
            best = d if best is None else min(best, d)
        return max(best, 1e-9)

    t_dist = timed_chain(lambda i, a: dev.to_distance(a), m_dev)
    dist = jax.jit(dev.to_distance)(m_dev)
    t_rank = timed_chain(
        lambda i, a: dev.rank_matrix_desc(a).astype(jnp.float32), dist
    )
    rank = jax.jit(dev.rank_matrix_desc)(dist)

    def counts_body(fn):
        # vary the WINDOW START with the loop index (not the 1 GiB rank
        # input, which would add an unfused 1 GiB materialization per
        # iteration) so XLA cannot hoist the count kernel or its iota
        # masks out of the chain
        def body(i, carry):
            r, acc = carry
            c = fn(r, jnp.int32(7) + (i & 1))
            return (r, acc + c[0].astype(jnp.float32))

        return body

    t_counts = timed_chain(
        counts_body(dev.growing_window_counts), (rank, jnp.float32(0.0))
    )
    gbps = (n * n * 4 * 2) / t_dist / 1e9

    metrics = {
        "n": n,
        "devices": len(devices),
        "host_to_device_s": round(t_up, 3),
        "distance_transform_ms": round(t_dist * 1e3, 2),
        "distance_effective_GBps": round(gbps, 1),
        "rank_matrix_ms": round(t_rank * 1e3, 2),
        "growing_window_counts_ms": round(t_counts * 1e3, 2),
        "growing_window_counts_GBps": round(n * n * 4 / t_counts / 1e9, 1),
    }
    if len(devices) > 1:
        mesh = pm.make_mesh()
        m_sh, _ = pm.put_matrix_padded(mesh, m)
        t_dist_sh = timed_chain(lambda i, a: dev.to_distance(a), m_sh)
        metrics["sharded_distance_ms"] = round(t_dist_sh * 1e3, 2)
        metrics["mesh_shape"] = dict(mesh.shape)
    _emit(2, "part1 dense stages @ 16K x 16K", metrics)


def config2_part1_e2e(n: int = 16384, n_chroms: int = 25) -> None:
    """Full part-1 algorithm chain at 1.6 Gb scale (no file ingestion):
    distance (host f64, exact mode) -> UPGMA (scipy C) -> leaf reorder
    -> similarity + rank matrix -> hypergeometric cut detection (device
    count scans) -> cut-noise filter.  Asserts the planted chromosome
    count is recovered."""
    from hic_genome_assembler_tpu.cluster import breakpoints, upgma
    from hic_genome_assembler_tpu.ops import oracle

    rng = np.random.default_rng(0)
    # planted block-diagonal genome: n_chroms chromosomes, power-law decay
    sizes = rng.dirichlet(np.ones(n_chroms) * 15.0) * n
    sizes = np.maximum(sizes.astype(int), 50)
    sizes[0] += n - sizes.sum()
    chrom_of = np.repeat(np.arange(n_chroms), sizes)
    pos = np.concatenate([np.arange(c) for c in sizes]).astype(np.float64)
    same = chrom_of[:, None] == chrom_of[None, :]
    dist = np.abs(pos[:, None] - pos[None, :])
    m = np.where(same, 100.0 / (1.0 + dist), 0.0)
    jitter = np.triu(rng.random((n, n)) * 0.3, 1)
    m = m + np.where(same, jitter + jitter.T, 0.0)
    np.fill_diagonal(m, 100.0)
    # NB: recovered-group counts here exercise the reference ALGORITHM's
    # behavior on synthetic statistics (boundary merges on the smallest
    # planted chromosomes are the algorithm's own doing); implementation
    # parity is pinned separately by the oracle tests.
    # shuffle rows so clustering has real work to do
    perm = rng.permutation(n)
    m = oracle.permute_symmetric(m, perm)
    row_sums = m.sum(axis=1)

    t0 = time.time()
    d = oracle.to_distance(m)
    t_dist = time.time() - t0
    # drop the raw matrix: the production pipeline rebinds adj at every
    # stage, so freed 2.1 GB blocks are REUSED warm by the next stage's
    # output (critical on lazily-faulted VM hosts — see utils/hostmem);
    # holding every stage's matrix live forces fresh page faults instead
    del m
    t0 = time.time()
    dendro = upgma.average_cluster_leaf_order(d, [str(i) for i in range(n)])
    t_upgma = time.time() - t0
    leaves = dendro["leaves"]
    t0 = time.time()
    d = oracle.permute_symmetric(d, leaves)
    t_perm = time.time() - t0
    t1 = time.time()
    sim = oracle.to_similarity(d, row_sums[leaves])
    t_sim = time.time() - t1
    t1 = time.time()
    rank = oracle.rank_matrix_desc(sim)
    t_argsort = time.time() - t1
    t_rank = time.time() - t0
    del sim  # lifetime note above

    # matrixMode=device variant of the same stage (f32 on-device
    # similarity + rank argsort; the production flag in config.py).
    # Transfer is timed separately: in a real run the matrix is already
    # device-resident from earlier stages.
    from hic_genome_assembler_tpu.ops import matrix as dev_ops

    d32 = d.astype(np.float32)
    rs32 = row_sums[leaves].astype(np.float32)
    t0 = time.time()
    d_dev = jax.device_put(d32)
    rs_dev = jax.device_put(rs32)
    jax.block_until_ready((d_dev, rs_dev))
    t_transfer = time.time() - t0

    def _dev_rank():
        sim_dev = dev_ops.to_similarity(d_dev, rs_dev)
        r = dev_ops.rank_matrix_desc(sim_dev)
        return int(np.asarray(r[0, 0]))  # consume

    _dev_rank()  # compile
    t0 = time.time()
    _dev_rank()
    t_rank_dev = time.time() - t0
    t0 = time.time()
    counts = breakpoints.RankCounts(rank)
    # warmup = the 1 GiB rank transfer + first kernel compile; in the
    # production device-mode pipeline the matrix is already resident
    # (RankCounts accepts the device rank array) and the executables are
    # warm, so it is reported separately from the steady-state scan
    counts.growing(0)
    counts._cache.clear()
    counts._pending.clear()
    t_cut_warm = time.time() - t0
    t0 = time.time()
    initial = breakpoints.pre_process_all_matrix_breakpoints(
        counts, min_size=5, min_frac=0.02, psig=0.05
    )
    t_pre = time.time() - t0
    t0 = time.time()
    filtered = breakpoints.filter_noisy_breakpoints(counts, initial, psig=0.05)
    t_filt = time.time() - t0
    t_cuts = t_pre + t_filt
    _emit(
        2,
        "part1 e2e chain @ 16K x 16K (25 planted chromosomes)",
        {
            "n": n,
            "planted_chromosomes": n_chroms,
            "distance_f64_host_s": round(t_dist, 2),
            "upgma_s": round(t_upgma, 2),
            "similarity_plus_rank_s": round(t_rank, 2),
            "rank_split_permute_s": round(t_perm, 2),
            "rank_split_similarity_s": round(t_sim, 2),
            "rank_split_argsort_s": round(t_argsort, 2),
            "similarity_plus_rank_device_s": round(t_rank_dev, 2),
            "device_transfer_s": round(t_transfer, 2),
            "cut_warmup_transfer_compile_s": round(t_cut_warm, 2),
            "cut_preprocess_s": round(t_pre, 2),
            "cut_filter_s": round(t_filt, 2),
            "cut_detection_s": round(t_cuts, 2),
            "total_s": round(t_dist + t_upgma + t_rank + t_cuts, 2),
            "initial_cuts": len(initial),
            "filtered_cuts": len(filtered),
            "groups_found": len(filtered) + 1,
        },
    )


# ---------------------------------------------------------------------------
# config 3 — part2 DP permutation scoring
# ---------------------------------------------------------------------------


def config3() -> None:
    from hic_genome_assembler_tpu.ops import cost, perms
    from hic_genome_assembler_tpu.parallel import mesh as pm

    sizes = [512, 384, 320, 256, 224, 160, 128, 64]
    C = sum(sizes)
    rng = np.random.default_rng(0)
    pos = np.arange(C)
    m = 100.0 / (1.0 + np.abs(pos[:, None] - pos[None, :]))
    m += rng.random((C, C)) * 0.01
    m = np.triu(m) + np.triu(m, 1).T
    orders = perms.order_batch(len(sizes))
    orients = perms.orient_batch(len(sizes))
    n_cand = len(orders) * len(orients)

    m_dev = jnp.asarray(m.astype(np.float32))
    jax.block_until_ready(m_dev)
    scorer = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev)
    scorer.score_batch_topk(orders, orients)
    start = time.time()
    scorer = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev)
    idx, vals, _floor = scorer.score_batch_topk(orders, orients)
    wall = time.time() - start

    from hic_genome_assembler_tpu.utils import profiling

    gathers = profiling.block_scorer_gather_count(n_cand, len(sizes))
    metrics = {
        "candidates": n_cand,
        "single_device_wall_s": round(wall, 3),
        "single_device_evals_per_s": round(n_cand / wall, 0),
        "single_device_Mgathers_per_s": round(gathers / wall / 1e6, 1),
    }
    if len(jax.devices()) > 1:
        mesh = pm.make_mesh()
        sc = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev, mesh=mesh)
        sc.score_batch_topk(orders, orients)
        start = time.time()
        sc = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev, mesh=mesh)
        idx2, _, _floor2 = sc.score_batch_topk(orders, orients)
        wall_dp = time.time() - start
        metrics["dp_mesh_wall_s"] = round(wall_dp, 3)
        metrics["dp_mesh_evals_per_s"] = round(n_cand / wall_dp, 0)
        metrics["dp_matches_single"] = bool(
            set(np.asarray(idx).tolist()) & set(np.asarray(idx2).tolist())
        )
    _emit(3, "part2 DP brute-force scoring (S=8, 5.16M candidates)", metrics)


def config3_part2_e2e(n_chroms: int = 25, scaffolds_per_chrom: int = 30) -> None:
    """Part 2 at genome scale: ~16K bins, 25 chromosomes x ~30 scaffolds
    each, planted order/orientation truth.  Exercises the device-resident
    genome matrix, per-chromosome table builds, greedy insertion and the
    speculative sliding-window refinement; reports ordering accuracy
    (a chromosome counts as recovered if the scaffold sequence equals
    the planted order or its reversal — the cost is reversal-symmetric)."""
    from hic_genome_assembler_tpu.io import hicpro
    from hic_genome_assembler_tpu.models import part2_order
    from hic_genome_assembler_tpu.utils import fixtures

    rng = np.random.default_rng(3)
    layout = []
    for _ in range(n_chroms):
        sizes = np.maximum(
            (rng.pareto(2.0, scaffolds_per_chrom) * 12 + 2).astype(int), 1
        )
        layout.append(tuple(int(s) for s in sizes))
    genome = fixtures.make_genome(
        chrom_scaffold_bins=tuple(layout), seed=3, noise=0.003, cross_noise_frac=0.0
    )
    bins = [
        hicpro.Bin(bid, s.name, 0, 0, 1.0, 0.0)
        for s in genome.scaffolds
        for bid in s.bin_ids
    ]
    chrom_list = []
    for c in sorted(genome.true_groups()):
        group = []
        for name in genome.true_groups()[c]:
            s = genome.scaffold(name)
            group.extend([bid, name] for bid in s.bin_ids)
        chrom_list.append(group)

    from hic_genome_assembler_tpu.utils import profiling

    profiling.reset()
    start = time.time()
    order = part2_order.order_genome(
        genome.matrix, chrom_list, bins, genome.resolution,
        n_scaffolds=6, scan_scaffolds=5, plot_chrom=False,
    )
    wall = time.time() - start
    profiling.print_summary()

    recovered = 0
    for c, group in enumerate(order):
        got = [s.name for s in group]
        want = [name for name, _o in genome.true_order(c)]
        if got == want or got == want[::-1]:
            recovered += 1
    n_scaff = sum(len(g) for g in layout)
    _emit(
        3,
        "part2 e2e @ genome scale (25 chroms x ~30 scaffolds)",
        {
            "bins": genome.n_bins,
            "chromosomes": n_chroms,
            "scaffolds": n_scaff,
            "wall_s": round(wall, 2),
            "scaffolds_per_s": round(n_scaff / wall, 2),
            "chromosomes_recovered": recovered,
        },
    )


# ---------------------------------------------------------------------------
# north star — ONE full-pipeline run at 16K (part1 -> part2 -> part3 -> part4)
# ---------------------------------------------------------------------------


def config_e2e_16k(workdir: str = "/tmp/hic_bench_e2e16k") -> None:
    """The BASELINE.md north-star artifact as a SINGLE run (VERDICT r4
    next #1): the real run_pipeline chain part1 -> part2 -> part3 ->
    part4 (the reference's full ``-part1 -part2 -part3 -part4``
    composition, run_hicAssembler.py:273-299) on the same ~17K-bin
    planted fixture the part-2 16K benchmark uses (25 chromosomes x 52
    pareto-sized scaffolds), through HiC-Pro files on disk and the file
    bus, ending in an emitted FASTA.  Records total wall + per-part
    split + planted-truth checks (groups, per-chromosome orders up to
    reversal, FASTA assembly stats)."""
    from hic_genome_assembler_tpu.models import (
        part1_cluster,
        part2_order,
        part3_orient,
        part4_fasta,
    )
    from hic_genome_assembler_tpu.utils import fixtures

    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    genome = fixtures.e2e_16k_genome(seed=3)
    paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    t_fixture = time.time() - t0
    files = lambda n: os.path.join(workdir, n)  # noqa: E731

    start_all = time.time()
    start = time.time()
    part1_cluster.run_pipeline(
        hic_pro_bed_file=paths["bed"],
        hic_pro_bias_file=paths["bias"],
        hic_pro_matrix_file=paths["matrix"],
        hic_pro_scaff_size_file=paths["sizes"],
        dendrogram_order_file=files("dendro.txt"),
        avg_cluster_plot="",
        avg_cluster_plot_outlined="",
        bin_group_file=files("bingroups.txt"),
        assessment_file=files("assessment.txt"),
        chromosome_group_file=files("chromgroups.txt"),
        hyper_geom=True,
        hmm=False,
        # min_size=15: the reference's config docs recommend 5-15 for
        # Hi-C data (hicAssembler_config.txt:57).  Measured on this
        # fixture: min_size=5 overcuts (30 groups/25), >=50 merges
        # chromosomes (12 groups at half scale), and the Louvain tail
        # (modularity=.05) splits the tail chromosome into communities
        # (28 groups) — 15 recovers 24/25 planted chromosomes exactly,
        # with only the LAST chromosome in dendrogram order split into
        # contiguous internally-ordered segments (the growing-window
        # scan's window-decay behavior at the matrix end; the reference
        # algorithm behaves identically by construction — golden parity
        # tests pin the implementation).
        min_size=15,
        modularity=0,
        louvain_rounds=3,
        psig=0.05,
        convergence_rounds=10,
        look_ahead=0.5,
        resolution=genome.resolution,
        louvain_seed=0,
    )
    t_part1 = time.time() - start

    start = time.time()
    part2_order.run_pipeline(
        hic_pro_bed_file=paths["bed"],
        hic_pro_bias_file=paths["bias"],
        hic_pro_matrix_file=paths["matrix"],
        chromosome_group_file=files("chromgroups.txt"),
        chromosome_order_file=files("chromorder.txt"),
        save_plots_directory="",
        chromosome_plot_suffix="",
        full_genome_plot="",
        full_genome_plot_title="",
        plot_order_file=files("plotorder.txt"),
        n_scaffolds=6,
        scan_scaffolds=5,
        resolution=genome.resolution,
    )
    t_part2 = time.time() - start

    start = time.time()
    part3_orient.run_pipeline(
        chromosome_order_file=files("chromorder.txt"),
        scaff_size_file=paths["sizes"],
        restriction_site_file=paths["restriction"],
        valid_pair_file=paths["validpairs"],
        final_ordering_file=files("final_order.txt"),
        length_cutoff=genome.resolution,
        resolution=genome.resolution,
    )
    t_part3 = time.time() - start

    start = time.time()
    part4_fasta.run_pipeline(
        original_fasta_file=paths["fasta"],
        final_ordering_file=files("final_order.txt"),
        assembled_fasta_file=files("assembled.fasta"),
    )
    t_part4 = time.time() - start
    t_total = time.time() - start_all

    checks = fixtures.check_assembly(
        genome, files("chromgroups.txt"), files("final_order.txt"),
        files("assembled.fasta"),
    )

    _emit(
        7,
        "FULL pipeline part1->part2->part3->part4 @ 16K (north star, one run)",
        {
            "bins": genome.n_bins,
            "scaffolds": len(genome.scaffolds),
            "fixture_prep_s": round(t_fixture, 2),
            "part1_s": round(t_part1, 2),
            "part2_s": round(t_part2, 2),
            "part3_s": round(t_part3, 2),
            "part4_s": round(t_part4, 2),
            "total_s": round(t_total, 2),
            **checks,
        },
    )


# ---------------------------------------------------------------------------
# config 4 — part3 validPairs streaming
# ---------------------------------------------------------------------------


def config4(n_pairs: int = 2_000_000, workdir: str = "/tmp/hic_bench_c4") -> None:
    from hic_genome_assembler_tpu.io import native
    from hic_genome_assembler_tpu.models import part3_orient

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "valid.pairs")
    rng = np.random.default_rng(0)
    scaffs = [f"scaf_{i}" for i in range(40)]
    if not os.path.exists(path):
        with open(path, "w") as fh:
            s1 = rng.integers(0, len(scaffs), n_pairs)
            s2 = rng.integers(0, len(scaffs), n_pairs)
            p1 = rng.integers(1, 500_000, n_pairs)
            p2 = rng.integers(1, 500_000, n_pairs)
            for i in range(n_pairs):
                fh.write(
                    f"r{i}\t{scaffs[s1[i]]}\t{p1[i]}\t+\t{scaffs[s2[i]]}\t{p2[i]}\t-\tx\n"
                )
    keys = {
        ("scaf_1", "scaf_2"): [],
        ("scaf_2", "scaf_1"): [],
        ("scaf_3", "scaf_4"): [],
    }

    native_ok = native.available()
    start = time.time()
    kept = part3_orient.read_valid_pair_file(path, keys)
    wall = time.time() - start

    # threading-scaling evidence for the native scanner (r5: the scanner
    # applies coo_parser's newline-sliced threaded design; ~9.5M lines/s
    # in r4 single-threaded-buffered form)
    scan_scaling = {}
    if native_ok:
        for th in (1, os.cpu_count() or 1):
            os.environ["HIC_SCAN_THREADS"] = str(th)
            k2 = {k: [] for k in keys}
            t0 = time.time()
            native.scan_validpairs(path, k2)
            dt = time.time() - t0
            scan_scaling[f"native_Mlines_per_s_t{th}"] = round(
                n_pairs / dt / 1e6, 1
            )
        os.environ.pop("HIC_SCAN_THREADS", None)
        assert k2 == kept, "threaded scan diverged from first scan"

    # COO matrix ingestion: native multithreaded parser vs pandas C parser
    coo_path = os.path.join(workdir, "ingest.matrix")
    n_trip = 8_000_000
    if not os.path.exists(coo_path):
        i1 = rng.integers(0, 16384, n_trip)
        i2 = rng.integers(0, 16384, n_trip)
        vv = rng.random(n_trip) * 100
        with open(coo_path, "w") as fh:
            for a, b, v in zip(i1, i2, vv):
                fh.write(f"{a}\t{b}\t{v:.8f}\n")
    with open(coo_path, "rb") as fh:  # warm the page cache for BOTH parsers
        while fh.read(1 << 24):
            pass
    coo_metrics = {}
    if native_ok:
        start = time.time()
        arr = native.parse_coo(coo_path)
        t_native = time.time() - start
        coo_metrics["coo_native_Mlines_per_s"] = round(n_trip / t_native / 1e6, 1)
        del arr
    try:
        import pandas as pd

        start = time.time()
        pd.read_csv(coo_path, sep="\t", header=None, dtype=np.float64, engine="c")
        t_pd = time.time() - start
        coo_metrics["coo_pandas_Mlines_per_s"] = round(n_trip / t_pd / 1e6, 1)
    except ImportError:
        pass

    _emit(
        4,
        "part3 validPairs streaming + COO ingestion",
        {
            "lines": n_pairs,
            "native_scanner": bool(native_ok),
            "wall_s": round(wall, 3),
            "lines_per_s": round(n_pairs / wall, 0),
            "kept_pairs": sum(len(v) for v in kept.values()),
            **scan_scaling,
            **coo_metrics,
        },
    )


# ---------------------------------------------------------------------------
# config 5 — multi-resolution sweep, replicated vs sharded, FASTA equality
# ---------------------------------------------------------------------------


def config5(workdir: str = "/tmp/hic_bench_c5") -> None:
    from hic_genome_assembler_tpu.io import hicpro, filebus, fasta
    from hic_genome_assembler_tpu.models import part2_order, part4_fasta
    from hic_genome_assembler_tpu.parallel import mesh as pm
    from hic_genome_assembler_tpu.utils import fixtures

    results = {}
    meshes = [("replicated", None)]
    if len(jax.devices()) > 1:
        meshes.append(("sharded", pm.make_mesh()))
    for resolution in (100_000, 250_000, 500_000):
        genome = fixtures.make_genome(
            chrom_scaffold_bins=((12, 10, 7, 5), (11, 9, 6)),
            seed=5,
            noise=0.004,
            resolution=resolution,
        )
        sub = os.path.join(workdir, str(resolution))
        os.makedirs(sub, exist_ok=True)
        paths = fixtures.write_hicpro_files(genome, os.path.join(sub, "hicpro"))
        fasta_in = paths["fasta"]
        # planted-truth groups play the part1 role so the sweep isolates
        # part2+4
        group_file = os.path.join(sub, "groups.txt")
        bin_list = hicpro.initiate_loci(paths["bed"], paths["bias"])
        by_name = {}
        for b in bin_list:
            by_name.setdefault(b.chrom, []).append(b)
        cuts, flat = [], []
        for names in genome.true_groups().values():
            for nm in names:
                flat.extend(by_name[nm])
            cuts.append(len(flat))
        filebus.write_bin_groupings(cuts[:-1], flat, group_file)

        outputs = {}
        for tag, mesh in meshes:
            order_file = os.path.join(sub, f"order_{tag}.txt")
            start = time.time()
            part2_order.run_pipeline(
                hic_pro_bed_file=paths["bed"],
                hic_pro_bias_file=paths["bias"],
                hic_pro_matrix_file=paths["matrix"],
                chromosome_group_file=group_file,
                chromosome_order_file=order_file,
                save_plots_directory="",
                chromosome_plot_suffix="",
                full_genome_plot="",
                full_genome_plot_title="",
                plot_order_file=os.path.join(sub, f"plot_{tag}.txt"),
                n_scaffolds=4,
                scan_scaffolds=3,
                resolution=resolution,
                mesh=mesh,
            )
            wall = time.time() - start
            out_fasta = os.path.join(sub, f"assembled_{tag}.fasta")
            part4_fasta.run_pipeline(
                original_fasta_file=fasta_in,
                final_ordering_file=order_file,
                assembled_fasta_file=out_fasta,
            )
            outputs[tag] = out_fasta
            results[f"{resolution // 1000}kb_{tag}_part2_s"] = round(wall, 2)
        if len(outputs) == 2:
            a = open(outputs["replicated"], "rb").read()
            b = open(outputs["sharded"], "rb").read()
            results[f"{resolution // 1000}kb_fasta_equal"] = a == b
    _emit(5, "multi-resolution sweep (part2+4, replicated vs sharded)", results)


def config_hmm_scale(n: int = 4096, n_chroms: int = 12) -> None:
    """HMM-branch cut detection at scale: the part-1 ``hmm=True`` path
    (identifyChromosomeGroupsHMM, scaffoldToChromosomes.py:868-942) on a
    planted block fixture — iterative 2-state Gaussian HMM fits as
    single-dispatch lax.while_loop EM (ops/gaussian_hmm.py).  Input
    mirrors the pipeline's hmm branch exactly: distance -> similarity ->
    log10(+1) host-f64 transforms on the planted-order matrix."""
    from hic_genome_assembler_tpu.cluster import hmm_cuts
    from hic_genome_assembler_tpu.io import hicpro
    from hic_genome_assembler_tpu.ops import oracle
    from hic_genome_assembler_tpu.utils import fixtures

    genome = fixtures.hmm_scale_genome(n, n_chroms, seed=7)
    m = genome.matrix.astype(np.float64)
    row_sums = m.sum(axis=1)
    bins = [
        hicpro.Bin(bid, s.name, 0, 0, 1.0, float(row_sums[bid]))
        for s in genome.scaffolds
        for bid in s.bin_ids
    ]
    t0 = time.time()
    adj = oracle.to_distance(m)
    adj = oracle.to_similarity(adj, row_sums)
    adj = oracle.log_transform(adj, log_base=10, plus_one=True)
    t_prep = time.time() - t0
    t0 = time.time()
    cuts = hmm_cuts.identify_chromosome_groups_hmm(
        adj, bins, min_size=5, modularity=0.05, convergence_rounds=5,
        look_ahead=0.2, louvain_rounds=2,
    )
    t_hmm = time.time() - t0
    chrom_bins = [
        sum(s.n_bins for s in genome.scaffolds if s.chrom == c) for c in range(n_chroms)
    ]
    true_bounds = np.cumsum(chrom_bins)[:-1]
    matched = sum(
        1 for b in true_bounds if any(abs(b - c) <= 5 for c in cuts)
    )
    _emit(
        6,
        "part1 HMM-branch cut detection at scale",
        {
            "n": genome.n_bins,
            "planted_chromosomes": n_chroms,
            "transform_prep_s": round(t_prep, 2),
            "hmm_detection_s": round(t_hmm, 2),
            "cuts_found": len(cuts),
            "planted_boundaries_matched_pm5": int(matched),
        },
    )


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def main() -> None:
    from hic_genome_assembler_tpu.utils import hostmem

    runtime.enable_compile_cache()
    hostmem.tune()  # warm-page reuse for the multi-GB host matrices
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--small", action="store_true", help="shrink config 2 to 4K")
    ap.add_argument(
        "--part1-e2e",
        action="store_true",
        help="run the full part-1 chain at 16K (config 2 variant)",
    )
    ap.add_argument(
        "--part2-e2e",
        action="store_true",
        help="run part 2 at genome scale (config 3 variant)",
    )
    ap.add_argument(
        "--part2-16k",
        action="store_true",
        help="part 2 at the 16K north-star scale (~16K bins)",
    )
    ap.add_argument(
        "--e2e-16k", action="store_true",
        help="ONE full-pipeline part1->2->3->4 run at ~17K bins (north star)",
    )
    ap.add_argument(
        "--hmm-scale",
        type=int,
        nargs="?",
        const=4096,
        default=None,
        help="part-1 HMM-branch cut detection at N bins (default 4096)",
    )
    args = ap.parse_args()
    if args.e2e_16k:
        config_e2e_16k()
        return
    if args.hmm_scale:
        config_hmm_scale(n=args.hmm_scale)
        return
    if args.part1_e2e:
        config2_part1_e2e(n=4096 if args.small else 16384)
        return
    if args.part2_16k:
        config3_part2_e2e(n_chroms=25, scaffolds_per_chrom=52)
        return
    if args.part2_e2e:
        config3_part2_e2e(n_chroms=6 if args.small else 25)
        return
    todo = sorted(CONFIGS) if args.all or args.config is None else [args.config]
    for c in todo:
        if c == 2 and args.small:
            config2(n=4096)
        else:
            CONFIGS[c]()


if __name__ == "__main__":
    main()
