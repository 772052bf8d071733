"""Part 1 — cluster contact-map rows into chromosome groups.

Flow (scaffoldToChromosomes.runPipeline, :1104-1174):

1. ingest bed/bias/matrix, prune zero rows;
2. distance transform -> UPGMA -> dendrogram leaf order (persisted to the
   file bus, then re-read: the reference's resume semantics);
3. cut detection: hypergeometric scan (default; device count kernels +
   exact scipy sf) or iterative 2-state Gaussian HMMs;
4. Louvain modularity for the remaining tail, reordering the matrix;
5. write bin groups; majority-vote scaffold assignment; rename groups
   Chr_1..N by descending bp size.

Precision: decision-critical transforms (distance, similarity, rank
matrix) run on host in float64 with reference-identical tie behavior
("exact" mode); the O(N^2) count scans run on device either way.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from hic_genome_assembler_tpu.cluster import breakpoints, louvain, upgma
from hic_genome_assembler_tpu.io import filebus, hicpro
from hic_genome_assembler_tpu.ops import oracle
from hic_genome_assembler_tpu.utils import profiling


# ---------------------------------------------------------------------------
# Louvain tail resolution
# ---------------------------------------------------------------------------

def modularity_remaining_data(
    adj: np.ndarray,
    bin_list: List[hicpro.Bin],
    cut_indices: List[int],
    n_rounds: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, List[hicpro.Bin], List[int]]:
    """Partition the matrix tail past the last cut via Louvain; reorder
    the tail rows by community (large->small) and extend the cut list
    (modularity_remaining_data, scaffoldToChromosomes.py:263-349)."""
    start_time = time.time()
    if len(cut_indices) == 0:
        print(
            "- Attempting to resolve groupings by modularity alone... This "
            "could take a while if matrix size is large and n_rounds is set "
            "high as well..."
        )
        cut_indices = [0]
    cut_indices = sorted(cut_indices)
    start = cut_indices[-1]
    adj = np.asarray(adj)
    tail = adj[start:, start:]

    print("- Maximizing so-called modularity...")
    print(
        "- Graph created with {} nodes, and {} edges".format(
            tail.shape[0], tail.shape[0] * (tail.shape[0] + 1) // 2
        )
    )
    print("- Performing {} rounds of the louvain method...".format(n_rounds))
    partition, _score = louvain.modularity_rounds(tail, louvain_rounds=n_rounds, seed=seed)

    group_sizes = Counter(partition[i] for i in range(tail.shape[0]))
    group_count = len(group_sizes)
    remaining_groups = [
        k for k, _v in sorted(group_sizes.items(), key=lambda kv: kv[1], reverse=True)
    ]

    remaining_order: List[int] = []
    for rg in remaining_groups:
        remaining_order.extend(
            start + i for i in range(tail.shape[0]) if partition[i] == rg
        )
        cut_indices.append(cut_indices[-1] + group_sizes[rg])

    new_order = list(range(start)) + remaining_order
    adj = oracle.permute_symmetric(adj, new_order)
    bin_list = [bin_list[i] for i in new_order]

    if cut_indices[0] == 0:
        cut_indices.pop(0)
    if cut_indices and cut_indices[-1] == len(adj):
        cut_indices.pop(-1)

    total_groups = len(cut_indices) + 1
    print("- Modularity maximization total time = " + str(time.time() - start_time))
    print(
        "- Chromosomes found via HMMs or Hyper geometrics = {}".format(
            total_groups - group_count
        )
    )
    print("- Chromosomes found via modularity maximization = " + str(group_count))
    print("- Total chromosomes found {}".format(total_groups))
    return adj, bin_list, cut_indices


# ---------------------------------------------------------------------------
# Scaffold -> chromosome assignment
# ---------------------------------------------------------------------------

def assess_cluster_list(
    c_lines: Sequence[str],
    scaffold_bins: Dict[str, List[Tuple[int, str]]],
    out,
    percent_to_assign: float = 51.0,
) -> Tuple[List[Tuple[int, str]], int, int]:
    """Assign scaffolds to one chromosome group by majority vote
    (assessClusterList, scaffoldToChromosomes.py:1001-1036)."""
    in_group: Dict[str, List[int]] = {}
    for line in c_lines:
        cols = line.split("\t")
        bin_id, scaff = int(cols[0]), cols[1]
        in_group.setdefault(scaff, []).append(bin_id)
    final: List[Tuple[int, str]] = []
    false_positives = 0
    assigned = 0
    out.write("#Scaffold\tNodesAssigend\tTotalNodes\tAssigned%\n")
    for scaff, nodes in in_group.items():
        nodes_assigned, total_nodes = len(nodes), len(scaffold_bins[scaff])
        pct = round((float(nodes_assigned) / float(total_nodes)) * 100.0, 2)
        out.write(f"{scaff}\t{nodes_assigned}\t{total_nodes}\t{pct}%\n")
        if pct >= percent_to_assign:
            final += scaffold_bins[scaff]
            assigned += 1
        else:
            false_positives += nodes_assigned
    out.write("Total scaffolds clustered to chromosome " + str(len(in_group)) + "\n")
    out.write("Total scaffolds assigned to chromosome " + str(assigned) + "\n")
    return final, false_positives, assigned


def assess_chromosome_clustering(
    chrom_list: List[List[str]],
    stats_file: str,
    percent_to_assign: float = 51.0,
) -> List[List[Tuple[int, str]]]:
    """All groups + stats file (assessChromosomeClustering,
    scaffoldToChromosomes.py:1038-1077)."""
    scaffold_bins: Dict[str, List[Tuple[int, str]]] = {}
    all_lines = [line for group in chrom_list for line in group]
    for line in all_lines:
        cols = line.split("\t")
        bin_id, scaff = int(cols[0]), cols[1]
        scaffold_bins.setdefault(scaff, []).append((bin_id, scaff))
    for scaff in scaffold_bins:
        scaffold_bins[scaff].sort(key=lambda pair: pair[0])

    final_groups: List[List[Tuple[int, str]]] = []
    false_positives = 0
    total_assigned = 0
    with open(stats_file, "w") as out:
        for i, group in enumerate(chrom_list):
            out.write("### Chromosome" + str(i + 1) + " ###\n")
            nodes, fp, assigned = assess_cluster_list(
                group, scaffold_bins, out, percent_to_assign
            )
            if len(nodes) > 0:
                final_groups.append(nodes)
            false_positives += fp
            total_assigned += assigned
            out.write("####################\n")
        total_nodes = len(all_lines)
        out.write("Total Nodes " + str(total_nodes) + "\n")
        out.write("Properly clustered nodes " + str(total_nodes - false_positives) + "\n")
        out.write("Falsely clustered nodes " + str(false_positives) + "\n")
        out.write("Total scaffolds assigned to chromosomes " + str(total_assigned) + "\n")
        out.write(
            "Error rate ~"
            + str(round((float(false_positives) / float(total_nodes)) * 100.0, 2))
            + "%\n"
        )
    return final_groups


# ---------------------------------------------------------------------------
# Part 1 driver
# ---------------------------------------------------------------------------

def run_pipeline(
    hic_pro_bed_file: str,
    hic_pro_bias_file: str,
    hic_pro_matrix_file: str,
    hic_pro_scaff_size_file: str,
    dendrogram_order_file: str,
    avg_cluster_plot: str,
    avg_cluster_plot_outlined: str,
    bin_group_file: str,
    assessment_file: str,
    chromosome_group_file: str,
    hyper_geom: bool,
    hmm: bool,
    min_size: int,
    modularity: float,
    louvain_rounds: int,
    psig: float,
    convergence_rounds: int,
    look_ahead,
    resolution: int,
    louvain_seed: int = 0,
    mesh=None,
    matrix_mode: str = "exact",
    hmm_mode: str = "fast",
) -> None:
    """``mesh``: optional jax.sharding.Mesh — the rank-count kernels then
    run 2-D sharded over it (integer counts: bit-identical to local).

    ``matrix_mode``:
      exact  (default) similarity/rank/log transforms on host in f64
             with reference-identical tie behavior — the parity mode;
      device the expensive O(N^2 log N) rank ARGSORT runs on device
             (plus the count kernels, as always); the similarity and
             log transforms stay host f64 — they are cheap elementwise
             passes, and computing similarity in f32 from the f32-cast
             distance matrix was catastrophic cancellation
             (sim = rs·(2−d) with d ≈ 2: the cast alone quantizes
             small contacts to ulp(2) ≈ 2.4e-7 — caught by
             benchmarks/device_mode_parity.py).  NOT a parity mode:
             the device sorts the f32 cast of the f64 similarities
             with a deterministic tie rule (stable ascending argsort,
             reversed — the reference's construction), but the
             reference's actual tie ORDER comes from numpy's unstable
             introsort, a per-numpy-build artifact no device sort can
             reproduce, and window membership counts consume that
             order wherever an equal-value group (every zero contact,
             duplicated values) straddles a window prefix (measure the
             divergence by scale with benchmarks/device_mode_parity.py).
             ``exact`` reproduces the
             reference bit-for-bit (same numpy argsort) and is the
             accelerated default (native fused transforms +
             thread-parallel rank build), so device mode is only for
             deployments that explicitly trade reference parity for
             device-resident ranking.

    ``hmm_mode`` (hmm=True branch only):
      fast   (default) shape-bucketed masked EM, fit+Viterbi fused into
             one dispatch per HMM round (ops/gaussian_hmm.py) — kills
             the per-shape recompile/sync storm at scale;
      exact  the unpadded rounds-2-4 EM path (per-shape executables) for
             bit-continuity with earlier recorded outputs.
    """
    print("########################################")
    print("### Working on Part1 of the pipeline ###")
    total_start = time.time()

    # --- ingest + cluster ---------------------------------------------------
    start = time.time()
    with profiling.timer("part1/ingest"):
        bin_list = hicpro.initiate_loci(hic_pro_bed_file, hic_pro_bias_file)
        adj = hicpro.build_adjacency_matrix(hic_pro_matrix_file, bin_list)
        adj, bin_list = hicpro.remove_zero_rows(adj, bin_list)
    with profiling.timer("part1/distance_transform"):
        adj = oracle.to_distance(adj)
    labels = [b.chrom + "_" + str(b.ID) for b in bin_list]
    with profiling.timer("part1/upgma"):
        dendro = upgma.average_cluster_leaf_order(adj, labels)
    filebus.write_dendrogram_leaf_order(dendro["ivl"], dendro["leaves"], dendrogram_order_file)
    dendro = filebus.read_dendrogram_leaf_order(dendrogram_order_file)
    leaves = dendro["leaves"]
    adj = oracle.permute_symmetric(adj, leaves)
    bin_list = [bin_list[i] for i in leaves]
    if avg_cluster_plot:
        from hic_genome_assembler_tpu.viz import plot as plot_mod

        plot_mod.plot_contact_map(adj, resolution=resolution, save_plot=avg_cluster_plot)
    print("Total run-time to cluster and plot = " + str(time.time() - start))

    # --- cut detection ------------------------------------------------------
    start = time.time()
    row_sums = np.asarray([b.rowSum for b in bin_list])
    cut_timer = profiling.timer(
        "part1/cut_detection_hmm" if hmm else "part1/cut_detection_hypergeom"
    )
    cut_timer.__enter__()
    if hyper_geom:
        if matrix_mode == "device":
            import jax.numpy as jnp

            from hic_genome_assembler_tpu.ops import matrix as dev

            n_bins = adj.shape[0]
            # host f64 similarity (cheap elementwise; f32 arithmetic
            # here would cancel catastrophically — see docstring), then
            # the order-preserving f32 cast feeds the device argsort
            adj = oracle.to_similarity(adj, row_sums)
            sim32 = adj.astype(np.float32)
            if mesh is not None:
                # TP: row blocks over every device — the argsort is
                # per-row independent, so XLA runs it collective-free
                # with all chips busy (replacing the reference's
                # serial rank build, scaffoldToChromosomes.py:1132)
                from hic_genome_assembler_tpu.parallel import mesh as pm

                sim_d, _ = pm.put_rows_padded(mesh, sim32)
            else:
                sim_d = jnp.asarray(sim32)
            rank_mat = dev.rank_matrix_desc(sim_d)[:n_bins, :n_bins]
            counts = breakpoints.RankCounts(rank_mat, mesh=mesh)
        else:
            adj = oracle.to_similarity(adj, row_sums)
            rank_mat = oracle.rank_matrix_desc(adj)
            counts = breakpoints.RankCounts(rank_mat, mesh=mesh)
        initial = breakpoints.pre_process_all_matrix_breakpoints(
            counts, min_size=min_size, min_frac=modularity, psig=psig
        )
        cut_indices = breakpoints.filter_noisy_breakpoints(counts, initial, psig=psig)
        # host f64 log either way: bit-equal Louvain-tail input in both
        # modes (the log is an elementwise pass, not worth a round trip)
        adj = oracle.log_transform(adj, log_base=10, plus_one=True)
    elif hmm:
        from hic_genome_assembler_tpu.cluster import hmm_cuts

        adj = oracle.to_similarity(adj, row_sums)
        adj = oracle.log_transform(adj, log_base=10, plus_one=True)
        cut_indices = hmm_cuts.identify_chromosome_groups_hmm(
            adj,
            bin_list,
            min_size=min_size,
            modularity=modularity,
            convergence_rounds=convergence_rounds,
            look_ahead=look_ahead,
            louvain_rounds=louvain_rounds,
            hmm_mode=hmm_mode,
        )
    else:
        cut_indices = []
    cut_timer.__exit__(None, None, None)

    # --- modularity tail ----------------------------------------------------
    if modularity and modularity > 0.0:
        with profiling.timer("part1/louvain_tail"):
            adj, bin_list, cut_indices = modularity_remaining_data(
                adj, bin_list, cut_indices, n_rounds=louvain_rounds, seed=louvain_seed
            )

    # --- persist + plot -----------------------------------------------------
    adj_plot = oracle.to_distance(
        oracle.log_transform(adj, log_base=10, reverse=True, plus_one=True)
    )
    if avg_cluster_plot_outlined:
        from hic_genome_assembler_tpu.viz import plot as plot_mod

        plot_mod.plot_contact_map(
            adj_plot,
            resolution=resolution,
            highlight_chroms=cut_indices,
            save_plot=avg_cluster_plot_outlined,
        )
    filebus.write_bin_groupings(cut_indices, bin_list, bin_group_file)
    print(
        "Total run-time to identify chromosome boundaries = "
        + str(time.time() - start)
    )

    # --- scaffold assignment ------------------------------------------------
    start = time.time()
    with profiling.timer("part1/scaffold_assignment"):
        size_dict = hicpro.read_size_file_to_dict(hic_pro_scaff_size_file)
        bin_groups = filebus.read_bin_groupings(bin_group_file)
        chrom_groups = assess_chromosome_clustering(bin_groups, assessment_file)
        filebus.write_chromosome_groupings(chrom_groups, size_dict, chromosome_group_file)
    print(
        "Total run-time to assign scaffolds to chromosomes = "
        + str(time.time() - start)
    )
    print("Total run-time of Part1 = " + str(time.time() - total_start))
    profiling.print_summary()
    print("CutIndices = " + str(cut_indices))
    print("- Part 1 (grouping bins to groups) completed successfully")
