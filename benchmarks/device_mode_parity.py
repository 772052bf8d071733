"""matrixMode=device parity evidence at scale (VERDICT r3 item 4).

Runs the FRAMEWORK part 1 twice on identical side-by-side fixtures —
``matrix_mode="exact"`` (host f64, byte-equal to the reference at every
directly-comparable scale: benchmarks/ref_sidebyside.py) vs
``matrix_mode="device"`` (the O(N^2 log N) rank ARGSORT on device in
f32 — the similarity and log transforms stay host f64; see the
matrix_mode table in models/part1_cluster.py) — and byte-compares the
four part-1 file-bus outputs.
Exact mode is the proven-reference-equal anchor, so device==exact here
transitively means device==reference.

Where outputs differ the harness localizes the divergence: which files,
how many differing lines, and the two cut-index sets.  It also counts
the f32 rank-tie exposure per scale — rows of the f32 similarity matrix
containing duplicate values (the ONLY mechanism by which device mode
can change a decision: counts are exact integers either way, so a
decision flips only where an f32 value collision reorders two ranks,
models/part1_cluster.py docstring).

Usage (deployment backend = the GPU; CPU works for the mechanism too):
  python benchmarks/device_mode_parity.py [--sizes 2900 4700 6500 9000 12000]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu.models import part1_cluster  # noqa: E402
from hic_genome_assembler_tpu.utils import fixtures  # noqa: E402

from ref_sidebyside import P, _make_fixture  # noqa: E402

_FILES = ("dendro.txt", "bingroups.txt", "assessment.txt", "chromgroups.txt")


def _run_mode(paths, out_dir, resolution, mode):
    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        part1_cluster.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
            os.path.join(out_dir, "dendro.txt"), "", "",
            os.path.join(out_dir, "bingroups.txt"),
            os.path.join(out_dir, "assessment.txt"),
            os.path.join(out_dir, "chromgroups.txt"),
            hyper_geom=True, hmm=False, min_size=P["min_size"],
            modularity=P["modularity"], louvain_rounds=P["louvain_rounds"],
            psig=P["psig"], convergence_rounds=P["convergence_rounds"],
            look_ahead=P["look_ahead"], resolution=resolution,
            matrix_mode=mode,
        )
    wall = time.time() - t0
    m = re.search(r"CutIndices = (\[[^\]]*\])", buf.getvalue())
    return wall, m.group(1) if m else "?"


def _diff_lines(a_path, b_path):
    a = open(a_path, "rb").read().splitlines()
    b = open(b_path, "rb").read().splitlines()
    n = sum(1 for x, y in zip(a, b) if x != y) + abs(len(a) - len(b))
    return n


def _f32_tie_rows(genome):
    """Rows of the f32 similarity matrix with >= 2 equal values — the
    rank-tie exposure device mode faces (exact mode ranks f64)."""
    from hic_genome_assembler_tpu.io import hicpro
    from hic_genome_assembler_tpu.ops import oracle

    adj = genome.matrix.astype(np.float64)
    row_sums = adj.sum(axis=1)
    dist = oracle.to_distance(adj)
    sim64 = oracle.to_similarity(dist, row_sums)
    sim32 = sim64.astype(np.float32)
    tie_rows = 0
    collisions = 0
    for i in range(sim32.shape[0]):
        u, c = np.unique(sim32[i], return_counts=True)
        extra = int((c > 1).sum())
        if extra:
            # rows where f64 would have separated values f32 collapses
            u64 = np.unique(sim64[i]).size
            if u.size < u64:
                tie_rows += 1
                collisions += int(u64 - u.size)
    return tie_rows, collisions


def run_scale(target_bins: int, check_ties: bool) -> dict:
    genome = _make_fixture(target_bins)
    root = tempfile.mkdtemp(prefix="devparity_")
    paths = fixtures.write_hicpro_files(genome, os.path.join(root, "hicpro"))
    exact_dir = os.path.join(root, "exact")
    dev_dir = os.path.join(root, "device")
    exact_s, exact_cuts = _run_mode(paths, exact_dir, genome.resolution, "exact")
    dev_s, dev_cuts = _run_mode(paths, dev_dir, genome.resolution, "device")

    diffs = {
        n: _diff_lines(os.path.join(exact_dir, n), os.path.join(dev_dir, n))
        for n in _FILES
    }
    equal = all(v == 0 for v in diffs.values())
    out = {
        "bins": genome.n_bins,
        "exact_part1_s": round(exact_s, 2),
        "device_part1_s": round(dev_s, 2),
        "files_byte_equal": equal,
        "cuts_equal": exact_cuts == dev_cuts,
    }
    if not equal:
        out["diff_lines"] = {k: v for k, v in diffs.items() if v}
        out["exact_cuts"] = exact_cuts
        out["device_cuts"] = dev_cuts
    if check_ties:
        tie_rows, collisions = _f32_tie_rows(genome)
        out["f32_rank_tie_rows"] = tie_rows
        out["f32_value_collisions"] = collisions
    return out


def main():
    from hic_genome_assembler_tpu.utils import hostmem

    hostmem.tune()
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--sizes", type=int, nargs="+",
        default=[2900, 4700, 6500, 9000, 12000],
    )
    ap.add_argument("--no-ties", action="store_true",
                    help="skip the f32 tie census (hosts short on time)")
    args = ap.parse_args()
    import jax

    backend = jax.devices()[0].platform
    for n in args.sizes:
        row = run_scale(n, check_ties=not args.no_ties)
        row["backend"] = backend
        print(json.dumps({"device_mode_parity": row}), flush=True)


if __name__ == "__main__":
    main()
