"""Benchmark: permutation cost evaluations per second per chip.

Workload = the reference's hot loop #1a (SURVEY.md §3.2): brute-force
scoring of all N!/2 * 2^N order/orientation candidates of the 8 largest
scaffolds of a chromosome (5,160,960 candidates at nScaffolds=8,
orderGenome.py:432-473) on a C x C contact submatrix.

Ours: BlockScorer — one device pass plus one matmul builds the
pair/orientation/offset table, then each candidate costs S(S-1)/2 table
gathers, batched on device.

Baseline: the reference evaluates each candidate with a dense gather
(numpy.ix_) + the numba trace-loop kernel (orderGenome.py:463,184-193).
numba is not installed here, so the baseline rate is measured with the
same per-candidate algorithm in vectorized numpy f64 (gather +
per-offset trace sum), which is, if anything, FASTER than the
reference's scalar numba loop for large C — making vs_baseline a
conservative ratio.

Needs a GPU: exits non-zero when JAX's first device is not one.
Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) or ".")

from hic_genome_assembler_tpu.ops import cost, oracle, perms  # noqa: E402


SIZES = (512, 384, 320, 256, 224, 160, 128, 64)  # C = 2048, S = 8


def build_problem(sizes=SIZES, seed=0):
    """A C x C distance-decay contact block (C = sum(sizes)) with seeded
    noise, and its scaffold sizes."""
    sizes = list(sizes)
    C = sum(sizes)
    rng = np.random.default_rng(seed)
    pos = np.arange(C)
    m = 100.0 / (1.0 + np.abs(pos[:, None] - pos[None, :]))
    m += rng.random((C, C)) * 0.01
    m = np.triu(m) + np.triu(m, 1).T
    return m, sizes


def bench_device(m, sizes, orders, orients, chunk=20160):
    import jax
    import jax.numpy as jnp

    # The contact matrix is device-resident from ingestion in the real
    # pipeline (part2's _ChromosomeContext slices chromosome submatrices
    # on device), so staging it is setup, not scoring work.
    m_dev = jnp.asarray(m.astype(np.float32))
    jax.block_until_ready(m_dev)
    # warm up / compile with the same chunk shape as the timed run
    scorer = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev)
    scorer.score_batch_topk(orders, orients, chunk_orders=chunk)
    # time REPS full scoring passes (each rebuilds the subset table,
    # orderGenome-equivalent work) with the readbacks of all passes
    # drained at the end: steady-state throughput
    reps = 15
    start = time.time()
    finishes = []
    for _ in range(reps):
        scorer = cost.BlockScorer(m, sizes, dtype=np.float32, device_sub=m_dev)
        handles, finish = scorer.score_batch_topk_async(
            orders, orients, chunk_orders=chunk
        )
        finishes.append((handles, finish))
    import jax as _jax

    all_host = _jax.device_get([list(h) for h, _f in finishes])  # one transfer
    outs = [finish(host) for (_h, finish), host in zip(finishes, all_host)]
    elapsed = (time.time() - start) / reps
    idx, vals, _floor = outs[-1]
    n_cand = len(orders) * len(orients)
    best = int(idx[int(np.argmax(vals))])
    return n_cand / elapsed, elapsed, best


_BASELINE_META = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "benchmarks", "baseline_cpu.json"
)


def bench_reference_style(m, sizes, orders, orients, sample=10, batches=10):
    """Reference-style per-candidate rate, measured as the MEDIAN of
    ``batches`` batch rates (100 evals total by default)."""
    total = cost.upper_triangle_total(m)
    rng = np.random.default_rng(1)
    R = len(orients)
    rates = []
    for _ in range(batches):
        picks = rng.integers(0, len(orders) * R, sample)
        start = time.time()
        for flat in picks:
            o, r = orders[flat // R], orients[flat % R]
            bo = cost.bin_order_of_block(o, r, sizes)
            gathered = m[np.ix_(bo, bo)]
            oracle.cost_function(gathered, total)
        rates.append(sample / (time.time() - start))
    return float(np.median(rates))


def reference_baseline_rate(m, sizes, orders, orients):
    """The PINNED CPU baseline (benchmarks/baseline_cpu.json).

    The baseline is host/noise-dependent; re-measuring it per run made
    vs_baseline swing 5x across rounds with zero kernel change (VERDICT
    r3 weak #4).  The pinned rate was measured once with 100 evals
    (median of 10 batch rates); if the metadata file is absent the
    measurement reruns and repins it."""
    meta = {}
    try:
        with open(_BASELINE_META) as fh:
            meta = json.load(fh)
        rate = float(meta["evals_per_s"])
        # A zero/negative/non-finite pin would divide-by-zero or produce
        # a nonsense ratio (ADVICE r4 #2): treat it as a cache miss.
        if np.isfinite(rate) and rate > 0:
            return rate, True, meta
    except (OSError, KeyError, ValueError, TypeError):
        pass
    rate = bench_reference_style(m, sizes, orders, orients)
    meta = {
        "evals_per_s": round(rate, 2),
        "method": "median of 10x10-eval batches (auto re-pin)",
        "host": os.uname().nodename,
        "measured_date": time.strftime("%Y-%m-%d"),
    }
    try:
        with open(_BASELINE_META, "w") as fh:
            json.dump(meta, fh)
    except OSError:
        pass
    return rate, False, meta


def main():
    import jax

    from hic_genome_assembler_tpu.parallel import runtime
    from hic_genome_assembler_tpu.utils import hostmem

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {runtime.device_summary()}")
    runtime.enable_compile_cache()
    hostmem.tune()  # warm-page reuse for the per-pass host bookkeeping
    m, sizes = build_problem()
    orders = perms.order_batch(len(sizes))        # 20160 orders
    orients = perms.orient_batch(len(sizes))      # 256 orientation combos

    rate_dev, elapsed, best = bench_device(m, sizes, orders, orients)
    rate_ref, pinned, meta = reference_baseline_rate(m, sizes, orders, orients)

    result = {
        "metric": "brute-force permutation cost evaluations/sec/chip (C=2048, S=8, 5.16M candidates)",
        "value": round(rate_dev, 1),
        "unit": "evals/s",
        "vs_baseline": round(rate_dev / rate_ref, 1),
        "detail": {
            "device_wall_s": round(elapsed, 3),
            "device": {
                "platform": device.platform,
                "kind": device.device_kind,
                "count": len(jax.devices()),
                "card": runtime.nvidia_smi_identity(),
            },
            "cpu_reference_style_evals_per_s": round(rate_ref, 2),
            "baseline_pinned": pinned,
            # vs_baseline compares a live device rate to a rate pinned
            # once on a specific CPU host — echo that provenance so the
            # ratio is never mistaken for a same-run, same-host comparison.
            "baseline_host": meta.get("host", "unknown"),
            "baseline_date": meta.get("measured_date", meta.get("date", "unpinned")),
            "candidates": len(orders) * len(orients),
            "best_candidate": best,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
