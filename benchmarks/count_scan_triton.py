"""A Pallas/Triton rank-membership count kernel, measured against the XLA path.

The part-1 count scans (``ops/matrix.py``: ``growing_window_counts``,
``fixed_window_counts``, ``counts_many``) run as plain XLA reductions.
This module keeps the one hand-written alternative, off the main path,
so that the measurement behind that choice can be rerun:

    python benchmarks/count_scan_triton.py             # micro + part-1 run
    python benchmarks/count_scan_triton.py --micro     # micro only

``counts_many_triton`` has the contract of ``matrix.counts_many``:
``params`` int32[K, 3] rows of (start, cut, flag), flag 1 the growing
scan, 0 the fixed window; the result is int32[K, n].  Grid (window,
row tile): each program owns ``block_rows`` rows of one window, loads
its (start, cut, flag) itself, and loops over ``block_cols``-wide
column tiles only as far as the window reads (a growing scan's
triangle, a fixed window's prefix).  Window is the fastest grid axis, so
a batch of windows reads each row tile from L2 more than from memory.

The script (GPU only) checks the kernel exactly against XLA at
n = 16384, times both on single and batched windows beside a plain
device copy, then runs part 1 of the e2e-16k genome four times in one
process with the count functions swapped (XLA, Triton, Triton, XLA),
checking that the file bus is byte-identical.  Every line names the
card and its power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plgpu  # noqa: E402


def _count_kernel(start_ref, cut_ref, flag_ref, rank_ref, out_ref, *,
                  block_rows: int, block_cols: int):
    n, ncols = rank_ref.shape
    r0 = pl.program_id(1) * block_rows
    start, cut, flag = start_ref[()], cut_ref[()], flag_ref[()]
    rows = r0 + jnp.arange(block_rows, dtype=jnp.int32)
    growing = flag == 1
    # row i counts columns j < lim[i] whose rank lies in [start, upper[i]]
    lim = jnp.where(growing, rows - start, cut - start)
    upper = jnp.where(growing, rows, cut)
    last_row = jnp.minimum(r0 + block_rows, n) - 1
    hi = jnp.clip(jnp.where(growing, last_row - start, cut - start), 0, ncols)
    row_ok = rows < n

    def body(t, acc):
        c0 = t * block_cols
        cols = c0 + jnp.arange(block_cols, dtype=jnp.int32)
        v = plgpu.load(
            rank_ref.at[pl.ds(r0, block_rows), pl.ds(c0, block_cols)],
            mask=row_ok[:, None] & (cols < ncols)[None, :], other=-1,
        )
        hit = ((cols[None, :] < lim[:, None]) & (v >= start)
               & (v <= upper[:, None]))
        return acc + jnp.sum(hit, axis=1, dtype=jnp.int32)

    trips = (hi + (block_cols - 1)) // block_cols
    acc = jax.lax.fori_loop(0, trips, body, jnp.zeros((block_rows,), jnp.int32))
    plgpu.store(out_ref.at[pl.program_id(0), pl.ds(r0, block_rows)], acc,
                mask=row_ok)


@functools.partial(jax.jit, static_argnames=("block_rows", "block_cols", "interpret"))
def counts_many_triton(rank_mat, params, *, block_rows: int = 16,
                       block_cols: int = 512, interpret: bool = False):
    """``matrix.counts_many`` as one Pallas/Triton kernel (see module doc)."""
    n = rank_mat.shape[0]
    k = params.shape[0]
    scalar = pl.BlockSpec((None,), lambda w, r: (w,))
    kernel = functools.partial(_count_kernel, block_rows=block_rows,
                               block_cols=block_cols)
    return pl.pallas_call(
        kernel,
        grid=(k, pl.cdiv(n, block_rows)),
        in_specs=[scalar, scalar, scalar, pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((k, n), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="rank_counts",
    )(params[:, 0], params[:, 1], params[:, 2], rank_mat)


def growing_window_counts_triton(rank_mat, start):
    params = jnp.stack([jnp.int32(start), jnp.int32(0), jnp.int32(1)])[None, :]
    return counts_many_triton(rank_mat, params)[0]


def fixed_window_counts_triton(rank_mat, start, cut):
    params = jnp.stack([jnp.int32(start), jnp.int32(cut), jnp.int32(0)])[None, :]
    return counts_many_triton(rank_mat, params)[0]


# ---------------------------------------------------------------------------
# measurement (GPU only)
# ---------------------------------------------------------------------------


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _windows(n: int, k: int, rng, max_width: int) -> np.ndarray:
    widths = rng.integers(1, max_width, k)
    starts = rng.integers(0, n - widths)
    return np.stack([starts, starts + widths, np.zeros(k, np.int64)], 1).astype(np.int32)


def micro(n: int = 16384, k: int = 64, reps: int = 10, seed: int = 0) -> dict:
    from hic_genome_assembler_tpu.ops import matrix as dev

    rank = jnp.argsort(jax.random.uniform(jax.random.PRNGKey(seed), (n, n)),
                       axis=1).astype(jnp.int32)
    rng = np.random.default_rng(seed)
    growing = np.zeros((k, 3), np.int32)
    growing[:, 0] = rng.integers(0, n, k)
    growing[:, 2] = 1
    narrow = _windows(n, k, rng, 2048)      # one 2048-column bucket
    wide = _windows(n, k, rng, n)           # widths uniform in [1, n)
    cases = {"growing": jnp.asarray(growing), "fixed_2048": jnp.asarray(narrow),
             "fixed_wide": jnp.asarray(wide)}
    for name, params in cases.items():
        want = dev.counts_many(rank, params)
        got = counts_many_triton(rank, params)
        if not bool(jnp.array_equal(want, got)):
            raise SystemExit(f"triton counts differ from XLA on {name}")
    one = cases["growing"][:1]
    sliced = rank[:, :2048]
    copy = jax.jit(lambda x: x + 1)
    ms = {
        "copy": _median_ms(lambda: copy(rank).block_until_ready(), reps),
        "xla_growing_1": _median_ms(
            lambda: dev.growing_window_counts(rank, one[0, 0]).block_until_ready(), reps),
        "triton_growing_1": _median_ms(
            lambda: counts_many_triton(rank, one).block_until_ready(), reps),
    }
    for name, params in cases.items():
        # the XLA path runs narrow windows on a column-sliced view, as
        # RankCounts.prefetch_fixed_pairs dispatches them
        mat = sliced if name == "fixed_2048" else rank
        ms[f"xla_{name}_{k}"] = _median_ms(
            lambda: dev.counts_many(mat, params).block_until_ready(), reps)
        ms[f"triton_{name}_{k}"] = _median_ms(
            lambda: counts_many_triton(rank, params).block_until_ready(), reps)
    gb = n * n * 4 / 1e9
    return {"n": n, "windows": k, "exact": True, "ms": ms,
            "copy_GBps": 2 * gb / (ms["copy"] / 1e3)}


def part1_runs(workdir: str, seed: int = 3, n_chroms: int = 25,
               scaffolds: int = 52) -> dict:
    """Part 1 of the e2e-16k genome, count functions swapped per run."""
    from hic_genome_assembler_tpu import cli
    from hic_genome_assembler_tpu.ops import matrix as dev
    from hic_genome_assembler_tpu.utils import fixtures, profiling

    genome = fixtures.e2e_16k_genome(seed, n_chroms, scaffolds)
    data = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    xla = (dev.counts_many, dev.growing_window_counts, dev.fixed_window_counts)
    triton = (counts_many_triton, growing_window_counts_triton,
              fixed_window_counts_triton)
    runs, buses = [], {}
    for i, (tag, fns) in enumerate((("xla", xla), ("triton", triton),
                                    ("triton", triton), ("xla", xla))):
        out = os.path.join(workdir, f"run{i}")
        os.makedirs(out)
        cfg = fixtures.write_pipeline_config(
            os.path.join(workdir, f"cfg{i}.txt"), data, out, genome.resolution,
            minSize=15, modularity=0, convergenceRounds=10, lookAhead=0.5,
            louvainRounds=3, lengthCutoff=genome.resolution)
        dev.counts_many, dev.growing_window_counts, dev.fixed_window_counts = fns
        try:
            cli.main(["-part1", "-config", cfg])
        finally:
            dev.counts_many, dev.growing_window_counts, dev.fixed_window_counts = xla
        summary = profiling.summary()
        runs.append({
            "kernel": tag,
            "part1_s": summary["part1/total"]["total_s"],
            "cut_detection_s": summary["part1/cut_detection_hypergeom"]["total_s"],
        })
        bus = {}
        for name in ("dendro.txt", "bingroups.txt", "assessment.txt", "chromgroups.txt"):
            with open(os.path.join(out, name), "rb") as fh:
                bus[name] = fh.read()
        buses[i] = bus
    identical = all(buses[i] == buses[0] for i in buses)
    return {"bins": genome.n_bins, "runs": runs, "file_bus_identical": identical}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--micro", action="store_true", help="skip the part-1 runs")
    args = ap.parse_args(argv)
    from hic_genome_assembler_tpu.parallel import runtime

    if jax.devices()[0].platform != "gpu":
        print(f"needs a GPU; JAX found {runtime.device_summary()}", file=sys.stderr)
        return 1
    runtime.enable_compile_cache()
    card = runtime.nvidia_smi_identity()
    res = micro()
    print(json.dumps({"micro": res, "card": card}), flush=True)
    if not args.micro:
        with tempfile.TemporaryDirectory(prefix="count_scan_") as work:
            res = part1_runs(work)
        print(json.dumps({"part1": res, "card": card}), flush=True)
        if not res["file_bus_identical"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
