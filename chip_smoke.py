"""Smoke test of the whole pipeline on NVIDIA GPUs.

    python chip_smoke.py                  # phases a-c, one GPU
    python chip_smoke.py --chips 4        # phase d only, four GPUs

a. Device: refuse any platform but ``gpu``; print each card's name and
   power limit.
b. Device kernels against their plain references, at real widths:
   - the part-1 rank-membership counts on a 16384 x 16384 int32 rank
     matrix (growing scans and width-bucketed fixed windows through
     ``RankCounts``), exactly equal to the numpy host scans; with the
     GB/s of one growing scan, of 64 batched growing and 64 batched
     fixed windows (``counts_many``) and of a plain device copy of the
     same matrix;
   - the part-2 scorer on the C = 2048, S = 8 brute-force problem
     (5,160,960 candidates): device f32 scores of the top-k and of
     random candidates against f64 ``score_host``, max relative error
     below the decision margin's budget ``_F32_MARGIN / 8``;
   - a fast-mode ``GaussianHMM2`` fit at the 4K HMM fixture's width
     against the numpy EM oracle: equal decoded paths, means and
     covariances within rtol 1e-4.
c. Main path: the e2e-16k planted genome (25 chromosomes x 52
   scaffolds, ~17K bins) through the CLI entry point, parts 1-4
   in-process, checked against the planted truth, with no f32-margin
   violation.
d. ``--chips 4``: the mesh and EP paths on the first 10 chromosomes of
   the e2e-16k genome (6,880 bins).  The parent stays off
   JAX and runs the CLI in child processes one stage after another, each owning
   its cards through ``CUDA_VISIBLE_DEVICES``: a one-card reference run
   of parts 1 and 2; four cards under ``-mesh 4x1`` and ``-mesh 2x2``;
   part 2 as two ``jax.distributed`` processes of two cards each (EP).
   Every file-bus output must equal the one-card run's bytes.

Exits 0 only when every phase passed; its last line of output is then
one JSON object naming the device as JAX reports it.  Any failure,
including a platform other than ``gpu``, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


class SmokeFailure(Exception):
    """A phase's result disagrees with its reference."""


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# a. device
# ---------------------------------------------------------------------------


def phase_device(require: str = "gpu") -> dict:
    import jax

    from hic_genome_assembler_tpu.parallel import runtime

    devices = jax.devices()
    _check(
        devices[0].platform == require,
        f"needs platform {require!r}; JAX found {runtime.device_summary()}",
    )
    runtime.enable_compile_cache()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _median_time(fn, reps: int) -> float:
    """Median wall seconds of ``fn()`` (which must block on its result)
    after one warm-up call that compiles."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# b. kernels vs plain references
# ---------------------------------------------------------------------------


def _fixed_pairs(n: int, k: int, rng) -> list:
    """``k`` (start, cut) windows: first an empty (cut < start) one, then
    windows spread over the column buckets the cut-noise filter
    dispatches (narrow, 2-4K, 4-8K, wide)."""
    bands = [(1, 2048, 0.6), (2048, 4096, 0.2), (4096, 8192, 0.12), (8192, n, 0.08)]
    pairs = [(n // 2, n // 3)]
    for lo, hi, share in bands:
        lo, hi = min(lo, n - 1), min(hi, n - 1)
        for _ in range(max(1, int(round(share * k)))):
            width = int(rng.integers(lo, max(hi, lo + 1)))
            start = int(rng.integers(0, max(n - width, 1)))
            pairs.append((start, min(start + width, n - 1)))
    return pairs[:k]


def phase_counts(n: int = 16384, n_growing: int = 8, n_fixed: int = 64,
                 reps: int = 10, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from hic_genome_assembler_tpu.cluster import breakpoints as bp
    from hic_genome_assembler_tpu.ops import matrix as dev

    rank_dev = jnp.argsort(
        jax.random.uniform(jax.random.PRNGKey(seed), (n, n)), axis=1
    ).astype(jnp.int32)
    rank = np.asarray(rank_dev)
    del rank_dev
    counts = bp.RankCounts(rank)
    _check(counts._host is None, f"n={n} took the host scan, not the device path")

    rng = np.random.default_rng(seed)
    starts = sorted({0, 1, 7, n - 2, *rng.integers(0, n, max(n_growing - 4, 0)).tolist()})
    pairs = _fixed_pairs(n, n_fixed, rng)
    counts.prefetch_growing(starts[: len(starts) // 2])
    got_growing = {s: counts.growing(s) for s in starts}
    counts.prefetch_fixed_pairs(pairs)
    got_fixed = {p: counts.fixed(*p) for p in pairs}
    for s, got in got_growing.items():
        _check(np.array_equal(got, bp._host_growing_counts(rank, s)),
               f"growing counts differ from the host scan at start {s}")
    for (s, c), got in got_fixed.items():
        _check(np.array_equal(got, bp._host_fixed_counts(rank, s, c)),
               f"fixed counts differ from the host scan at ({s}, {c})")

    # rates: bytes of the rank matrix each kernel reads (the whole matrix
    # per window) over its time; the copy reads and writes it once
    mat = counts._dev
    gb = n * n * 4 / 1e9
    fixed = jnp.asarray(np.array([[s, c, 0] for s, c in pairs], dtype=np.int32))
    growing = jnp.asarray(
        np.array([[s, 0, 1] for s in rng.integers(0, n, len(pairs))], dtype=np.int32)
    )
    copy = jax.jit(lambda x: x + 1)
    start7 = jnp.int32(7)
    times = {
        "growing": _median_time(
            lambda: dev.growing_window_counts(mat, start7).block_until_ready(), reps),
        "many_growing": _median_time(
            lambda: dev.counts_many(mat, growing).block_until_ready(), reps),
        "many_fixed": _median_time(
            lambda: dev.counts_many(mat, fixed).block_until_ready(), reps),
        "copy": _median_time(lambda: copy(mat).block_until_ready(), reps),
    }
    out = {
        "n": n,
        "growing_starts": len(starts),
        "fixed_windows": len(pairs),
        "empty_windows": sum(c < s for s, c in pairs),
        "exact": True,
        **{f"{k}_ms": t * 1e3 for k, t in times.items()},
        "growing_GBps": gb / times["growing"],
        "many_growing_GBps": len(pairs) * gb / times["many_growing"],
        "many_fixed_GBps": len(pairs) * gb / times["many_fixed"],
        "copy_GBps": 2 * gb / times["copy"],
    }
    for k in ("growing", "many_growing", "many_fixed"):
        out[f"{k}_share_of_copy"] = out[f"{k}_GBps"] / out["copy_GBps"]
    return out


def phase_scorer(sizes=None, n_random: int = 200, seed: int = 0) -> dict:
    import bench
    from hic_genome_assembler_tpu.ops import cost, perms

    m, sizes = bench.build_problem(bench.SIZES if sizes is None else sizes, seed)
    S = len(sizes)
    orders = perms.order_batch(S)
    orients = perms.orient_batch(S)
    R = len(orients)
    n_cand = len(orders) * R
    scorer = cost.BlockScorer(m, sizes, dtype=np.float32)
    scorer.score_batch_topk(orders, orients)  # compile
    t0 = time.perf_counter()
    top_idx, top_vals, _floor = scorer.score_batch_topk(orders, orients)
    t_topk = time.perf_counter() - t0
    full = scorer.score_batch(orders, orients)
    _check(full.shape == (n_cand,) and np.isfinite(full).all(),
           "full fast-cost vector is not finite")
    rng = np.random.default_rng(seed)
    rand_idx = rng.choice(n_cand, size=min(n_random, n_cand), replace=False)
    pair_vals = scorer.score_pairs(
        orders[rand_idx // R], orients[rand_idx % R]
    )

    def rel(fast, exact):
        return abs(exact - fast) / max(abs(exact), 1.0)

    def exact(i):
        return scorer.score_host(orders[i // R], orients[i % R])

    errs = [rel(float(v), exact(int(i))) for i, v in zip(top_idx, top_vals)]
    for j, i in enumerate(rand_idx):
        e = exact(int(i))
        errs += [rel(float(full[i]), e), rel(float(pair_vals[j]), e)]
    budget = cost._F32_MARGIN / 8.0
    out = {
        "C": int(sum(sizes)),
        "S": S,
        "candidates": n_cand,
        "rescored": len(top_idx) + len(rand_idx),
        "max_rel_err": float(np.max(errs)),
        "median_rel_err": float(np.median(errs)),
        "budget": budget,
        "topk_wall_s": t_topk,
        "topk_evals_per_s": n_cand / t_topk,
    }
    _check(out["max_rel_err"] < budget,
           f"scorer f32 error {out['max_rel_err']:.3g} >= budget {budget:.3g}")
    return out


def hmm_fixture(n: int = 4096, seed: int = 7) -> np.ndarray:
    """The part-1 HMM input of ``benchmarks/run_benchmarks.py``'s HMM
    fixture (log10 similarity of a planted block genome) cut to its
    first HMM round: all rows, the first lookAhead = 0.2 of columns."""
    from hic_genome_assembler_tpu.ops import oracle
    from hic_genome_assembler_tpu.utils import fixtures

    m = fixtures.hmm_scale_genome(n, seed=seed).matrix.astype(np.float64)
    adj = oracle.to_similarity(oracle.to_distance(m), m.sum(axis=1))
    adj = oracle.log_transform(adj, log_base=10, plus_one=True)
    return np.ascontiguousarray(adj[:, : int(0.2 * len(adj))])


def phase_hmm(n: int = 4096, seed: int = 7) -> dict:
    from hic_genome_assembler_tpu.ops import oracle
    from hic_genome_assembler_tpu.ops.gaussian_hmm import GaussianHMM2

    X = hmm_fixture(n, seed)
    model = GaussianHMM2(seed=0, mode="fast")
    means0, covars0 = model._init_params(X)
    model._init_params = lambda _x: (means0.copy(), covars0.copy())
    t0 = time.perf_counter()
    model.fit(X)
    t_fit = time.perf_counter() - t0
    path = model.predict(X)
    m_np, c_np, t_np = oracle.gaussian_hmm_em_fit(
        X, means0.copy(), covars0.copy(), model.transmat_init.copy(),
        model.startprob, model.tol, model.n_iter,
    )
    path_np = oracle.gaussian_hmm_viterbi(
        oracle.gaussian_hmm_log_density(X, m_np, c_np), model.startprob, t_np
    )

    def max_rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))

    out = {
        "T": int(X.shape[0]),
        "D": int(X.shape[1]),
        "fit_s": t_fit,
        "paths_equal": bool(np.array_equal(path, path_np)),
        "means_max_rel": max_rel(model.means_, m_np),
        "covars_max_rel": max_rel(model.covars_, c_np),
        "means_max_abs": float(np.max(np.abs(model.means_ - m_np))),
    }
    _check(out["paths_equal"], "HMM decoded path differs from the numpy oracle")
    for name, got, want in (("means", model.means_, m_np), ("covars", model.covars_, c_np)):
        _check(np.allclose(got, want, rtol=1e-4, atol=1e-6),
               f"HMM {name} differ from the numpy oracle beyond rtol 1e-4")
    return out


# ---------------------------------------------------------------------------
# c. the main path at full size
# ---------------------------------------------------------------------------


def write_config(path: str, data: dict, out_dir: str, resolution: int) -> str:
    """The e2e-16k deployment's pipeline config (every plot key empty)."""
    from hic_genome_assembler_tpu.utils import fixtures

    return fixtures.write_pipeline_config(
        path, data, out_dir, resolution,
        hyperGeom="True", hmm="False", minSize=15, modularity=0, psig=0.05,
        convergenceRounds=10, lookAhead=0.5, louvainRounds=3, nScaffolds=6,
        scanScaffolds=5, lengthCutoff=resolution,
    )


def phase_pipeline(workdir: str, seed: int = 3, n_chroms: int = 25,
                   scaffolds: int = 52) -> dict:
    from hic_genome_assembler_tpu import cli
    from hic_genome_assembler_tpu.ops import cost
    from hic_genome_assembler_tpu.utils import fixtures, profiling

    t0 = time.perf_counter()
    genome = fixtures.e2e_16k_genome(seed, n_chroms, scaffolds)
    data = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    t_fixture = time.perf_counter() - t0
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)
    cfg = write_config(os.path.join(workdir, "config.txt"), data, out_dir,
                       genome.resolution)
    cost.PRECISION.reset()
    t0 = time.perf_counter()
    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg])
    wall = time.perf_counter() - t0
    out = {
        "bins": genome.n_bins,
        "scaffolds": len(genome.scaffolds),
        "fixture_s": t_fixture,
        "wall_s": wall,
        **{f"part{k}_s": profiling.summary()[f"part{k}/total"]["total_s"]
           for k in (1, 2, 3, 4)},
        **fixtures.check_assembly(
            genome, *(os.path.join(out_dir, name) for name in
                      ("chromgroups.txt", "final_order.txt", "assembled.fasta"))),
        "precision_rescored": cost.PRECISION.n,
        "precision_max_rel": cost.PRECISION.max_rel,
        "precision_violations": cost.PRECISION.violations,
        "profiling_summary": profiling.summary(),
        "counters": profiling.counters(),
    }
    _check(out["orders_checked"] > 0 and out["orders_recovered"] == out["orders_checked"],
           f"orders recovered {out['orders_recovered']}/{out['orders_checked']}")
    covered = out["chromosomes_covered_by_ordered_segments"]
    _check(covered == out["planted_chromosomes"],
           f"chromosomes covered {covered}/{out['planted_chromosomes']}")
    _check(out["entry_lengths_ok"] == out["ordered_groups"],
           f"FASTA entry lengths ok {out['entry_lengths_ok']}/{out['ordered_groups']}")
    _check(out["precision_violations"] == 0,
           f"{out['precision_violations']} f32 margin violations")
    return out


# ---------------------------------------------------------------------------
# d. four cards: mesh and EP against one card (parent stays off JAX)
# ---------------------------------------------------------------------------

BUS_FILES = ("dendro.txt", "bingroups.txt", "assessment.txt",
             "chromgroups.txt", "chromorder.txt", "plotorder.txt")
EP_FILES = ("chromorder.txt", "plotorder.txt")


def _cli_child(cfg: str, parts, mesh: str, cards: str, env_extra=None):
    """Start ``python -m hic_genome_assembler_tpu`` on ``cards``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards, **(env_extra or {}))
    cmd = [sys.executable, "-m", "hic_genome_assembler_tpu", *parts,
           "-config", cfg, "-mesh", mesh]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


_DEVICE_LINE = re.compile(r"^- Device: platform=(\S+) kind=(.*) count=(\d+)$", re.M)


def _finish(proc, tag: str, log_dir: str, timeout: float) -> dict:
    """Wait for a child; keep its log under ``log_dir``; return the
    device it reported (``runtime.bring_up``'s device line)."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise SmokeFailure(f"{tag}: timed out after {timeout} s")
    with open(os.path.join(log_dir, f"{tag}.log"), "w") as fh:
        fh.write(out)
    if proc.returncode != 0:
        raise SmokeFailure(f"{tag}: exit {proc.returncode}\n{out[-4000:]}")
    found = _DEVICE_LINE.search(out)
    if found is None:
        raise SmokeFailure(f"{tag}: printed no device line")
    return {"platform": found[1], "kind": found[2], "count": int(found[3])}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bytes_equal(ref_dir: str, other_dir: str, names) -> dict:
    def read(d, n):
        with open(os.path.join(d, n), "rb") as fh:
            return fh.read()

    return {n: read(ref_dir, n) == read(other_dir, n) for n in names}


def phase_multichip(workdir: str, log_dir: str, seed: int = 3,
                    n_chroms: int = 10, scaffolds: int = 52,
                    timeout: float = 900.0, require: str = "gpu") -> dict:
    """The first ``n_chroms`` chromosomes of the e2e-16k genome (10:
    6,880 bins, above the host-scan cut-off, so the one-card run counts
    on the device too) through every mesh and EP path."""
    from hic_genome_assembler_tpu.utils import fixtures

    genome = fixtures.e2e_16k_genome(seed, n_chroms, scaffolds)
    data = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    runs = {}

    def run_dir(tag):
        d = os.path.join(workdir, tag)
        os.makedirs(d, exist_ok=True)
        return d, write_config(os.path.join(workdir, f"{tag}.txt"), data, d,
                               genome.resolution)

    parts = ("-part1", "-part2")
    ref_dir, cfg = run_dir("one_card")
    t0 = time.perf_counter()
    devices = {"one_card": _finish(_cli_child(cfg, parts, "off", "0"),
                                   "one_card", log_dir, timeout)}
    runs["one_card_s"] = time.perf_counter() - t0
    equal = {}
    for tag, mesh in (("mesh_4x1", "4x1"), ("mesh_2x2", "2x2")):
        d, cfg = run_dir(tag)
        t0 = time.perf_counter()
        devices[tag] = _finish(_cli_child(cfg, parts, mesh, "0,1,2,3"), tag,
                               log_dir, timeout)
        runs[f"{tag}_s"] = time.perf_counter() - t0
        equal[tag] = _bytes_equal(ref_dir, d, BUS_FILES)

    # EP: part 2 only, from the one-card run's part-1 outputs
    ep_dir, cfg = run_dir("ep_2x2cards")
    for name in ("dendro.txt", "bingroups.txt", "assessment.txt", "chromgroups.txt"):
        shutil.copy(os.path.join(ref_dir, name), ep_dir)
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    try:
        for rank, cards in ((0, "0,1"), (1, "2,3")):
            procs.append(_cli_child(cfg, ("-part2",), "2x1", cards, {
                "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                "JAX_NUM_PROCESSES": "2",
                "JAX_PROCESS_ID": str(rank),
            }))
        for rank, proc in enumerate(procs):
            devices[f"ep_rank{rank}"] = _finish(proc, f"ep_rank{rank}", log_dir, timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    runs["ep_s"] = time.perf_counter() - t0
    equal["ep"] = _bytes_equal(ref_dir, ep_dir, EP_FILES)

    out = {"bins": genome.n_bins, "devices": devices, "byte_identical": equal, **runs}
    print(f"[chip_smoke] d_multichip result: {json.dumps(out)}", flush=True)
    for tag, dev in devices.items():
        _check(dev["platform"] == require, f"{tag} ran on {dev}")
    _check(devices["mesh_4x1"]["count"] == 4, f"four-card runs saw {devices['mesh_4x1']}")
    for tag, files in equal.items():
        _check(all(files.values()), f"{tag} file bus differs from one card: {files}")
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _report(name: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        result = fn(*args, **kwargs)
    except SmokeFailure as exc:
        print(f"[chip_smoke] phase {name}: FAILED after "
              f"{time.perf_counter() - t0:.1f} s: {exc}", flush=True)
        raise
    print(f"[chip_smoke] phase {name}: ok in {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(result, default=str)}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh/EP phase (d)")
    ap.add_argument("--seed", type=int, default=3,
                    help="seed of the generated genomes")
    args = ap.parse_args(argv)
    try:
        from hic_genome_assembler_tpu.parallel import runtime
    except ImportError:
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            if args.chips == 4:
                card = runtime.nvidia_smi_identity()
                print(f"[chip_smoke] cards: {card}", flush=True)
                log_dir = os.path.join(REPO, "chiprun_out", "chip_smoke_4")
                os.makedirs(log_dir, exist_ok=True)
                res = _report("d_multichip", phase_multichip, work, log_dir,
                              seed=args.seed)
                device = res["devices"]["mesh_4x1"]
            else:
                device = _report("a_device", phase_device)
                print(f"[chip_smoke] card: {runtime.nvidia_smi_identity()}", flush=True)
                # the main path first, so the first peak is its own
                _report("c_pipeline", phase_pipeline, work, seed=args.seed)
                print(f"[chip_smoke] peak_bytes_in_use after c: {_peak_bytes()}", flush=True)
                _report("b_counts", phase_counts)
                _report("b_scorer", phase_scorer)
                _report("b_hmm", phase_hmm)
                print(f"[chip_smoke] peak_bytes_in_use after b: {_peak_bytes()}", flush=True)
    except SmokeFailure:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
