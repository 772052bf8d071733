"""Hypergeometric chromosome-cut detection (part1 default strategy).

Behavior-parity port of the reference's breakpoint machinery
(scaffoldToChromosomes.py:352-727) with the O(N^2) inner count loops
moved onto device:

* the growing-window scan's per-row rank-membership counts
  (scaffoldToChromosomes.py:449-463) are one fused XLA reduction
  (ops.matrix.growing_window_counts) instead of N python loops;
* the cut-noise filter's fixed-window counts (:622-636) likewise
  (ops.matrix.fixed_window_counts);
* p-value DECISIONS (always ``sf < psig`` — no p-value is ever consumed
  as a number) run through ops.hypergeom.ge_significant: an exact f64
  log-gamma-anchored pmf-window evaluator with rigorous Chernoff-KL
  shortcuts, decision-identical to scipy by construction (near-ties are
  re-arbitrated by scipy itself) in place of the full
  scipy.stats.hypergeom.sf sweeps that dominated part-1 at 16K.  The
  scalar second-level tests keep calling scipy directly.

Preserved quirks (SURVEY.md §7): the aggressive pass hardcodes psig=.05
regardless of config (:535); the noise filter's GLOBAL_MAX_ROUNDS
counter is reset every iteration in the reference so the cap never
fires (:592-716, making the ``rc`` NameError at :713 dead code) — here
the loop runs to fixpoint with a large safety cap.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
import scipy.stats

from hic_genome_assembler_tpu.ops import hypergeom


@functools.lru_cache(maxsize=1)
def _u16_jit():
    import jax

    return jax.jit(lambda a: a.astype(jnp.uint16))


def _narrow_u16(x):
    return _u16_jit()(x)


def hyper_geom_sf(x, M, n, N) -> np.ndarray:
    """P(X >= x) for a hypergeometric(M, n, N) draw — the reference's
    hyper_geom (scaffoldToChromosomes.py:352-368), vectorized."""
    return scipy.stats.hypergeom.sf(np.asarray(x) - 1, M, n, N)


def sliding_window_break_signals(sig: np.ndarray, window: int) -> np.ndarray:
    """Left-half minus right-half sums per step
    (get_sliding_window_distance_metrics, scaffoldToChromosomes.py:370-411).

    Returns empty when window >= len(sig) (the reference's "NA" path).
    Steps whose right half is truncated score 0.
    """
    n = len(sig)
    if window >= n:
        return np.zeros(0, dtype=np.int64)
    sig = np.asarray(sig, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(sig)])
    i = np.arange(n - window)
    left = csum[i + window] - csum[i]
    hi = i + 2 * window
    truncated = hi > n  # shape-mismatch guard in the reference -> 0
    right = csum[np.minimum(hi, n)] - csum[i + window]
    return np.where(truncated, 0, left - right)


# Below this size the vectorized host scan needs no device transfer or
# compile at all; above it the rank matrix lives on
# the device and the counts run as fused XLA reductions.
_HOST_N = 4096


def _host_growing_counts(rank_mat: np.ndarray, start: int) -> np.ndarray:
    n = rank_mat.shape[0]
    rows = np.arange(n, dtype=np.int64)[:, None]
    cols = np.arange(n, dtype=np.int64)[None, :]
    mask = (cols < rows - start) & (rank_mat >= start) & (rank_mat <= rows)
    return mask.sum(axis=1).astype(np.int32)


def _host_fixed_counts(rank_mat: np.ndarray, start: int, cut: int) -> np.ndarray:
    width = max(cut - start, 0)
    window = rank_mat[:, :width]
    return ((window >= start) & (window <= cut)).sum(axis=1).astype(np.int32)


class RankCounts:
    """Device-resident rank matrix + count kernels.

    The counts are the fused XLA reductions of ``ops.matrix``
    (``growing_window_counts``, ``fixed_window_counts`` and the batched
    ``counts_many``); matrices below ``_HOST_N`` rows are scanned on
    the host instead.  Both produce identical integer counts
    (tests/test_counts.py).

    ``mesh``: optional jax.sharding.Mesh — the rank matrix is then
    placed 2-D sharded over (data, model) and the SAME count kernels run
    partitioned by XLA: each device computes its row block's prefix
    memberships and the per-row reduction psums along the model axis
    (the SP row of SURVEY.md §2b, replacing the reference's O(N^2) scan
    scaffoldToChromosomes.py:449-469).  Counts are integer and therefore
    bit-identical sharded vs local (asserted in tests/test_multichip.py).
    """

    def __init__(self, rank_mat, mesh=None):
        self.n = rank_mat.shape[0]
        self._mesh = mesh
        self._host: Optional[np.ndarray] = None
        # (start,) / (start, cut) -> counts.  The cut-noise filter's
        # convergence rounds re-request the same windows many times.
        self._cache: Dict[tuple, np.ndarray] = {}
        # speculatively dispatched batches whose readback is deferred:
        # list of (keys, device_out) — materialized wholesale (one
        # transfer) when any of their keys is first consumed
        self._pending: List[tuple] = []
        if mesh is None and self.n < _HOST_N:
            self._host = np.asarray(rank_mat, dtype=np.int32)
            return
        if mesh is None:
            self._dev = jnp.asarray(rank_mat, dtype=jnp.int32)
            return
        import math

        import jax

        from hic_genome_assembler_tpu.parallel import mesh as pm

        # square pad to a multiple of lcm(data, model): the kernels'
        # row/col masks assume a square matrix.  Zero padding is
        # inert — pad COLUMNS are excluded by the prefix masks
        # (j < i - start with i < n), pad ROWS produce garbage
        # counts sliced off below.
        t = pm.pad_to_multiple(
            self.n,
            math.lcm(mesh.shape[pm.DATA_AXIS], mesh.shape[pm.MODEL_AXIS]),
        )
        if isinstance(rank_mat, np.ndarray):
            padded = np.zeros((t, t), dtype=np.int32)
            padded[: self.n, : self.n] = rank_mat
        else:
            # already on device (matrixMode=device): reshard without
            # a host round trip
            padded = jnp.pad(
                jnp.asarray(rank_mat, dtype=jnp.int32),
                ((0, t - self.n), (0, t - self.n)),
            )
        self._dev = jax.device_put(padded, pm.matrix_sharding(mesh))

    # -- batched dispatch plumbing ---------------------------------------

    def _dispatch_many(self, params: np.ndarray, mat=None):
        """One batched count dispatch for (start, cut, flag) rows
        (flag=1: growing scan, flag=0: fixed window); returns the
        un-read device array [Kp, >=n].  Counts are <= n, so for
        n < 65535 they are read back as uint16 (the cache converts to
        int32 on arrival).  ``mat`` optionally substitutes a
        column-sliced view of the rank matrix (sound for fixed windows,
        which never read past their width)."""
        from hic_genome_assembler_tpu.ops import matrix as dev

        out = dev.counts_many(self._dev if mat is None else mat, jnp.asarray(params))
        if self.n < 65000:
            out = _narrow_u16(out)
        return out

    def _in_pending(self, key: tuple) -> bool:
        return any(key in keys for keys, _out in self._pending)

    def _materialize_pending(self, key: tuple) -> bool:
        """If ``key`` sits in a pending batch, read back EVERY pending
        batch with one ``jax.device_get`` (speculative batches are tiny
        and usually all computed by now — one transfer beats one round
        trip per batch) and cache the rows."""
        if not any(key in keys for keys, _out in self._pending):
            return False
        import jax

        outs = jax.device_get([out for _keys, out in self._pending])
        for (keys, _out), rows in zip(self._pending, outs):
            for k2, row in zip(keys, rows[:, : self.n]):
                if k2 is not None and k2 not in self._cache:
                    self._cache[k2] = np.ascontiguousarray(row, dtype=np.int32)
        self._pending.clear()
        return True

    def prefetch_growing(self, starts: Sequence[int], limit: int = 16) -> None:
        """Speculatively dispatch growing scans for many starts in ONE
        device call, readback deferred.  The breakpoint pre-process
        consumes growing counts at data-dependent starts, but each
        scan's hit list predicts them (boundaries recur across scans) —
        so misses collapse from one blocking round trip per start to
        one per *novel hit list*."""
        if self._host is not None:
            return
        todo: List[int] = []
        for s in starts:
            s = int(s)
            if not (0 <= s < self.n):
                continue
            if (s,) in self._cache or self._in_pending((s,)) or s in todo:
                continue
            todo.append(s)
            if len(todo) >= limit:
                break
        if not todo:
            return
        K = len(todo)
        Kp = 1 << max(K - 1, 0).bit_length()
        params = np.zeros((Kp, 3), dtype=np.int32)
        params[:K, 0] = todo
        params[:K, 2] = 1
        params[K:] = params[K - 1]
        out = self._dispatch_many(params)
        keys = [(s,) for s in todo] + [None] * (Kp - K)
        self._pending.append((keys, out))

    def prefetch_fixed_pairs(self, pairs: Sequence[tuple], chunk: int = 2048) -> None:
        """Eagerly batch-load fixed counts for explicit (start, cut)
        pairs — the cut-noise filter's ENTIRE reachable working set
        ships as one dispatch + one readback per ``chunk`` instead of
        one blocking prefetch per convergence round."""
        missing = []
        seen = set()
        for s, c in pairs:
            k = (int(s), int(c))
            if k not in self._cache and not self._in_pending(k) and k not in seen:
                seen.add(k)
                missing.append(k)
        if not missing:
            return
        if self._host is not None:
            # host mode: per-call cost is already minimal and the lazy
            # path only computes windows actually consulted — eagerly
            # materializing the full speculative set here would do
            # thousands of O(n^2) host scans for nothing (batching only
            # amortizes DEVICE round trips)
            return
        # a fixed window (s, c) only reads columns < c - s, so group by
        # pow2 column need and dispatch on column-sliced views: neighbor
        # windows (the common case) touch a few thousand columns, not
        # the full matrix
        buckets: Dict[int, List[tuple]] = {}
        full_cols = int(self._dev.shape[1])
        for s, c in missing:
            need = max(c - s, 1)
            b = 1 << max(need - 1, 0).bit_length()
            b = max(b, 2048)
            if b >= full_cols or self._mesh is not None:
                # mesh: slicing the 2-D sharded matrix would insert a
                # reshard collective per bucket — dispatch full-width
                # (same guard as the per-call fixed() path)
                b = full_cols
            buckets.setdefault(b, []).append((s, c))
        for b, pairs_b in sorted(buckets.items()):
            mat = self._dev if b == full_cols else self._dev[:, :b]
            for ofs in range(0, len(pairs_b), chunk):
                blk = pairs_b[ofs : ofs + chunk]
                K = len(blk)
                Kp = 1 << max(K - 1, 0).bit_length()
                params = np.zeros((Kp, 3), dtype=np.int32)
                params[:K, 0] = [s for s, _c in blk]
                params[:K, 1] = [c for _s, c in blk]
                params[K:] = params[K - 1]
                rows = np.asarray(self._dispatch_many(params, mat=mat))[:K, : self.n]
                for k2, row in zip(blk, rows):
                    self._cache[k2] = np.ascontiguousarray(row, dtype=np.int32)

    def growing(self, start: int) -> np.ndarray:
        key = (int(start),)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if self._pending and self._materialize_pending(key):
            return self._cache[key]
        if self._host is not None:
            out = _host_growing_counts(self._host, int(start))
            self._cache[key] = out
            return out
        from hic_genome_assembler_tpu.ops import matrix as dev

        out = np.asarray(dev.growing_window_counts(self._dev, jnp.int32(start)))
        out = out[: self.n]
        self._cache[key] = out
        return out

    def fixed(self, start: int, cut: int) -> np.ndarray:
        key = (int(start), int(cut))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if self._pending and self._materialize_pending(key):
            return self._cache[key]
        if self._host is not None:
            out = _host_fixed_counts(self._host, int(start), int(cut))
            self._cache[key] = out
            return out
        # a fixed window (start, cut) only reads columns j < cut - start
        # (the prefix mask) — slice to the pow2 column bucket so the
        # kernel streams what the window needs, not the full matrix
        # (same trick as prefetch_fixed_pairs' batched path; identical
        # counts since sliced-off columns are masked to zero anyway).
        # The mesh path keeps the full sharded matrix: slicing a
        # sharded array would trigger a reshard collective per call.
        mat = self._dev
        if self._mesh is None:
            need = max(int(cut) - int(start), 1)
            b = 1 << max(need - 1, 0).bit_length()
            b = max(b, 2048)
            if b < int(self._dev.shape[1]):
                mat = self._dev[:, :b]
        from hic_genome_assembler_tpu.ops import matrix as dev

        out = np.asarray(
            dev.fixed_window_counts(mat, jnp.int32(start), jnp.int32(cut))
        )
        out = out[: self.n]
        self._cache[key] = out
        return out

    def prefetch_fixed(self, start: int, cuts: Sequence[int]) -> None:
        """Batch-load fixed counts for every (start, cut) not yet cached
        — ONE device dispatch instead of len(cuts) round trips (width-
        bucketed, see :meth:`prefetch_fixed_pairs`)."""
        self.prefetch_fixed_pairs([(int(start), int(c)) for c in cuts])


def find_matrix_pvalue_breakpoints(
    counts: RankCounts,
    start: int,
    min_size: int,
    world_size: int,
    psig: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Leftmost-breakpoint scan from ``start``
    (find_matrix_pvalue_breakpoints, scaffoldToChromosomes.py:413-511).

    Returns (cut strengths, cut indices relative to ``start``).
    """
    n = counts.n
    M = world_size
    ws = min_size
    break_sig = 0
    loop_count = 0
    row_counts = counts.growing(start)  # independent of M: compute once

    pre_cut_vals: np.ndarray = np.zeros(0)
    pre_cut_inds: np.ndarray = np.zeros(0, dtype=np.int64)
    while True:
        while True:
            rows = np.arange(start + 1, n)
            curr = rows - start
            sig = hypergeom.ge_significant(row_counts[rows], M, curr, curr, psig)
            # dist_sigs[0] = 0 sentinel, then one flag per row
            dist_sigs = np.concatenate([[0], sig.astype(np.int64)])
            loop_count += 1
            if dist_sigs.sum() / len(dist_sigs) >= 0.9:
                prev_M = M
                M = int(M - start)
                print(f"- M value (world_size) changed to dynamic {prev_M} --> {M}")
            else:
                break_sig = 1
            if break_sig == 1 or loop_count >= 5:
                break

        signals = sliding_window_break_signals(dist_sigs, ws)
        hits = np.nonzero(signals == min_size)[0]
        pre_cut_vals = signals[hits]
        pre_cut_inds = hits + min_size
        if len(pre_cut_inds) > 0:
            break
        prev_ws = ws
        ws -= 1
        if ws == 0:
            print(
                "- Warning - No cut index found after scanning through all "
                "window sizes between 1 and {}".format(min_size)
            )
            break
        print(
            "- Warning - No cut index found with window size of {}, "
            "decreasing by one to {}".format(prev_ws, ws)
        )
    return pre_cut_vals, pre_cut_inds


def pre_process_all_matrix_breakpoints(
    counts: RankCounts,
    min_size: int = 5,
    min_frac: float = 0.05,
    psig: float = 0.05,
) -> List[int]:
    """Aggressive leftmost-cut scan repeated from each new cut
    (pre_process_all_matrix_breakpoints, scaffoldToChromosomes.py:513-551).

    NOTE: the inner scan always runs at psig=.05 — the reference
    hardcodes it at :535, ignoring the configured value; ``psig`` is
    accepted for signature parity.
    """
    n = counts.n
    stop_ind = int(n - (n * min_frac))
    ind = 0
    cinds: List[int] = []
    if min_frac == 1:
        return cinds
    while True:
        _vals, inds = find_matrix_pvalue_breakpoints(counts, ind, min_size, n - ind, psig=0.05)
        if len(inds) == 0:
            break
        prev_ind = ind
        ind += int(inds[0])
        cinds.append(ind)
        # speculative prefetch: the scan's own hit list predicts the
        # upcoming scan starts (boundaries recur), so later growing()
        # calls are usually pending-batch hits instead of one blocking
        # device round trip each
        counts.prefetch_growing([prev_ind + int(h) for h in inds])
        print(ind, inds)
        if ind >= stop_ind or (n - ind) <= min_size:
            break
    print("- Breakpoints found {}".format(len(cinds)))
    return cinds


def filter_noisy_breakpoints(
    counts: RankCounts,
    original_inds: Sequence[int],
    psig: float = 0.05,
    max_global_rounds: int = 1000,
) -> List[int]:
    """Smooth an aggressive cut set to the most probable set
    (filter_noisy_breakpoints, scaffoldToChromosomes.py:553-727).

    Per cut c: device-counted rank memberships + row-level sf; then a
    second-level sf on significant-row counts between cut indices; merge
    cuts with significant cross-links keeping the rightmost; iterate to
    fixpoint.
    """
    if len(original_inds) == 0:
        return []
    n = counts.n
    MD = int(n / 5)
    MAX_ROUNDS = 10 * len(original_inds)

    altered = list(original_inds)
    # every fixed window the filter can request is (s, c) with s in
    # {0} U cuts and c a LATER cut (starts only jump to a rightmost-
    # significant cut; cut sets only shrink; each round consults cuts
    # in order and usually breaks within a few).  Prefetch each start's
    # next-_DEPTH neighbor windows in ONE dispatch; the rare deep sweep
    # (a round that consults past _DEPTH without breaking) bulk-loads
    # the rest mid-round below.  This replaces one blocking device
    # round trip per convergence round with one upfront batch.
    _DEPTH = 16
    _cuts = sorted(int(c) for c in altered)
    _pairs = [(0, c) for c in _cuts[:_DEPTH]]
    for si, s in enumerate(_cuts):
        _pairs += [(s, c) for c in _cuts[si : si + _DEPTH]]
    if len(_pairs) <= 4096:
        counts.prefetch_fixed_pairs(_pairs)
    prev_filtered: Dict[int, str] = {"__sentinel__": ""}  # never equal on round 1
    filtered: Dict[int, str] = {}
    # sig flags depend only on (start, c): M = n - start and
    # local_size = c - start derive from them, and counts.fixed is
    # cached — memoize across the convergence rounds, which re-walk
    # mostly the same (start, c) pairs every global round (the sf sweep
    # over n rows per consult was ~40% of filter wall at 11K)
    _sig_memo: Dict[tuple, np.ndarray] = {}

    def _sig_for(start: int, c: int) -> np.ndarray:
        k = (int(start), int(c))
        hit = _sig_memo.get(k)
        if hit is None:
            row_counts = counts.fixed(start, c)
            hit = _sig_memo[k] = hypergeom.ge_significant(
                row_counts, n - start, c - start, c - start, psig
            )
        return hit
    for _global_round in range(max_global_rounds):
        start = 0
        filtered = {}
        round_count = 0
        while True:
            if round_count >= MAX_ROUNDS:
                print(
                    "- WARNING - Maximum number of rounds {} exceeded... Data "
                    "appears to be extremely noisy or something went wrong".format(MAX_ROUNDS)
                )
                break
            M = n - start
            noise_found = 0
            select_from = None
            if any(
                (int(start), int(c)) not in counts._cache
                for c in altered[: _DEPTH]
            ):
                counts.prefetch_fixed(start, altered)
            for i, c in enumerate(altered):
                if i == _DEPTH and len(altered) > _DEPTH:
                    # deep sweep: this round is consulting past the
                    # speculated neighbor window — bulk-load the rest
                    counts.prefetch_fixed(start, altered)
                local_size = c - start
                # row significance flags for this (start, c) window
                # (M == n - start and local_size derive from (start, c),
                # so the memoized sweep is exact)
                rows = np.arange(n)
                sig = _sig_for(start, c)
                sig_flags = np.where(
                    (rows - start) > MD, 0, sig.astype(np.int64)
                )

                right_most = None
                right_most_ind = None
                sigs = []
                fc_prev = start
                for ai_ind, ai in enumerate(altered):
                    ps = sig_flags[fc_prev:ai]
                    if ai == fc_prev:
                        continue
                    fc_prev = ai
                    if len(ps) == 0:
                        break
                    x = int(ps.sum())
                    noise_pval = float(hyper_geom_sf(x, M, local_size, len(ps)))
                    if noise_pval < psig:
                        right_most = ai
                        right_most_ind = ai_ind
                        sigs.append([ai, [x, M, local_size, len(ps), noise_pval]])
                if sigs:
                    start = right_most
                    filtered[right_most] = ""
                    noise_found = 1
                    select_from = right_most_ind
                    print("- Right most sig pvalue coordinate found {}".format(right_most))
                    break
                else:
                    filtered[c] = ""
                    select_from = i
            round_count += 1
            if noise_found == 0:
                print("- Exiting algorithm... No significant connections found between current inds")
                break
            altered = altered[select_from:]
        if prev_filtered == filtered:
            print(
                "- Algorithm appears to have converged as previous cutindices "
                "match current cutindices. Exiting..."
            )
            break
        altered = sorted(filtered)
        prev_filtered = filtered
    return_inds = sorted(filtered)
    print("- Original cut indices {}".format(list(original_inds)))
    print("- Filtered cut indices {}".format(return_inds))
    return return_inds
