"""Device scoring engine for the distance-weighted contact cost.

The reference scores one candidate arrangement at a time with a numba
kernel over the permuted C x C matrix (orderGenome.py:184-193,
bruteForceBestScore :432-473): cost = sum_{i=1}^{C-1} (sum_{j<=i}
trace(M_P, j)) / total / i.  Swapping the summation order gives

    cost(P) = sum_{k<l} M[o_k, o_l] * w(l - k),
    w(d)    = H_d / total,   H_d = sum_{i=d}^{C-1} 1/i,

i.e. a fixed harmonic weight profile contracted against the permuted
matrix.  ``ChromosomeScorer`` exploits this with a scaffold-block
factorization: every scaffold pair's contribution depends only on
(pair, orientations, start-offset delta), so one device pass over the
C x C submatrix precomputes a lookup table F[pair, orient, delta] and
every candidate — brute force (``SubsetScorer.score_batch_topk``),
greedy insertion and sliding-window refinement
(``SubsetScorer.score_pairs``) — scores in O(S^2) table gathers instead
of O(C^2), a ~C^2/S^2 algorithmic speedup over the reference kernel
before any parallelism.

Decision exactness: device scoring runs in fast (f32) precision;
``argmax_reference_ties`` re-scores the top-k candidates on host in
float64 with the reference's exact summation order
(ops.oracle.cost_function) and applies the reference's tie rule (strict
``>`` update == earliest candidate wins).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hic_genome_assembler_tpu.ops import oracle


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def harmonic_weights(C: int, total: float) -> np.ndarray:
    """w[d] = (sum_{i=d}^{C-1} 1/i) / total for d in 1..C-1; w[0] = 0."""
    w = np.zeros(max(C, 1), dtype=np.float64)
    if C > 1 and total != 0.0:
        inv = 1.0 / np.arange(1, C, dtype=np.float64)
        w[1:] = np.cumsum(inv[::-1])[::-1] / total
    return w


def upper_triangle_total(matrix: np.ndarray) -> float:
    iu = np.triu_indices(matrix.shape[0], k=1)
    return float(matrix[iu].sum())


def bin_order_of_block(
    order: Sequence[int], orient: Sequence[int], sizes: Sequence[int]
) -> np.ndarray:
    """Scaffold-level (order, orient) -> canonical bin-index order.

    Canonical layout: scaffold k occupies bins [offset_k, offset_k +
    sizes[k]) in 5'->3' direction; orientation 1 ("-") reverses its
    bins (Scaffold.flipOrientation, orderGenome.py:246-254).
    """
    sizes = np.asarray(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    chunks = []
    for s, e in zip(order, orient):
        bins = np.arange(offsets[s], offsets[s] + sizes[s])
        chunks.append(bins[::-1] if e else bins)
    return np.concatenate(chunks).astype(np.int32)


# ---------------------------------------------------------------------------
# Block (scaffold-pair table) scorer
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("S", "k"))
def _skew_profile_chunk(m_pad, blk_idx, sizes_s, chunk_start, S, k):
    """Pair profiles for scaffold rows [chunk_start, chunk_start + k).

    Scatter-free: the scatter-add (``_build_pair_profiles``) serializes
    on duplicate indices; everything in this path is bandwidth-shaped
    instead.

    1. ``G[s, t, a, b] = M[offs_s + a, offs_t + b]`` — a padded block
       view built with one static-index gather (``m_pad`` carries a zero
       guard row/col for the a >= c_s pad region).
    2. All four orientation profiles are (anti)diagonal sums of the G
       planes: e in {0,3} need ``Ddiff[v] = sum_{b-a+cmax-1=v}``, e in
       {1,2} need ``Dsum[u] = sum_{a+b=u}``.  Both come from ONE skew
       primitive (pad each plane row by cmax, flat-reshape so row a
       lands shifted by a, reduce over a) — pure reshapes + a sum;
       Ddiff is the skew of the a-reversed plane.
    3. Per-(s, t) constant shifts/flips place each (e, m) entry from the
       stacked [Dsum, Ddiff] profiles; index maps are computed on device
       from the sizes vector (guard slot L = zero):

        e=0 (+,+): m = (b - a) + shift          -> Ddiff[m]
        e=1 (+,-): m = (ct-1 - (a+b)) + shift   -> Dsum[ct-1+shift-m]
        e=2 (-,+): m = (a+b) - cs + 1 + shift   -> Dsum[m+cs-1-shift]
        e=3 (-,-): m = (ct-cs) - (b-a) + shift  -> Ddiff[(ct-cs)+2*shift-m]

    (offset formulas per Scaffold.flipOrientation semantics,
    orderGenome.py:246-254).  Chunking over s rows bounds the G
    transient to k * cmax * S * cmax floats regardless of scaffold
    count.  Returns h4 [k, S, 4, L].
    """
    c = blk_idx.shape[1]
    L = 2 * c - 1
    shift = c - 1
    rows = jax.lax.dynamic_slice_in_dim(blk_idx, chunk_start, k, axis=0)
    G = m_pad[rows.reshape(-1)][:, blk_idx.reshape(-1)]
    G = G.reshape(k, c, S, c).transpose(0, 2, 1, 3)        # [k, S, c, c]

    def antidiag(planes):
        # out[..., u] = sum_a planes[..., a, u - a]
        padded = jnp.pad(planes, ((0, 0), (0, 0), (0, 0), (0, c)))
        flat = padded.reshape(k, S, c * 2 * c)[..., : c * L]
        return flat.reshape(k, S, c, L).sum(axis=2)

    Dsum = antidiag(G)
    Ddiff = antidiag(G[:, :, ::-1, :])
    # [k, S, 2, L+1] profiles with guard zero at index L
    prof = jnp.stack([Dsum, Ddiff], axis=2)
    prof = jnp.pad(prof, ((0, 0), (0, 0), (0, 0), (0, 1)))
    m = jnp.arange(L)
    cs = jax.lax.dynamic_slice_in_dim(sizes_s, chunk_start, k)[:, None, None]
    ct = sizes_s[None, :, None]                            # [1, S, 1]
    pos = jnp.stack(
        [
            jnp.broadcast_to(m, (k, S, L)),                          # e=0 -> Ddiff
            jnp.broadcast_to(ct - 1 + shift - m, (k, S, L)),         # e=1 -> Dsum
            jnp.broadcast_to(m + cs - 1 - shift, (k, S, L)),         # e=2 -> Dsum
            jnp.broadcast_to((ct - cs) + 2 * shift - m, (k, S, L)),  # e=3 -> Ddiff
        ],
        axis=2,
    )                                                      # [k, S, 4, L]
    pos = jnp.where((pos >= 0) & (pos < L), pos, L)
    which = jnp.array([1, 0, 0, 1])[None, None, :, None]
    flat_prof = prof.reshape(k, S, 2 * (L + 1))
    h4 = jnp.take_along_axis(
        flat_prof[:, :, None, :], which * (L + 1) + pos, axis=3
    )                                                      # [k, S, 4, L]
    s_ids = chunk_start + jnp.arange(k)
    eye = s_ids[:, None] == jnp.arange(S)[None, :]
    return jnp.where(eye[:, :, None, None], 0.0, h4)


# transient G budget per chunk: k * cmax * S * cmax floats <= 64M (256MB)
_SKEW_CHUNK_ELEMS = 64 * 1024 * 1024


@functools.partial(jax.jit, static_argnames=("Sp", "L", "cmax"))
def _build_pair_profiles(sub, sid, loc, sizes, Sp, L, cmax):
    """Device-side pair-profile build: one scatter-add.

    h[row, m] accumulates every cross-scaffold matrix entry at its
    orientation-specific offset, row = (s * Sp + t) * 4 + e.  ``Sp`` is
    the id-space stride (>= number of real scaffolds; extra ids are
    zero-size padding slots whose rows stay zero).  h depends only on
    the matrix and scaffold layout — NOT on the harmonic weights — so it
    is built once per chromosome and reweighted per scaffold subset
    (``_profiles_to_table``).
    """
    s, t = sid[:, None], sid[None, :]
    a, b = loc[:, None], loc[None, :]
    cs, ct = sizes[sid][:, None], sizes[sid][None, :]
    base = (s * Sp + t) * 4
    shift = cmax - 1
    vals = jnp.where(s != t, sub, 0.0).ravel()
    nrows = 4 * Sp * Sp
    h = jnp.zeros(nrows * L, dtype=sub.dtype)
    for e, mm in enumerate(
        (
            (b - a) + shift,                 # e=0: (+,+)
            (ct - 1 - (a + b)) + shift,      # e=1: (+,-)
            ((a + b) - cs + 1) + shift,      # e=2: (-,+)
            ((ct - cs) - (b - a)) + shift,   # e=3: (-,-)
        )
    ):
        idx = ((base + e) * L + jnp.clip(mm, 0, L - 1)).ravel()
        h = h.at[idx].add(vals)
    return h.reshape(nrows, L)


@functools.partial(jax.jit, static_argnames=("shift", "C"))
def _profiles_to_table(h, wpad, shift, C):
    """F[row, delta] = sum_m h[row, m] * w(delta + m - shift) — one
    matmul; re-run per scaffold subset with that subset's weights."""
    L = h.shape[1]
    # Wm[m, delta] = wpad[delta + m - shift] (0 outside [1, C-1])
    darg = jnp.arange(C + 1)[None, :] + (jnp.arange(L) - shift)[:, None]
    Wm = jnp.where((darg >= 1) & (darg <= C - 1), wpad[jnp.clip(darg, 0, C)], 0.0)
    return jnp.dot(h, Wm, preferred_element_type=h.dtype,
                   precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("Cp1",))
def _block_score_kernel(
    F_flat: jnp.ndarray,
    sizes: jnp.ndarray,
    orders: jnp.ndarray,   # [Bo, S]
    e_onehot: jnp.ndarray, # [P*4, R] one-hot orientation selectors
    pi: jnp.ndarray,       # [P]
    pj: jnp.ndarray,       # [P]
    c0: jnp.ndarray,
    Cp1: int,
) -> jnp.ndarray:
    """Scores all R orientation combos of each order with P*4 gathers per
    order + one matmul: the 4 orientation variants of every pair's
    table entry are fetched once and combined across combos by the
    precomputed one-hot selector matrix (64x fewer gathers than the
    naive [Bo, R, P] gather)."""
    Sp = sizes.shape[0]  # id-space stride of the F table (incl. pad slots)
    Bo, P = orders.shape[0], pi.shape[0]
    sz = sizes[orders]
    offs = jnp.cumsum(sz, axis=1) - sz
    s_i, s_j = orders[:, pi], orders[:, pj]              # [Bo, P]
    delta = offs[:, pj] - offs[:, pi]                    # [Bo, P]
    pair_base = (s_i * Sp + s_j) * 4                     # [Bo, P]
    idx = (pair_base[:, :, None] + jnp.arange(4, dtype=orders.dtype)) * Cp1 \
        + delta[:, :, None]                              # [Bo, P, 4]
    f_vals = F_flat[idx].reshape(Bo, P * 4)
    return jnp.dot(f_vals, e_onehot, preferred_element_type=f_vals.dtype,
                   precision=jax.lax.Precision.HIGHEST) + c0


@functools.partial(jax.jit, static_argnames=("Cp1", "k"))
def _block_score_topk_kernel(F_flat, sizes, orders, e_onehot, pi, pj, c0, Cp1, k):
    """Block scores + on-device candidate selection: only 2k scalars
    leave the chip.

    Selection is a group-argmax over k contiguous index groups rather
    than lax.top_k (whose fused sort compiles far slower at this size
    than plain reductions).  Guarantees: the global maximum
    is always returned (it is its own group's max), exact ties in OTHER
    groups are returned, and within a group argmax takes the lowest
    index — matching the reference's first-strictly-greater update.
    Near-ties inside the winner's group can be dropped; the host f64
    re-scoring set is k candidates wide to absorb fast-precision noise.
    """
    costs = _block_score_kernel(F_flat, sizes, orders, e_onehot, pi, pj, c0, Cp1)
    return _group_argmax(costs.ravel(), k)


def _group_argmax(flat: jnp.ndarray, k: int):
    """Per-group (max, argmax, second-max).

    The second-max vector is the escalation witness: every candidate the
    selection DROPS inside group g has a fast score < second[g], so
    ``max(second)`` is a hard upper bound on any dropped candidate's
    fast score.  The host decision rule escalates to full scoring only
    when that bound could still beat the exact winner (see
    ``argmax_reference_ties_sparse``)."""
    n = flat.shape[0]
    pad = (-n) % k
    if pad:
        flat = jnp.concatenate([flat, jnp.full((pad,), -jnp.inf, flat.dtype)])
    groups = flat.reshape(k, -1)
    vals = jnp.max(groups, axis=1)
    local = jnp.argmax(groups, axis=1).astype(jnp.int32)
    idx = jnp.arange(k, dtype=jnp.int32) * groups.shape[1] + local
    winner_mask = jnp.arange(groups.shape[1], dtype=jnp.int32)[None, :] == local[:, None]
    second = jnp.max(jnp.where(winner_mask, -jnp.inf, groups), axis=1)
    return vals, idx, second


# ---------------------------------------------------------------------------
# Combo-factorized brute-force scoring
#
# For a fixed enumeration batch (all n!/2 orders over one value set), the
# F-table cell a candidate pair needs depends only on the "combo"
# (s_i, s_j, set-of-scaffolds-between): delta = size(s_i) + sum(sizes of
# the between-set).  There are only n^2 * 2^(n-2) combos (3584 at n=8)
# versus Bo*P*4 = 2.26M per-candidate gathers from the big F table, and
# the candidate->combo map ``cid`` is PURE COMBINATORICS — computed once
# per n and cached for the whole process (every chromosome reuses it).
# Scoring then = one tiny F gather (n_combo x 4) + a small-table gather
# + one einsum.
# ---------------------------------------------------------------------------

_COMBO_CACHE: dict = {}
_ONEHOT_CACHE: dict = {}
_TRIU_CACHE: dict = {}


def _triu_cache(c: int):
    hit = _TRIU_CACHE.get(c)
    if hit is None:
        hit = _TRIU_CACHE[c] = np.triu_indices(c, k=1)
    return hit


def _orient_onehot(S: int, orients: np.ndarray, dtype) -> np.ndarray:
    """Per-position-pair orientation selector: one-hot[(p*4 + e), r] with
    e = orients[r, pi]*2 + orients[r, pj].  Cached — the orientation
    enumeration batch is identical across chromosomes."""
    key = (S, orients.tobytes(), dtype.str)
    hit = _ONEHOT_CACHE.get(key)
    if hit is not None:
        return hit
    pi, pj = np.triu_indices(S, k=1)
    P = len(pi)
    R = orients.shape[0]
    e_pair = (orients[:, pi] * 2 + orients[:, pj]).astype(np.int64)  # [R, P]
    e_onehot = np.zeros((P * 4, R), dtype=dtype)
    rows = (np.arange(P)[None, :] * 4 + e_pair).ravel()
    cols = np.repeat(np.arange(R), P)
    e_onehot[rows, cols] = 1.0
    _ONEHOT_CACHE[key] = e_onehot
    return e_onehot


def _combo_index(orders: np.ndarray) -> dict:
    """Candidate->combo map for an enumeration batch whose rows all
    permute the same value set (order_batch output).  Cached by batch
    bytes.  Combo encoding over value RANKS: c = (ri*n + rj)*2^(n-2) +
    mask, where mask bit b set <=> the b-th remaining rank (ascending,
    excluding ri and rj) lies strictly between positions of s_i, s_j."""
    key = (orders.shape, orders.tobytes())
    hit = _COMBO_CACHE.get(key)
    if hit is not None:
        return hit
    Bo, S = orders.shape
    values = np.sort(np.unique(orders[0]))
    assert len(values) == S, "combo path needs distinct per-row values"
    rank_of = np.full(int(values.max()) + 1, -1, dtype=np.int64)
    rank_of[values] = np.arange(S)
    r_ord = rank_of[orders]                                  # [Bo, S] ranks
    pi, pj = np.triu_indices(S, k=1)
    P = len(pi)
    nbits = max(S - 2, 0)
    # bit position of rank k among "others of (ri, rj)" = k - (k>ri) - (k>rj)
    ri = r_ord[:, pi]                                        # [Bo, P]
    rj = r_ord[:, pj]
    mask = np.zeros((Bo, P), dtype=np.int64)
    for q in range(1, S - 1):                                # between offsets
        between = np.zeros((Bo, P), dtype=bool)
        rq = np.zeros((Bo, P), dtype=np.int64)
        for p, (a, b) in enumerate(zip(pi, pj)):
            sel = a + q < b
            if not sel:
                continue
            col = r_ord[:, a + q]
            rq[:, p] = col
            between[:, p] = True
        bitpos = rq - (rq > ri) - (rq > rj)
        mask |= np.where(between, 1 << bitpos, 0)
    cid = ((ri * S + rj) << nbits) + mask                    # [Bo, P]
    n_combo = (S * S) << nbits
    # decode tables for the combo -> (row, delta) map
    c = np.arange(n_combo, dtype=np.int64)
    si_r = (c >> nbits) // S
    sj_r = (c >> nbits) % S
    bits = (c[:, None] >> np.arange(nbits)[None, :]) & 1     # [n_combo, nbits]
    # others_rank[ri, rj, b] = b-th ascending rank excluding ri, rj
    others = np.zeros((S, S, nbits), dtype=np.int64)
    for a in range(S):
        for b in range(S):
            rest = [k for k in range(S) if k != a and k != b]
            rest = (rest + [0] * nbits)[:nbits]
            others[a, b] = rest
    out = {
        "values": values,
        "cid": cid.astype(np.int32),
        "si_r": si_r,
        "sj_r": sj_r,
        "bits": bits,
        "others_r": others[si_r, sj_r],                      # [n_combo, nbits]
        "n_combo": n_combo,
        "valid": si_r != sj_r,
    }
    _COMBO_CACHE[key] = out
    return out


@jax.jit
def _combo_score_kernel(F_flat, idx4, cid, E, c0):
    """V4 = F[idx4] (tiny), vals = V4[cid] (a ~64 KB table), one
    einsum folds the 4 orientation variants against the per-position
    orientation selector E[P, 4, R]."""
    V4 = F_flat[idx4]                                        # [n_combo, 4]
    vals = V4[cid]                                           # [Bo, P, 4]
    return (
        jnp.einsum("bpe,per->br", vals, E, preferred_element_type=vals.dtype,
                   precision=jax.lax.Precision.HIGHEST)
        + c0
    )


@functools.partial(jax.jit, static_argnames=("k",))
def _combo_score_topk_kernel(F_flat, idx4, cid, E, c0, k):
    costs = _combo_score_kernel(F_flat, idx4, cid, E, c0)
    return _group_argmax(costs.ravel(), k)


@functools.partial(jax.jit, static_argnames=("Cp1",))
def _pair_score_kernel(F_flat, sizes, orders, orients, pi, pj, c0, Cp1):
    """Per-candidate (order, orientation) scoring: orders and orients
    are both [B, W] (unlike the cross-product kernel, each candidate
    carries its own orientation vector).  Used by greedy insertion,
    where slot and orientation are coupled.  Pad slots (id with size 0)
    contribute zero rows of F and zero size, so a single executable
    serves every greedy step."""
    Sp = sizes.shape[0]
    sz = sizes[orders]
    offs = jnp.cumsum(sz, axis=1) - sz
    s_i, s_j = orders[:, pi], orders[:, pj]              # [B, P]
    e = orients[:, pi] * 2 + orients[:, pj]              # [B, P]
    delta = offs[:, pj] - offs[:, pi]
    idx = ((s_i * Sp + s_j) * 4 + e) * Cp1 + delta
    return jnp.sum(F_flat[idx], axis=1) + c0


class ChromosomeScorer:
    """Once-per-chromosome pair-profile factorization.

    Builds the orientation-resolved scaffold-pair diagonal profiles
    h[(s*Sp+t)*4+e, m] on device with ONE scatter over the C x C
    chromosome submatrix (canonical layout: scaffolds size-descending,
    bins ascending within each scaffold).  Every search stage — brute
    force (orderGenome.py:432-473), greedy insertion (:475-493) and
    sliding-window refinement (:495-549) — scores scaffold-level
    candidates from the same h via a per-SUBSET harmonic reweighting
    (``subset()``): the cost normalizer ``total`` and weight profile
    w(d) depend on which scaffolds are in play, but h does not.

    This replaces the reference's O(C^2)-per-candidate numba kernel with
    O(S^2) table gathers per candidate plus one (4*Sp^2, L) @ (L, C+1)
    matmul per subset.
    """

    def __init__(
        self,
        sub_matrix: np.ndarray,
        sizes: Sequence[int],
        dtype=np.float32,
        mesh=None,
        device_sub: Optional[jax.Array] = None,
    ):
        """``mesh``: optional jax.sharding.Mesh — candidate batches are
        then sharded over its data axis (DP) with the table replicated,
        and XLA partitions the gather+reduction across chips.

        ``device_sub``: optional device-resident fast-dtype copy of
        ``sub_matrix`` (e.g. sliced on device from the genome matrix by
        the part-2 driver).  Providing it skips the host->device matrix
        transfer;
        ``sub_matrix`` is still required for the f64 exact bookkeeping
        (totals, c0, host re-scoring)."""
        self._mesh = mesh
        self._dtype = dtype
        sub = np.asarray(sub_matrix, dtype=np.float64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.S = len(self.sizes)
        self.C = int(self.sizes.sum())
        assert sub.shape == (self.C, self.C), (sub.shape, self.C)
        self._sub = sub

        # Shape bucketing: every jitted kernel's executable is keyed on
        # (Sp, L, C) shapes, and a real genome has ~25 chromosomes with
        # ~25 DISTINCT (scaffold count, bin count, largest scaffold)
        # triples — unbucketed, each chromosome pays its own 10-40s XLA
        # compiles, dominating end-to-end wall.  Rounding the id-space
        # stride, offset width and table width up to coarse buckets
        # (pad ids have size 0, pad bins are zero rows) collapses them
        # into a handful of executables; scores are unchanged.
        cmax = int(self.sizes.max())
        # smallest bucket = 9 (covers every brute-force-only chromosome,
        # S <= 8); larger strides round to multiples of 8
        self.Sp = 9 if self.S + 1 <= 9 else _round_up(self.S + 1, 8)
        self.cmax = _round_up(cmax, 64)
        self.L = 2 * self.cmax - 1
        self.C_pad = _round_up(self.C, 256)     # table/delta width

        sid = np.full(self.C_pad, self.S, dtype=np.int32)  # pad bins -> slot S
        sid[: self.C] = np.repeat(np.arange(self.S), self.sizes)
        loc = np.zeros(self.C_pad, dtype=np.int32)
        loc[: self.C] = np.concatenate([np.arange(c) for c in self.sizes])
        self._sid = sid

        # Host-side f64 exact bookkeeping (all O(C^2), computed once):
        # per-scaffold internal diagonal profiles (for c0), internal
        # totals and pairwise cross totals (for each subset's ``total``).
        offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        self.intra_profile = np.zeros((self.S, max(cmax, 1)), dtype=np.float64)
        self.intra_total = np.zeros(self.S, dtype=np.float64)
        for s, (o, c) in enumerate(zip(offsets, self.sizes)):
            block = sub[o : o + c, o : o + c]
            if c > 1:
                rows, cols = _triu_cache(c)
                self.intra_profile[s, : max(c, 1)] = np.bincount(
                    cols - rows, weights=block[rows, cols], minlength=c
                )[:max(c, 1)]
            self.intra_total[s] = self.intra_profile[s].sum()
        # cross_total[s, t] = sum of the (s, t) block — two f64 BLAS
        # matmuls with the scaffold one-hot (O(C^2 S), milliseconds)
        # instead of strided reduceat passes over the full matrix.
        G = np.zeros((self.C, self.S), dtype=np.float64)
        G[np.arange(self.C), sid[: self.C]] = 1.0
        self.cross_total = G.T @ (sub @ G)

        if device_sub is None:
            device_sub = jnp.asarray(sub.astype(dtype))
        pad_c = self.C_pad - self.C
        sizes_padded = np.zeros(self.Sp, dtype=np.int32)
        sizes_padded[: self.S] = self.sizes
        k = _SKEW_CHUNK_ELEMS // max(self.cmax * self.Sp * self.cmax, 1)
        if k >= 1:
            k = min(k, self.Sp)
            m_pad = jnp.pad(device_sub.astype(dtype), ((0, pad_c + 1), (0, pad_c + 1)))
            blk_idx = np.full((self.Sp, self.cmax), self.C_pad, dtype=np.int32)
            for s, (o, c) in enumerate(zip(offsets, self.sizes)):
                blk_idx[s, :c] = np.arange(o, o + c)
            blk_d = jnp.asarray(blk_idx)
            sizes_d32 = jnp.asarray(sizes_padded)
            chunks = []
            for start in range(0, self.Sp - self.Sp % k, k):
                chunks.append(
                    _skew_profile_chunk(m_pad, blk_d, sizes_d32, start, self.Sp, k)
                )
            rem = self.Sp % k
            if rem:
                chunks.append(
                    _skew_profile_chunk(
                        m_pad, blk_d, sizes_d32, self.Sp - rem, self.Sp, rem
                    )
                )
            h4 = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, axis=0)
            self._h = h4.reshape(self.Sp * self.Sp * 4, self.L)
        else:
            # degenerate scale (cmax^2 * Sp alone exceeds the transient
            # budget): scatter-add fallback
            sub_dev = device_sub.astype(dtype)
            if pad_c:
                sub_dev = jnp.pad(sub_dev, ((0, pad_c), (0, pad_c)))
            self._h = _build_pair_profiles(
                sub_dev,
                jnp.asarray(sid),
                jnp.asarray(loc),
                jnp.asarray(sizes_padded),
                self.Sp,
                self.L,
                self.cmax,
            )
        self._sizes_d = jnp.asarray(sizes_padded)

    @property
    def pad_id(self) -> int:
        """Scaffold id usable as padding in fixed-width candidate
        arrays; contributes zero size and zero cost."""
        return self.S

    @property
    def cand_width(self) -> int:
        """Bucketed candidate width for fixed-shape search batches
        (pad columns carry pad_id); keeps greedy/sliding-window
        executables shared across chromosomes."""
        return _round_up(max(self.S, 1), 8)

    def subset(self, include: Sequence[int]) -> "SubsetScorer":
        """Scorer for candidates drawn from ``include`` (global ids)."""
        return SubsetScorer(self, list(include))

    def full(self) -> "SubsetScorer":
        return self.subset(range(self.S))


class SubsetScorer:
    """Scoring view over a scaffold subset: fixed ``total``, w profile,
    reweighted F table and intra-scaffold constant c0.

    Exposes the cross-product batch API (orders x orientation combos —
    brute force, sliding window), the per-candidate-pair API (greedy
    insertion) and the reference-exact f64 host re-scorer.
    """

    def __init__(self, parent: ChromosomeScorer, include: List[int]):
        self.parent = parent
        self.include = include
        self._mesh = parent._mesh
        self.sizes = parent.sizes
        self.S = parent.S
        self.C = parent.C_pad  # delta/table width (bucketed, >= real C)
        self.C_sub = int(parent.sizes[include].sum())
        inc = np.asarray(include)
        iu = np.triu_indices(len(inc), k=1)
        self.total = float(parent.intra_total[inc].sum()) + float(
            parent.cross_total[inc[iu[0]], inc[iu[1]]].sum()
        )
        self.degenerate = self.total == 0.0
        self.w = harmonic_weights(self.C_sub, self.total)
        if not self.degenerate:
            profile = parent.intra_profile[inc].sum(axis=0)
            wlen = min(len(profile), len(self.w))
            self.c0 = float(profile[:wlen] @ self.w[:wlen])
        else:
            self.c0 = 0.0
        self._host_memo: dict = {}
        wpad = np.zeros(self.C + 1, dtype=np.float64)
        wpad[1 : self.C_sub] = self.w[1 : self.C_sub]
        F = _profiles_to_table(
            parent._h,
            jnp.asarray(wpad.astype(parent._dtype)),
            parent.cmax - 1,
            self.C,
        )
        self._F_flat = F.reshape(-1)
        self._sizes_d = parent._sizes_d

    def score_batch(
        self, orders: np.ndarray, orients: np.ndarray, chunk_orders: int = 2048
    ) -> np.ndarray:
        """Costs for the full (order x orientation) grid.

        Returns float[Bo * R] in candidate order (order-major,
        orientation-fastest — the reference's nested loop,
        orderGenome.py:457-458).
        """
        Bo, S = orders.shape
        R = orients.shape[0]
        if self.degenerate:
            return np.zeros(Bo * R, dtype=np.float64)
        pi, pj = np.triu_indices(S, k=1)
        e_onehot = _orient_onehot(S, orients, np.dtype(self._F_flat.dtype))
        out = np.empty((Bo, R), dtype=np.float64)
        pi_d, pj_d = jnp.asarray(pi.astype(np.int32)), jnp.asarray(pj.astype(np.int32))
        e_d = jnp.asarray(e_onehot)
        c0_d = jnp.asarray(self.c0, dtype=self._F_flat.dtype)
        handles = []
        meta = []
        for ofs in range(0, Bo, chunk_orders):
            chunk = orders[ofs : ofs + chunk_orders].astype(np.int32)
            n_real = chunk.shape[0]
            if n_real < chunk_orders and Bo > chunk_orders:
                # pad the ragged tail to the steady-state shape so every
                # chunk hits the same compiled executable
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], chunk_orders - n_real, axis=0)]
                )
            chunk_d = self._put_batch(chunk)
            handles.append(
                _block_score_kernel(
                    self._F_flat, self._sizes_d, chunk_d, e_d, pi_d, pj_d,
                    c0_d, self.C + 1,
                )
            )
            meta.append((ofs, n_real))
        # all chunks dispatched async; ONE transfer drains them (a
        # blocking read per chunk costs a host round trip per chunk)
        for scored, (ofs, n_real) in zip(jax.device_get(handles), meta):
            out[ofs : ofs + n_real] = scored[:n_real]
        return out.reshape(-1)

    def score_batch_topk(
        self,
        orders: np.ndarray,
        orients: np.ndarray,
        k: int = 64,
        chunk_orders: int = 20160,
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Top-k candidates without materializing all costs on host.

        Returns (global candidate indices, fast-precision costs, floor):
        indices/costs are length <= k, unordered beyond being the
        per-chunk top-k merge, and ``floor`` is a hard upper bound on
        the fast score of every candidate NOT returned (from the
        on-device per-group second-max plus any merge truncation) — the
        escalation witness for ``argmax_reference_ties_sparse``.
        Global index = order_idx * R + orient_idx (reference enumeration
        order).  The full-cost path (``score_batch``) moves Bo*R floats
        to the host; this moves 3k per chunk.
        """
        handles, finish = self.score_batch_topk_async(
            orders, orients, k=k, chunk_orders=chunk_orders
        )
        return finish([np.asarray(h) for h in handles])

    def score_batch_topk_async(
        self,
        orders: np.ndarray,
        orients: np.ndarray,
        k: int = 64,
        chunk_orders: int = 20160,
    ):
        """Dispatch-only form of :meth:`score_batch_topk` for the
        interleaved multi-chromosome scheduler (part2_order): returns
        ``(handles, finish)`` where ``handles`` is a tuple of device
        arrays (already dispatched, nothing read back) and
        ``finish(host_arrays)`` — given ``[np.asarray(h) for h in
        handles]`` — produces the (indices, values) result.  The caller
        overlaps the readback with other chromosomes' work."""
        Bo, S = orders.shape
        R = orients.shape[0]
        if self.degenerate:
            m = min(k, Bo * R)
            return (), lambda host: (np.arange(m), np.zeros(m), -np.inf)
        pi, pj = np.triu_indices(S, k=1)
        e_onehot = _orient_onehot(S, orients, np.dtype(self._F_flat.dtype))
        if 2 <= S <= 8 and len(np.unique(orders[0])) == S:
            return self._score_topk_combo_async(orders, orients, e_onehot, k)
        pi_d, pj_d = jnp.asarray(pi.astype(np.int32)), jnp.asarray(pj.astype(np.int32))
        e_d = jnp.asarray(e_onehot)
        c0_d = jnp.asarray(self.c0, dtype=self._F_flat.dtype)
        handles: List[jax.Array] = []
        meta: List[Tuple[int, int, int]] = []  # (ofs, n_real, kk)
        for ofs in range(0, Bo, chunk_orders):
            chunk = orders[ofs : ofs + chunk_orders].astype(np.int32)
            n_real = chunk.shape[0]
            if n_real < chunk_orders and Bo > chunk_orders:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], chunk_orders - n_real, axis=0)]
                )
            vals, idx, second = _block_score_topk_kernel(
                self._F_flat, self._sizes_d, self._put_batch(chunk), e_d,
                pi_d, pj_d, c0_d, self.C + 1, min(k, chunk.shape[0] * R),
            )
            handles.extend((vals, idx, second))
            meta.append((ofs, n_real, min(k, n_real * R)))

        def finish(host):
            all_idx: List[np.ndarray] = []
            all_vals: List[np.ndarray] = []
            floor = -np.inf  # upper bound on any candidate NOT returned
            for h, (ofs, n_real, kk) in zip(range(0, len(host), 3), meta):
                vals, idx, second = host[h], host[h + 1], host[h + 2]
                keep = idx < n_real * R  # drop padding rows
                all_idx.append(idx[keep][:kk] + ofs * R)
                all_vals.append(vals[keep][:kk])
                # dropped in-group candidates score < their group's second
                # max; pad-winner groups duplicate a real candidate whose
                # score may not be in the kept set — bound it by the val
                sec = second[np.isfinite(second)]
                if sec.size:
                    floor = max(floor, float(sec.max()))
                if (~keep).any():
                    floor = max(floor, float(vals[~keep].max()))
            idx = np.concatenate(all_idx)
            vals = np.concatenate(all_vals)
            if len(idx) > k:
                top = np.argsort(-vals, kind="stable")
                floor = max(floor, float(vals[top[k]]))
                idx, vals = idx[top[:k]], vals[top[:k]]
            return idx, vals, floor

        return tuple(handles), finish

    def _combo_f_indices(self, combo: dict) -> np.ndarray:
        """F_flat gather indices for every combo's 4 orientation cells:
        delta(c) = size(s_i) + sum(sizes of the between-set) = the
        canonical start-offset difference of the pair."""
        sizes = self.parent.sizes
        Sp, C = self.parent.Sp, self.C
        values = combo["values"].astype(np.int64)
        gi = values[combo["si_r"]]
        gj = values[combo["sj_r"]]
        nbits = combo["bits"].shape[1]
        delta = sizes[gi].copy()
        if nbits:
            others_g = values[combo["others_r"]]
            delta += (combo["bits"] * sizes[others_g]).sum(axis=1)
        rows = (gi * Sp + gj) * 4
        idx4 = (rows[:, None] + np.arange(4)) * (C + 1) + delta[:, None]
        idx4 = np.where(combo["valid"][:, None], idx4, 0)
        return idx4.astype(np.int32)

    def _score_topk_combo_async(
        self, orders: np.ndarray, orients: np.ndarray, e_onehot: np.ndarray, k: int
    ):
        """Brute-force top-k via the combo factorization: the
        candidate->combo map (pure combinatorics) is computed once per
        enumeration batch and its device copy reused across every
        chromosome; per subset only the tiny (n_combo, 4) F gather
        changes.  Candidate index = order-major, orientation-fastest —
        identical to the chunked path and the reference enumeration.
        Returns (handles, finish) — see score_batch_topk_async."""
        Bo, S = orders.shape
        R = orients.shape[0]
        P = S * (S - 1) // 2
        combo = _combo_index(orders.astype(np.int64))
        idx4 = self._combo_f_indices(combo)
        ek = ("E_dev", e_onehot.tobytes())
        if ek not in combo:
            combo[ek] = jnp.asarray(e_onehot.reshape(P, 4, R))
        E = combo[ek]
        mesh_key = None if self._mesh is None else id(self._mesh)
        ck = ("cid_dev", mesh_key)
        if ck not in combo:
            if self._mesh is None:
                combo[ck] = jnp.asarray(combo["cid"])
            else:
                from hic_genome_assembler_tpu.parallel import mesh as pm

                combo[ck], _ = pm.put_batch_padded(self._mesh, combo["cid"])
        cid_dev = combo[ck]
        n_pad = cid_dev.shape[0]
        kk = min(k, Bo * R)
        vals_d, idx_d, second_d = _combo_score_topk_kernel(
            self._F_flat,
            jnp.asarray(idx4),
            cid_dev,
            E,
            jnp.asarray(self.c0, dtype=self._F_flat.dtype),
            min(k, n_pad * R),
        )

        def finish(host):
            vals, idx, second = host[0], host[1], host[2]
            floor = -np.inf
            sec = second[np.isfinite(second)]
            if sec.size:
                floor = max(floor, float(sec.max()))
            keep = idx < Bo * R  # drop mesh-padding rows
            if (~keep).any():  # pad rows duplicate the last real candidate
                floor = max(floor, float(vals[~keep].max()))
            idx, vals = idx[keep], vals[keep]
            if len(idx) > kk:
                top = np.argsort(-vals, kind="stable")
                floor = max(floor, float(vals[top[kk]]))
                idx, vals = idx[top[:kk]], vals[top[:kk]]
            return idx, vals, floor

        return (vals_d, idx_d, second_d), finish

    def _put_batch(self, chunk: np.ndarray):
        if self._mesh is None:
            return jnp.asarray(chunk)
        from hic_genome_assembler_tpu.parallel import mesh as pm

        arr, _n = pm.put_batch_padded(self._mesh, chunk)
        return arr

    def score_pairs(self, orders: np.ndarray, orients: np.ndarray) -> np.ndarray:
        """Costs for per-candidate (order, orientation) pairs.

        ``orders`` and ``orients`` are both int[B, W]; entry k of
        candidate b places scaffold ``orders[b, k]`` (a GLOBAL id; the
        parent's ``pad_id`` fills unused slots) with orientation
        ``orients[b, k]`` (0 = "+").  Used by greedy insertion where
        slot and orientation are coupled per candidate.
        """
        handles, finish = self.score_pairs_async(orders, orients)
        return finish([np.asarray(h) for h in handles])

    def score_pairs_async(self, orders: np.ndarray, orients: np.ndarray):
        """Dispatch-only form of :meth:`score_pairs`: returns
        ``(handles, finish)`` (see score_batch_topk_async) so the
        readback can overlap other chromosomes' searches."""
        B, W = orders.shape
        if self.degenerate:
            return (), lambda host: np.zeros(B, dtype=np.float64)
        pi, pj = np.triu_indices(W, k=1)
        out = _pair_score_kernel(
            self._F_flat,
            self._sizes_d,
            self._put_batch(orders.astype(np.int32)),
            self._put_batch(orients.astype(np.int32)),
            jnp.asarray(pi.astype(np.int32)),
            jnp.asarray(pj.astype(np.int32)),
            jnp.asarray(self.c0, dtype=self._F_flat.dtype),
            self.C + 1,
        )
        return (out,), lambda host: np.asarray(host[0], dtype=np.float64)[:B]

    def score_host(self, order: Sequence[int], orient: Sequence[int]) -> float:
        """Reference-exact f64 cost for one (order, orientation); pad
        ids are ignored.

        Memoized by the candidate's canonical BIN order: orientation
        flips of single-bin scaffolds (and any other candidates that
        collapse to the same bin sequence) are bit-identical orderings,
        and brute-force enumerations contain 2^(#single-bin scaffolds)
        such duplicates per arrangement — without the memo the adaptive
        escalation re-scores every one of them at O(C^2)."""
        if self.degenerate:
            return 0.0
        order = np.asarray(order)
        orient = np.asarray(orient)
        real = order < self.S
        bin_order = bin_order_of_block(order[real], orient[real], self.sizes)
        key = bin_order.tobytes()
        hit = self._host_memo.get(key)
        if hit is not None:
            return hit
        gathered = self.parent._sub[np.ix_(bin_order, bin_order)]
        out = oracle.cost_function(gathered, self.total)
        self._host_memo[key] = out
        return out


def BlockScorer(
    sub_matrix: np.ndarray,
    sizes: Sequence[int],
    dtype=np.float32,
    mesh=None,
    device_sub: Optional[jax.Array] = None,
) -> SubsetScorer:
    """Brute-force scorer over the full scaffold set of ``sub_matrix``
    (back-compat constructor: ChromosomeScorer(...).full())."""
    return ChromosomeScorer(
        sub_matrix, sizes, dtype=dtype, mesh=mesh, device_sub=device_sub
    ).full()


# ---------------------------------------------------------------------------
# Decision rule
# ---------------------------------------------------------------------------


# Fast-precision safety margin: a candidate whose device (f32) score is
# more than this RELATIVE margin below the exact (f64) winner cannot be
# the f64 winner.  Why 1e-3 is safe: every cost is a sum of NON-NEGATIVE
# terms M[i,j] * w(d) (contact counts and harmonic weights are >= 0 —
# no cancellation), so the f32 kernel's relative error is bounded by
# depth * u with u = 2^-24 and depth the accumulation-chain length;
# XLA reduces the table contractions in blocked trees, depth <~ 64 even
# at C = 4096, bounding |f64 - f32| / |f64| <~ 4e-6.  That bound needs
# true f32 multiplies: a GPU runs default-precision f32 matmuls in
# TF32 (about three decimal digits), so every scoring dot pins
# Precision.HIGHEST (they are gather/bandwidth-bound, so full-fidelity
# multiplies cost little).  The measured errors, per backend, are in
# docs/PRECISION.md.  The margin is *enforced*, not assumed: every rescored candidate's observed
# |f64 - f32| feeds ``PRECISION`` (warns at margin/8 = 1.25e-5), and
# the decision rules below escalate —
# widening the rescore set, or pulling the full cost vector when the
# device top-k floor is too close — until no unseen candidate can beat
# the winner.  The margin is deliberately NOT wider: every candidate
# whose fast score lands within it of the exact winner costs an O(C^2)
# host f64 re-score, and near-symmetric inputs put
# many genuine near-ties inside a loose band (a 1e-3 margin measurably
# stalled genome-scale part 2 on tie-heavy fixtures).
_F32_MARGIN = 1e-4


class PrecisionStats:
    """Live monitor of the fast-vs-exact score gap.

    Every decision that re-scores a candidate in f64 records the
    discrepancy against its f32 device score here; if any observation
    exceeds ``_F32_MARGIN / 8`` the margin assumption is formally
    violated and a warning is raised (the decision itself stays correct
    — the escalation loops anchor on f64 values, so a violation within
    ``_F32_MARGIN`` only costs extra re-scores, and a violation beyond
    it is surfaced instead of silently mis-deciding)."""

    def __init__(self) -> None:
        self.n = 0
        self.max_rel = 0.0
        self.escalations = 0
        self.violations = 0

    def observe(self, fast: float, exact: float) -> None:
        if not np.isfinite(fast):
            return
        rel = abs(exact - fast) / max(abs(exact), 1.0)
        self.n += 1
        if rel > self.max_rel:
            self.max_rel = rel
        if rel > _F32_MARGIN / 8.0:
            self.violations += 1
            import warnings

            warnings.warn(
                "fast-precision score error %.3g exceeds the f32 margin "
                "budget %.3g (exact=%r fast=%r); decisions remain exact via "
                "escalation but the kernel precision model is off" %
                (rel, _F32_MARGIN / 8.0, exact, fast),
                RuntimeWarning,
                stacklevel=3,
            )

    def reset(self) -> None:
        self.__init__()


PRECISION = PrecisionStats()


def _prefilter_margin(vals: np.ndarray) -> np.ndarray:
    best = float(vals.max())
    return vals >= best - _F32_MARGIN * max(abs(best), 1.0)


def _decide(
    costs: np.ndarray,
    rescore: Callable[[int], float],
    exact: dict,
    rel_tol: float,
) -> Tuple[int, float]:
    """Shared adaptive core: given fast costs for ALL candidates and a
    (possibly pre-seeded) f64 cache, grow the cache until no candidate
    whose fast score is within ``_F32_MARGIN`` of the exact winner is
    un-rescored, then apply the reference tie rule (earliest index among
    f64 ties wins)."""
    best = max(exact.values())
    while True:
        band = _F32_MARGIN * max(abs(best), 1.0)
        cand = np.nonzero(costs >= best - band)[0]
        new = [int(i) for i in cand if int(i) not in exact]
        if not new:
            break
        PRECISION.escalations += 1
        for i in new:
            exact[i] = float(rescore(i))
            PRECISION.observe(float(costs[i]), exact[i])
        best = max(exact.values())
    tol = rel_tol * max(abs(best), 1.0)
    winners = sorted(i for i, c in exact.items() if c >= best - tol)
    return winners[0], exact[winners[0]]


def argmax_reference_ties_sparse(
    cand_indices: np.ndarray,
    rescore: Callable[[int], float],
    rel_tol: float = 1e-12,
    fast_vals: Optional[np.ndarray] = None,
    second_floor: Optional[float] = None,
    escalate: Optional[Callable[[], np.ndarray]] = None,
) -> Tuple[int, float]:
    """Reference tie rule over a sparse candidate set (device top-k):
    f64-rescore the plausible candidates, earliest index among ties
    wins.  ``fast_vals`` (parallel to ``cand_indices``) enables the
    f32-margin prefilter; excluded candidates are adaptively re-added
    whenever their fast score is within the margin of the exact winner.
    ``second_floor`` (the kernel's bound on every candidate it did NOT
    return) plus ``escalate`` (-> full fast-cost vector) close the last
    gap: if the floor is within the margin of the exact winner, the
    decision re-runs densely over all candidates."""
    cand_indices = np.asarray(cand_indices)
    fv = None if fast_vals is None else np.asarray(fast_vals, dtype=np.float64)
    sel = cand_indices
    if fv is not None and len(cand_indices) > 1:
        sel = cand_indices[_prefilter_margin(fv)]
    fmap = {}
    if fv is not None:
        fmap = {int(i): float(v) for i, v in zip(cand_indices, fv)}
    exact = {}
    for i in sel:
        exact[int(i)] = float(rescore(int(i)))
        PRECISION.observe(fmap.get(int(i), np.nan), exact[int(i)])
    best = max(exact.values())
    if fv is not None:
        while True:
            band = _F32_MARGIN * max(abs(best), 1.0)
            new = [
                int(i) for i, v in zip(cand_indices, fv)
                if v >= best - band and int(i) not in exact
            ]
            if not new:
                break
            PRECISION.escalations += 1
            for i in new:
                exact[i] = float(rescore(i))
                PRECISION.observe(fmap[i], exact[i])
            best = max(exact.values())
    band = _F32_MARGIN * max(abs(best), 1.0)
    if (
        second_floor is not None
        and escalate is not None
        and second_floor >= best - band
    ):
        # candidates dropped on-device could still contend: pull the
        # full fast-cost vector and decide densely (rare by design)
        PRECISION.escalations += 1
        full = np.asarray(escalate(), dtype=np.float64)
        return _decide(full, rescore, exact, rel_tol)
    tol = rel_tol * max(abs(best), 1.0)
    winners = sorted(i for i, c in exact.items() if c >= best - tol)
    return winners[0], exact[winners[0]]


def argmax_reference_ties(
    costs: np.ndarray,
    rescore: Optional[Callable[[int], float]] = None,
    k: int = 64,
    rel_tol: float = 1e-12,
) -> Tuple[int, float]:
    """Pick the winning candidate the way the reference does.

    The reference keeps the FIRST candidate that is strictly greater
    than the running best, i.e. the earliest index attaining the max.
    Device costs are fast-precision, so the top-k are optionally
    re-scored with ``rescore(index) -> f64`` before the final argmax;
    the rescore set then grows adaptively until every candidate whose
    fast score is within ``_F32_MARGIN`` of the exact winner has been
    re-scored (so a fast-precision error inside the margin cannot flip
    the decision, and one beyond it is detected by ``PRECISION``).
    Candidates within ``rel_tol`` of the best count as ties and the
    earliest index wins.  (Callers that already know some candidates'
    exact costs memoize inside ``rescore`` — see score_host's bin-order
    memo and the scan coroutine's f64_cache.)
    """
    n = costs.shape[0]
    if n == 0:
        raise ValueError("no candidates")
    if rescore is None or n <= 1:
        best = float(costs.max())
        ties = np.nonzero(costs >= best - rel_tol * max(abs(best), 1.0))[0]
        return int(ties[0]), best
    costs = np.asarray(costs, dtype=np.float64)
    k = min(k, n)
    top = np.argpartition(-costs, k - 1)[:k]
    top = top[_prefilter_margin(costs[top])]
    exact = {}
    for i in top:
        i = int(i)
        exact[i] = float(rescore(i))
        PRECISION.observe(float(costs[i]), exact[i])
    return _decide(costs, rescore, exact, rel_tol)
