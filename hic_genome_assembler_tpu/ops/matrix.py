"""Contact-matrix transform kernels (device-side, JAX/XLA).

Device replacements for the reference's O(N^2) Python-loop matrix
layer (scaffoldToChromosomes.py:100-183 / orderGenome.py:95-178):

* distance transform      row -> (1 - row/row.sum()) + 1
* similarity transform    row -> rowSum_i * (1 - (row - 1))  (inverse)
* log / exp transform     elementwise on nonzeros, with the part1 (+1)
                          and part2 (no +1) variants (SURVEY.md §2 row 9)
* symmetric permutation   matrix[order][:, order]
* rank-order matrix       per-row argsort descending
* hypergeometric count kernels (prefix-membership counts; the O(N^2)
  inner work of the part1 breakpoint scans, scaffoldToChromosomes.py:449-469
  and :622-636)

Everything is jit-compiled with static shapes; all functions take and
return jnp arrays so they compose under one jit and shard over a mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def to_distance(matrix: jnp.ndarray) -> jnp.ndarray:
    """Row-stochastic distance transform, range [1, 2].

    D[i, j] = (1 - M[i, j] / sum_j M[i, j]) + 1
    (scaffoldToChromosomes.py:138-148; row sum includes the diagonal).
    """
    row_sums = matrix.sum(axis=1, keepdims=True)
    return (1.0 - matrix / row_sums) + 1.0


@jax.jit
def to_similarity(matrix: jnp.ndarray, row_sums: jnp.ndarray) -> jnp.ndarray:
    """Inverse of ``to_distance``: S[i, j] = rowSum_i * (1 - (D[i, j] - 1)).

    ``row_sums`` is the per-bin rowSum recorded when the matrix was
    pruned (Bin.rowSum), which restores the original contact values
    (scaffoldToChromosomes.py:149).
    """
    return row_sums[:, None] * (1.0 - (matrix - 1.0))


@functools.partial(jax.jit, static_argnames=("log_base", "reverse", "plus_one"))
def log_transform(
    matrix: jnp.ndarray,
    log_base: float = 10.0,
    reverse: bool = False,
    plus_one: bool = True,
) -> jnp.ndarray:
    """Elementwise log/exp on nonzero entries, zeros preserved.

    plus_one=True  : log_b(v + 1)  /  b**v - 1   (part1 variant,
                     scaffoldToChromosomes.py:165-183)
    plus_one=False : log_b(v)      /  b**v       (part2 variant,
                     orderGenome.py:160-178 — the reference's copies
                     genuinely differ; both are preserved)
    """
    nz = matrix != 0.0
    if not reverse:
        shifted = matrix + 1.0 if plus_one else matrix
        out = jnp.log(shifted) / np.log(log_base)
    else:
        powed = jnp.power(log_base, matrix)
        out = powed - 1.0 if plus_one else powed
    return jnp.where(nz, out, 0.0)


@jax.jit
def reorder(matrix: jnp.ndarray, order: jnp.ndarray) -> jnp.ndarray:
    """Symmetric permutation matrix[order][:, order]
    (scaffoldToChromosomes.py:157-163)."""
    return matrix[order][:, order]


@jax.jit
def rank_matrix_desc(matrix: jnp.ndarray) -> jnp.ndarray:
    """Per-row argsort descending (the part1 rank-order matrix,
    scaffoldToChromosomes.py:1132).

    Mirrors the reference's construction exactly — stable ASCENDING
    argsort, then column reverse — so tie groups resolve by DESCENDING
    index just like ``numpy.argsort(...)[:, ::-1]``.  This matters far
    beyond bit-aesthetics: every zero contact in a row lands in one
    huge equal-similarity tie group, and an ascending tie rule (the
    old ``argsort(-matrix)`` form) reordered that whole group,
    cascading into different membership counts and different cuts
    (benchmarks/device_mode_parity.py caught 16-vs-4 cut sets at 675
    bins).  With this form, rank rows differ from the f64 oracle only
    where f32 VALUES genuinely collide or reorder — the narrow
    caveat models/part1_cluster.py documents.
    """
    return jnp.argsort(matrix, axis=1, stable=True)[:, ::-1].astype(jnp.int32)


@jax.jit
def growing_window_counts(rank_mat: jnp.ndarray, start: jnp.ndarray) -> jnp.ndarray:
    """Per-row prefix-membership counts for the breakpoint scan.

    For each row i of the rank matrix R:
        count[i] = #{ j < i - start : start <= R[i, j] <= i }
    which is the hypergeometric ``x`` parameter of
    scaffoldToChromosomes.py:449-463 (rows i <= start are unused by the
    caller).  One fused masked reduction over the full matrix — this is
    the HOT O(N^2) inner loop of part1 made a single XLA kernel.
    """
    n = rank_mat.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    cols = jnp.arange(rank_mat.shape[1], dtype=jnp.int32)[None, :]
    in_prefix = cols < (rows - start)
    in_range = (rank_mat >= start) & (rank_mat <= rows)
    return jnp.sum(in_prefix & in_range, axis=1, dtype=jnp.int32)


@jax.jit
def fixed_window_counts(
    rank_mat: jnp.ndarray,
    start: jnp.ndarray,
    cut: jnp.ndarray,
) -> jnp.ndarray:
    """Per-row fixed-prefix membership counts for the cut-noise filter.

    count[i] = #{ j < (cut - start) : start <= R[i, j] <= cut }
    (scaffoldToChromosomes.py:631).
    """
    cols = jnp.arange(rank_mat.shape[1], dtype=jnp.int32)[None, :]
    in_prefix = cols < (cut - start)
    in_range = (rank_mat >= start) & (rank_mat <= cut)
    return jnp.sum(in_prefix & in_range, axis=1, dtype=jnp.int32)


@jax.jit
def fixed_window_counts_many(
    rank_mat: jnp.ndarray,
    params: jnp.ndarray,
) -> jnp.ndarray:
    """Batched fixed-window counts: params int32[K, 2] of (start, cut)
    rows -> int32[K, n].

    One dispatch + one readback for a whole working set of windows
    instead of a kernel launch + host sync per (start, cut).
    """
    return jax.vmap(
        lambda p: fixed_window_counts(rank_mat, p[0], p[1])
    )(params)


@jax.jit
def counts_many(rank_mat: jnp.ndarray, params: jnp.ndarray) -> jnp.ndarray:
    """Mixed batched counts: params int32[K, 3] rows of (start, cut,
    flag) where flag=1 selects the growing scan and flag=0 the fixed
    window — one dispatch for an arbitrary working set (lax.map keeps
    the per-scan [n, n] mask transient sequential instead of
    materializing K of them)."""

    def one(p):
        return jax.lax.cond(
            p[2] == 1,
            lambda: growing_window_counts(rank_mat, p[0]),
            lambda: fixed_window_counts(rank_mat, p[0], p[1]),
        )

    return jax.lax.map(one, params)


def condensed_upper(matrix: np.ndarray) -> np.ndarray:
    """Upper triangle (k=1) in scipy condensed order.

    Equivalent to ``scipy.spatial.distance.squareform(m, checks=False)``
    for a square input — the form fed to UPGMA linkage
    (scaffoldToChromosomes.py:194).  Host-side numpy: the output feeds
    scipy's C linkage directly.
    """
    iu = np.triu_indices(matrix.shape[0], k=1)
    return np.ascontiguousarray(matrix[iu])
