"""The fused multi-chip pipeline step.

One jit: every dense stage of the engine composed under explicit
NamedShardings over a (data, model) mesh —

* TP: the N x N contact matrix 2-D sharded; distance+similarity row
  transforms run on the shards;
* SP: the rank matrix row-sharded; the growing-window membership counts
  (part1's hot scan) reduce along the model axis via an XLA-inserted
  collective;
* DP: the candidate-bin-order batch sharded on the data axis; each chip
  scores its slice of candidates against the (replicated) weight matrix,
  and the final argmax is a cross-chip reduction.

XLA materializes the psum/all-gather pattern from the sharding
annotations (the scaling-book recipe); nothing here hand-schedules
collectives.

Consumers: the multi-device dryrun (__graft_entry__.dryrun_multichip
step 3) executes this on a virtual CPU mesh; tests/test_multichip.py
asserts its shardings.  The production pipeline
itself composes the same kernels stage-by-stage (the searches are
host-driven loops), so this module is the one-jit composition proof,
not a third code path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hic_genome_assembler_tpu.parallel import mesh as pm


def _step(matrix, row_sums, rank_mat, bin_orders, w2):
    # TP/SP: sharded row transforms
    dist = (1.0 - matrix / matrix.sum(axis=1, keepdims=True)) + 1.0
    sim = row_sums[:, None] * (1.0 - (dist - 1.0))
    # SP: growing-window membership counts over the rank matrix
    n = rank_mat.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    cols = jnp.arange(n, dtype=jnp.int32)[None, :]
    counts = jnp.sum(
        (cols < rows) & (rank_mat >= 0) & (rank_mat <= rows), axis=1, dtype=jnp.int32
    )
    # DP: batched permutation scoring + global argmax
    gathered = sim[bin_orders[:, :, None], bin_orders[:, None, :]]
    costs = 0.5 * jnp.einsum(
        "bij,ij->b", gathered, w2, precision=jax.lax.Precision.HIGHEST
    )
    best = jnp.argmax(costs)
    return dist, counts, costs, best


def make_fused_step(mesh: Mesh):
    """jit the fused step with the production shardings bound."""
    mat = NamedSharding(mesh, P(pm.DATA_AXIS, pm.MODEL_AXIS))
    rows = NamedSharding(mesh, P(pm.DATA_AXIS))
    batch = NamedSharding(mesh, P(pm.DATA_AXIS, None))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        _step,
        in_shardings=(mat, rows, mat, batch, repl),
        out_shardings=(mat, rows, NamedSharding(mesh, P(pm.DATA_AXIS)), repl),
    )


def example_inputs(mesh: Mesh, n: int = 64, batch: int = 16, seed: int = 0):
    """Tiny, mesh-divisible inputs for compile checks and dry runs."""
    rng = np.random.default_rng(seed)
    d = mesh.shape[pm.DATA_AXIS]
    m_ax = mesh.shape[pm.MODEL_AXIS]
    n = pm.pad_to_multiple(pm.pad_to_multiple(n, d), m_ax)
    batch = pm.pad_to_multiple(batch, d)
    m = rng.random((n, n))
    m = (m + m.T).astype(np.float32) + np.eye(n, dtype=np.float32)
    row_sums = m.sum(axis=1)
    rank_mat = np.argsort(-m, axis=1).astype(np.int32)
    orders = np.stack([rng.permutation(n) for _ in range(batch)]).astype(np.int32)
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    w = np.zeros(n)
    w[1:] = 1.0 / np.arange(1, n)
    w2 = w[idx].astype(np.float32)
    return (
        jax.device_put(jnp.asarray(m), NamedSharding(mesh, P(pm.DATA_AXIS, pm.MODEL_AXIS))),
        jax.device_put(jnp.asarray(row_sums), NamedSharding(mesh, P(pm.DATA_AXIS))),
        jax.device_put(jnp.asarray(rank_mat), NamedSharding(mesh, P(pm.DATA_AXIS, pm.MODEL_AXIS))),
        jax.device_put(jnp.asarray(orders), NamedSharding(mesh, P(pm.DATA_AXIS, None))),
        jax.device_put(jnp.asarray(w2), NamedSharding(mesh, P())),
    )
