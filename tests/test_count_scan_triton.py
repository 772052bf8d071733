"""The Pallas/Triton count kernel of ``benchmarks/count_scan_triton.py``
in interpret mode against the numpy host scans, and its lowering for
CUDA (Triton IR is built here without a GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from benchmarks import count_scan_triton as cst
from hic_genome_assembler_tpu.cluster import breakpoints as bp

N = 75  # not a multiple of the tiles below
TILES = dict(block_rows=8, block_cols=16, interpret=True)


@pytest.fixture(scope="module")
def rank():
    rng = np.random.default_rng(5)
    return np.argsort(rng.random((N, N)), axis=1).astype(np.int32)


def _run(rank, rows):
    params = jnp.asarray(np.array(rows, dtype=np.int32))
    return np.asarray(cst.counts_many_triton(jnp.asarray(rank), params, **TILES))


@pytest.mark.parametrize("start", [0, 1, 7, 30, N - 2])
def test_growing_matches_host(rank, start):
    got = _run(rank, [[start, 0, 1]])[0]
    np.testing.assert_array_equal(got, bp._host_growing_counts(rank, start))


@pytest.mark.parametrize("start,cut", [(0, 5), (3, 40), (10, N - 1), (50, 20)])
def test_fixed_matches_host(rank, start, cut):
    got = _run(rank, [[start, cut, 0]])[0]
    np.testing.assert_array_equal(got, bp._host_fixed_counts(rank, start, cut))


def test_mixed_batch_matches_xla(rank):
    from hic_genome_assembler_tpu.ops import matrix as dev

    rows = [[0, 0, 1], [3, 40, 0], [17, 0, 1], [60, 10, 0], [0, N - 1, 0]]
    want = np.asarray(dev.counts_many(jnp.asarray(rank), jnp.asarray(np.array(rows, np.int32))))
    np.testing.assert_array_equal(_run(rank, rows), want)


def test_part1_runs_swap_kernels(tmp_path, monkeypatch):
    """The part-1 comparison swaps the count functions per run, restores
    XLA's after, and gets an identical file bus (interpret mode, device
    count path forced)."""
    import functools

    from hic_genome_assembler_tpu.ops import matrix as dev

    xla = dev.counts_many
    monkeypatch.setattr(bp, "_HOST_N", 0)
    monkeypatch.setattr(cst, "counts_many_triton",
                        functools.partial(cst.counts_many_triton, interpret=True))
    out = cst.part1_runs(str(tmp_path), n_chroms=3, scaffolds=6)
    assert [r["kernel"] for r in out["runs"]] == ["xla", "triton", "triton", "xla"]
    assert out["file_bus_identical"]
    assert dev.counts_many is xla


def test_lowers_for_cuda():
    args = (jax.ShapeDtypeStruct((1000, 1000), jnp.int32),
            jax.ShapeDtypeStruct((64, 3), jnp.int32))
    exp = export.export(
        cst.counts_many_triton, platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(*args)
    assert "xla.gpu.triton" in exp.mlir_module()
    assert exp.out_avals[0].shape == (64, 1000)
