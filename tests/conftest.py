"""Test harness config: run JAX on 8 virtual CPU devices.

The same mesh code that runs across GPUs is exercised here on a CPU
mesh of 8 virtual devices, so sharded kernels and their collectives are
covered without hardware.  Env vars must be set before jax initializes.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# a plugin may have imported jax before this file set the env var
jax.config.update("jax_platforms", "cpu")

# CPU tests check float64 parity against the oracles; the GPU production
# path deliberately runs f32 with host f64 re-verification of decisions.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hic_genome_assembler_tpu.utils import fixtures  # noqa: E402


@pytest.fixture(scope="session")
def genome():
    """Default synthetic genome: 2 chromosomes, 9 scaffolds, ~57 bins."""
    return fixtures.make_genome(seed=3)


@pytest.fixture(scope="session")
def hicpro_dir(genome, tmp_path_factory):
    outdir = tmp_path_factory.mktemp("hicpro")
    paths = fixtures.write_hicpro_files(genome, str(outdir))
    return paths
