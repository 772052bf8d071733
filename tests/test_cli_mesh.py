"""The parallel substrate is reachable from the production CLI and
changes nothing about the results (VERDICT r1 items 1 & 7).

* ``-mesh auto`` on the 8-virtual-device CPU platform vs ``-mesh off``:
  byte-identical file bus for parts 1+2+4;
* chromosome-level EP sharding through part2.run_pipeline
  (process_count=2, shard files merged over the file bus) ==
  single-process output;
* part1 matrixMode=device recovers the planted groups.
"""

import os

import pytest

from hic_genome_assembler_tpu import cli
from hic_genome_assembler_tpu.utils import fixtures

BUS_FILES = (
    "dendro.txt",
    "bingroups.txt",
    "assessment.txt",
    "chromgroups.txt",
    "chromorder.txt",
    "plotorder.txt",
    "assembled.fasta",
)


@pytest.fixture(scope="module")
def cli_genome():
    return fixtures.make_genome(
        chrom_scaffold_bins=((6, 5, 4, 3, 2), (5, 4, 3)), seed=17
    )


def _write_config(path, data_paths, out_dir):
    fixtures.write_pipeline_config(
        path, data_paths, out_dir, 10000,
        finalOrderingsFile="chromorder.txt", hyperGeom="True", hmm="False",
        minSize=5, modularity=0, psig=0.05, convergenceRounds=5,
        lookAhead=0.2, louvainRounds=3, nScaffolds=4, scanScaffolds=3,
        lengthCutoff=20000,
    )


def test_cli_mesh_matches_cli_off(cli_genome, tmp_path):
    """python -m hic_genome_assembler_tpu -part1 -part2 -part4 with
    -mesh auto (8 devices) vs -mesh off: byte-identical file bus."""
    paths = fixtures.write_hicpro_files(cli_genome, str(tmp_path / "data"))
    buses = {}
    for tag, mesh_flag in (("off", "off"), ("auto", "auto")):
        out = tmp_path / tag
        out.mkdir()
        cfg = str(tmp_path / f"config_{tag}.txt")
        _write_config(cfg, paths, str(out))
        cli.main(["-part1", "-part2", "-part4", "-config", cfg, "-mesh", mesh_flag])
        buses[tag] = {
            name: (out / name).read_bytes()
            for name in BUS_FILES
        }
    assert buses["auto"] == buses["off"]


def test_part2_ep_sharding_matches_single_process(cli_genome, tmp_path):
    """Two-process EP run (each owning a chromosome shard, merged over
    the file bus) == single-process part2 output, byte for byte."""
    from hic_genome_assembler_tpu.models import part1_cluster, part2_order

    paths = fixtures.write_hicpro_files(cli_genome, str(tmp_path / "data"))
    base = tmp_path / "bus"
    base.mkdir()
    f = lambda name: str(base / name)
    part1_cluster.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        f("dendro.txt"), "", "", f("bingroups.txt"), f("assessment.txt"),
        f("chromgroups.txt"),
        hyper_geom=True, hmm=False, min_size=5, modularity=0,
        louvain_rounds=3, psig=0.05, convergence_rounds=5, look_ahead=0.2,
        resolution=cli_genome.resolution,
    )

    def run_part2(order_file, plot_file, **kwargs):
        part2_order.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"], f("chromgroups.txt"),
            order_file, "", "", "", "t", plot_file,
            n_scaffolds=4, scan_scaffolds=3, resolution=cli_genome.resolution,
            **kwargs,
        )

    run_part2(f("order_single.txt"), f("plot_single.txt"))
    # EP: process 1 writes its shard first, then process 0 merges.
    run_part2(f("order_ep.txt"), f("plot_ep_p1.txt"),
              process_index=1, process_count=2)
    assert os.path.exists(f("order_ep.txt.shard1"))
    assert not os.path.exists(f("order_ep.txt"))
    run_part2(f("order_ep.txt"), f("plot_ep.txt"),
              process_index=0, process_count=2, shard_wait_s=5)

    assert (base / "order_ep.txt").read_bytes() == (
        base / "order_single.txt"
    ).read_bytes()
    assert (base / "plot_ep.txt").read_bytes() == (
        base / "plot_single.txt"
    ).read_bytes()


def test_part1_device_matrix_mode_recovers_groups(cli_genome, tmp_path):
    """matrixMode=device (on-device transforms + rank argsort) still
    recovers the planted chromosome groups on the fixture."""
    from hic_genome_assembler_tpu.io import filebus
    from hic_genome_assembler_tpu.models import part1_cluster
    from hic_genome_assembler_tpu.parallel import mesh as pm

    paths = fixtures.write_hicpro_files(cli_genome, str(tmp_path / "data"))
    f = lambda name: str(tmp_path / name)
    part1_cluster.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        f("dendro.txt"), "", "", f("bingroups.txt"), f("assessment.txt"),
        f("chromgroups.txt"),
        hyper_geom=True, hmm=False, min_size=5, modularity=0,
        louvain_rounds=3, psig=0.05, convergence_rounds=5, look_ahead=0.2,
        resolution=cli_genome.resolution,
        mesh=pm.make_mesh((8, 1)), matrix_mode="device",
    )
    groups = filebus.read_chroms_from_file(f("chromgroups.txt"))
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(names) for names in cli_genome.true_groups().values())
    assert got == want


def test_part1_device_mode_mesh_matches_local(cli_genome, tmp_path):
    """matrixMode=device under a mesh (TP row-sharded transforms +
    2-D sharded count kernels) produces the byte-identical file bus to
    the mesh-less device run — elementwise f32 transforms and stable
    per-row argsort are sharding-invariant, counts are integers."""
    from hic_genome_assembler_tpu.models import part1_cluster
    from hic_genome_assembler_tpu.parallel import mesh as pm

    paths = fixtures.write_hicpro_files(cli_genome, str(tmp_path / "data"))
    buses = {}
    for tag, use_mesh in (("mesh", pm.make_mesh((4, 2))), ("local", None)):
        out = tmp_path / tag
        out.mkdir()
        f = lambda name, out=out: str(out / name)
        part1_cluster.run_pipeline(
            paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
            f("dendro.txt"), "", "", f("bingroups.txt"), f("assessment.txt"),
            f("chromgroups.txt"),
            hyper_geom=True, hmm=False, min_size=5, modularity=0,
            louvain_rounds=3, psig=0.05, convergence_rounds=5, look_ahead=0.2,
            resolution=cli_genome.resolution,
            mesh=use_mesh, matrix_mode="device",
        )
        buses[tag] = {
            name: (out / name).read_bytes()
            for name in ("dendro.txt", "bingroups.txt", "chromgroups.txt")
        }
    assert buses["mesh"] == buses["local"]
