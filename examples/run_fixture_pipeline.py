"""End-to-end demo on synthetic data.

Generates a synthetic genome with planted chromosome/order/orientation
truth, emits all HiC-Pro input files, writes a config, runs all four
pipeline parts through the CLI code path, and checks the recovered
structure against the planted truth.  The interactive-notebook analog of
the reference's hicAssemblerNotebook.ipynb.

Usage: python examples/run_fixture_pipeline.py [workdir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu import cli
from hic_genome_assembler_tpu.io import fasta, filebus
from hic_genome_assembler_tpu.utils import fixtures


def main(workdir: str = "/tmp/hic_demo") -> None:
    files_dir = os.path.join(workdir, "files")
    plots_dir = os.path.join(workdir, "plots")
    os.makedirs(files_dir, exist_ok=True)
    os.makedirs(plots_dir, exist_ok=True)

    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13,
        noise=0.005,
        cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))

    config_path = fixtures.write_pipeline_config(
        os.path.join(workdir, "config.txt"), paths, files_dir, genome.resolution,
        savePlotsDirectory=plots_dir,
        avgClusterPlot="avg_cluster.png",
        avgClusterPlot_outlined="avg_cluster_outlined.png",
        chromosomePlotSuffix=" (fixture)",
        fullGenomePlot="full_genome.png",
        fullGenomePlotTitle="synthetic genome",
        nScaffolds=4, scanScaffolds=3, modularity=0, lengthCutoff=500000,
    )

    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", config_path])

    # --- check against planted truth ---------------------------------------
    groups = filebus.read_chroms_from_file(os.path.join(files_dir, "chromgroups.txt"))
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(v) for v in genome.true_groups().values())
    print("\n== truth check ==")
    print("chromosome groups match planted truth:", got == want)
    assembled = fasta.read_fasta(os.path.join(files_dir, "assembled.fasta"))
    print("assembled entries:", sorted(assembled))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/hic_demo")
