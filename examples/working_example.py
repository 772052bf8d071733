"""One-command walkthrough of the committed working-example config.

The reference ships a filled real-run config as its working example
(HIC_ASSEMBLER/hicAssembler_config_workingExample.txt, README.md:21);
this is the framework's equivalent, runnable anywhere: it generates the
synthetic fixture inputs at the exact paths the committed
``configs/hicAssembler_config_fixtureExample.txt`` expects, runs all
four pipeline parts through the real CLI with that config, and checks
the result against the planted truth.

Usage: python examples/working_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu import cli
from hic_genome_assembler_tpu.io import fasta, filebus
from hic_genome_assembler_tpu.utils import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "hicAssembler_config_fixtureExample.txt")
WORKDIR = "/tmp/hic_working_example"

# Must match the committed config's resolution = 10000 and the paths in
# its hicPro*/restriction/validPair/originalFasta keys.
GENOME_SPEC = dict(
    chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
    seed=13,
    noise=0.005,
    cross_noise_frac=0.001,
)


def main() -> None:
    for sub in ("files", "plots"):
        os.makedirs(os.path.join(WORKDIR, sub), exist_ok=True)
    genome = fixtures.make_genome(**GENOME_SPEC)
    fixtures.write_hicpro_files(genome, os.path.join(WORKDIR, "hicpro"))

    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", CONFIG])

    files_dir = os.path.join(WORKDIR, "files")
    groups = filebus.read_chroms_from_file(
        os.path.join(files_dir, "fixture_chromosomeGroupings.txt")
    )
    got = sorted(sorted({name for _b, name in grp}) for grp in groups)
    want = sorted(sorted(v) for v in genome.true_groups().values())
    assembled = fasta.read_fasta(os.path.join(files_dir, "fixture_assembled.fasta"))
    print("\n== working-example truth check ==")
    print("chromosome groups match planted truth:", got == want)
    print("assembled entries:", sorted(assembled))
    if got != want:
        raise SystemExit("working example failed the truth check")


if __name__ == "__main__":
    main()
