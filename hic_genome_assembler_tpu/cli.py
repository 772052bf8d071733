"""CLI entry point: ``python -m hic_genome_assembler_tpu -part1 -part2
-part3 -part4 -config <file>``.

Flag surface and run semantics match run_hicAssembler.py:247-299: any
combination of parts runs sequentially, each part imported lazily, total
wall-clock printed at the end.  Each part's wall time is also recorded
as the ``part<k>/total`` timer of ``utils.profiling`` beside the parts'
own stage timers.
"""

from __future__ import annotations

import argparse
import sys
import time

from hic_genome_assembler_tpu.config import (
    ensure_all_variables_are_set,
    read_config_file_to_variables,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hic_genome_assembler_tpu",
        description=(
            "Runs the various parts of the HiC assembly pipeline. "
            "Each Part requires the previous Part(s) to be run beforehand. "
            "Each Part can be run independently or sequentially and any "
            "combination of Part(s)1-4 is allowed."
        ),
    )
    parser.add_argument("-part1", help="Run part1 of the pipeline", action="store_true")
    parser.add_argument("-part2", help="Run part2 of the pipeline", action="store_true")
    parser.add_argument("-part3", help="Run part3 of the pipeline", action="store_true")
    parser.add_argument("-part4", help="Run part4 of the pipeline", action="store_true")
    parser.add_argument(
        "-config",
        help=(
            "Full file path to the config file. All arguments must have a "
            "value in the config file or the program will exit"
        ),
        required=True,
        type=str,
    )
    parser.add_argument(
        "-mesh",
        help=(
            "Device-mesh policy: 'auto' (mesh over all visible devices "
            "when more than one), 'off', or an explicit RxC (data, model) "
            "shape like '4x2'. Defaults to $HIC_MESH, then 'auto'."
        ),
        default=None,
        type=str,
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    start = time.time()
    from hic_genome_assembler_tpu.utils import hostmem, profiling

    profiling.reset()
    hostmem.tune()  # warm-page reuse for the multi-GB host matrices
    var = read_config_file_to_variables(args.config)
    if ensure_all_variables_are_set(var):
        sys.exit(1)

    # Parallel substrate: jax.distributed bring-up + device mesh
    # (env-or-flag; single-device 'auto' keeps the serial semantics).
    from hic_genome_assembler_tpu.parallel import runtime

    rt = runtime.bring_up(args.mesh)

    if args.part1:
        from hic_genome_assembler_tpu.models import part1_cluster as part1

        with profiling.timer("part1/total"):
            part1.run_pipeline(
                var["hicProBedFile"], var["hicProBiasFile"], var["hicProMatrixFile"],
                var["hicProScaffSizeFile"], var["dendrogramOrderFile"],
                var["avgClusterPlot"], var["avgClusterPlot_outlined"],
                var["binGroupFile"], var["assessmentFile"], var["chromosomeGroupFile"],
                var["hyperGeom"], var["hmm"], var["minSize"], var["modularity"],
                var["louvainRounds"], var["psig"], var["convergenceRounds"],
                var["lookAhead"], var["resolution"],
                mesh=rt.mesh, matrix_mode=var["matrixMode"],
                hmm_mode=var["hmmMode"],
            )
    if args.part2:
        from hic_genome_assembler_tpu.models import part2_order as part2

        with profiling.timer("part2/total"):
            part2.run_pipeline(
                var["hicProBedFile"], var["hicProBiasFile"], var["hicProMatrixFile"],
                var["chromosomeGroupFile"], var["chromosomeOrderFile"],
                var["savePlotsDirectory"], var["chromosomePlotSuffix"],
                var["fullGenomePlot"], var["fullGenomePlotTitle"], var["plotOrderFile"],
                var["nScaffolds"], var["scanScaffolds"], var["resolution"],
                mesh=rt.mesh,
                process_index=rt.process_index,
                process_count=rt.process_count,
            )
    if args.part3:
        from hic_genome_assembler_tpu.models import part3_orient as part3

        with profiling.timer("part3/total"):
            part3.run_pipeline(
                var["chromosomeOrderFile"], var["hicProScaffSizeFile"],
                var["restrictionSiteFile"], var["validPairFile"],
                var["finalOrderingsFile"], var["lengthCutoff"], var["resolution"],
            )
    if args.part4:
        from hic_genome_assembler_tpu.models import part4_fasta as part4

        with profiling.timer("part4/total"):
            part4.run_pipeline(
                var["originalFastaFile"], var["finalOrderingsFile"],
                var["assembledFastaFile"],
            )
    print("Total run-time = " + str(time.time() - start) + " seconds")


if __name__ == "__main__":
    main()
