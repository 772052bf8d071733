"""hic_genome_assembler_tpu — a JAX Hi-C scaffolding engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
AO33/HiC_Genome_Assembler (reference: /root/reference/HIC_ASSEMBLER): a
four-phase, config-driven pipeline that turns HiC-Pro contact maps plus a
draft genome FASTA into a chromosome-scale assembly.

Pipeline parts (mirroring the reference CLI surface,
run_hicAssembler.py:247-299):

  part1  cluster contact-map rows into chromosome groups
         (UPGMA -> hypergeometric / HMM cut detection -> Louvain tail
         -> scaffold majority-vote assignment)
  part2  order & orient scaffolds per chromosome (brute-force + greedy
         insertion + sliding-window refinement over a distance-weighted
         contact score)
  part3  orient sub-resolution scaffolds from raw validPairs read pairs
  part4  emit the assembled FASTA

Architecture: all dense math (matrix transforms, rank matrices,
hypergeometric count scans, batched permutation scoring, HMM
forward-backward) runs on device as JAX/XLA kernels, shardable over a
`jax.sharding.Mesh`; branchy orchestration (config, cut bookkeeping, the
file bus, FASTA emission) stays on host.
"""

__version__ = "0.1.0"

from hic_genome_assembler_tpu.config import (  # noqa: F401
    read_config_file_to_variables,
    ensure_all_variables_are_set,
)
