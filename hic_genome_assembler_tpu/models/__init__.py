"""Pipeline parts (the framework's "model families"):

part1_cluster  contact-map clustering -> chromosome groups
part2_order    scaffold order/orientation search (batched device scoring)
part3_orient   sub-resolution orientation from validPairs
part4_fasta    assembled-FASTA emission
"""
