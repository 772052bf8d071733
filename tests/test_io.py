"""HiC-Pro ingestion + file-bus round-trips on synthetic fixtures."""

import os

import numpy as np

from hic_genome_assembler_tpu.io import fasta, filebus, hicpro


def test_initiate_loci_counts(genome, hicpro_dir):
    bins = hicpro.initiate_loci(hicpro_dir["bed"], hicpro_dir["bias"])
    assert len(bins) == genome.n_bins
    assert bins[0].ID == 0
    assert bins[0].chrom == genome.scaffolds[0].name


def test_initiate_loci_whitelist(hicpro_dir):
    bins = hicpro.initiate_loci(hicpro_dir["bed"], hicpro_dir["bias"], binID_dict={0: "", 5: ""})
    assert [b.ID for b in bins] == [0, 5]


def test_nan_bias_dropped(tmp_path):
    bed = tmp_path / "b.bed"
    bias = tmp_path / "b.bias"
    bed.write_text("s1\t0\t100\t0\ns1\t100\t200\t1\ns2\t0\t100\t2\n")
    bias.write_text("1.0\nnan\nbadfloat\n")
    bins = hicpro.initiate_loci(str(bed), str(bias))
    assert [b.ID for b in bins] == [0, 2]
    assert bins[1].bias == 0.0  # unparseable bias -> 0.0


def test_adjacency_symmetric_and_correct(genome, hicpro_dir):
    bins = hicpro.initiate_loci(hicpro_dir["bed"], hicpro_dir["bias"])
    adj = hicpro.build_adjacency_matrix(hicpro_dir["matrix"], bins)
    assert adj.shape == (genome.n_bins, genome.n_bins)
    np.testing.assert_allclose(adj, adj.T)
    # values round-trip through the text format at 1e-8 precision
    np.testing.assert_allclose(adj, genome.matrix, atol=1e-7)


def test_remove_zero_rows():
    m = np.array(
        [
            [1.0, 0.0, 2.0],
            [0.0, 0.0, 0.0],
            [2.0, 0.0, 1.0],
        ]
    )
    bins = [hicpro.Bin(i, f"s{i}", 0, 10, 1.0) for i in range(3)]
    pruned, kept = hicpro.remove_zero_rows(m, bins)
    assert pruned.shape == (2, 2)
    assert [b.ID for b in kept] == [0, 2]
    assert kept[0].rowSum == 3.0  # row sum AFTER pruning


def test_remove_rows_bias_filter():
    """removeRows biasVals semantics (scaffoldToChromosomes.py:105-120):
    strict inequalities, zero-sum rows skip the bias test, rowSum
    recomputed after deletion."""
    m = np.array(
        [
            [1.0, 0.0, 2.0, 1.0],
            [0.0, 0.0, 0.0, 0.0],  # zero row (bias also out of range)
            [2.0, 0.0, 1.0, 1.0],
            [1.0, 0.0, 1.0, 1.0],
        ]
    )
    biases = [0.5, 9.0, 2.0, 1.0]  # hi-bound exclusion is strict: keep == 2.0?
    bins = [hicpro.Bin(i, f"s{i}", 0, 10, biases[i]) for i in range(4)]
    # lo=0.6, hi=2.0: bias 0.5 < lo -> drop; 2.0 is NOT > hi -> keep
    pruned, kept = hicpro.remove_rows(m, bins, zero_rows=True, bias_vals=(0.6, 2.0))
    assert [b.ID for b in kept] == [2, 3]
    assert pruned.shape == (2, 2)
    assert kept[0].rowSum == 2.0  # row sums AFTER pruning
    assert kept[1].rowSum == 2.0

    # boundary strictness on the low side too
    bins2 = [hicpro.Bin(i, f"s{i}", 0, 10, b) for i, b in enumerate(biases)]
    _, kept2 = hicpro.remove_rows(
        np.ones((4, 4)), bins2, zero_rows=False, bias_vals=(0.5, 2.0)
    )
    assert [b.ID for b in kept2] == [0, 2, 3]  # bias == lo survives (strict <)


def test_read_fasta_rejects_leading_content(tmp_path):
    bad = tmp_path / "bad.fa"
    bad.write_text("ACGT\n>seq1\nACGT\n")
    try:
        fasta.read_fasta(str(bad))
        raise AssertionError("expected ValueError on pre-header content")
    except ValueError:
        pass
    # whitespace-only prefix is tolerated (reference would IndexError on
    # the blank line; documented relaxation)
    ok = tmp_path / "ok.fa"
    ok.write_text("\n>seq1\nAC\rGT\n")
    seqs = fasta.read_fasta(str(ok))
    # text-mode universal newlines turn the lone \r into a line break —
    # for the reference's line loop too, so both yield "ACGT"
    assert seqs == {"seq1": "ACGT"}


def test_bin_groupings_roundtrip(tmp_path):
    bins = [hicpro.Bin(i, f"scaf{i % 2}", i * 10, i * 10 + 10, 1.5) for i in range(6)]
    out = tmp_path / "groups.txt"
    filebus.write_bin_groupings([2, 4], bins, str(out))
    text = out.read_text()
    assert text.startswith("### Chromosome group 1 ###\n")
    assert text.count("### Chromosome group") == 3
    groups = filebus.read_bin_groupings(str(out))
    assert [len(g) for g in groups] == [2, 2, 2]
    assert groups[0][0].split("\t")[0] == "0"


def test_chromosome_groupings_size_sorted(tmp_path):
    chrom_list = [
        [(0, "small")],
        [(1, "big"), (2, "big")],
    ]
    sizes = {"small": 100, "big": 100000}
    out = tmp_path / "chrgroups.txt"
    filebus.write_chromosome_groupings(chrom_list, sizes, str(out))
    lines = out.read_text().splitlines()
    # biggest chromosome renamed Chr group 1
    assert lines[0] == "### Chromosome group 1 ###"
    assert lines[1] == "1\tbig"
    groups = filebus.read_chroms_from_file(str(out))
    assert groups[0] == [[1, "big"], [2, "big"]]
    assert groups[1] == [[0, "small"]]
    valid = filebus.read_groupings_to_valid_bins(str(out))
    assert set(valid) == {0, 1, 2}


def test_scaffold_orderings_roundtrip(tmp_path):
    orders = [[("s1", "+"), ("s2", "-")], [("s3", "+")]]
    out = tmp_path / "order.txt"
    filebus.write_scaffold_orderings(orders, str(out))
    back = filebus.read_chromosome_ordering(str(out))
    assert back == [[["s1", "+"], ["s2", "-"]], [["s3", "+"]]]


def test_dendrogram_roundtrip(tmp_path):
    out = tmp_path / "dendro.txt"
    filebus.write_dendrogram_leaf_order(["a_0", "b_1"], [1, 0], str(out))
    text = out.read_text()
    assert not text.endswith("\n")  # reference writes no trailing newline
    back = filebus.read_dendrogram_leaf_order(str(out))
    assert back == {"ivl": ["a_0", "b_1"], "leaves": [1, 0]}


def test_fasta_roundtrip_and_revcomp(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_text(">s1\nACGTN\nacgtn\n>s2\nTTTT\n")
    seqs = fasta.read_fasta(str(p))
    assert seqs == {"s1": "ACGTNacgtn", "s2": "TTTT"}
    assert fasta.reverse_complement("ACGTN") == "NACGT"
    assert fasta.reverse_complement("acgtn") == "nacgt"
    try:
        fasta.reverse_complement("ACGR")
    except KeyError:
        pass
    else:
        raise AssertionError("non-ACGTN must raise KeyError like the reference")


def test_native_coo_parser_matches_pandas(genome, hicpro_dir, tmp_path):
    """native/coo_parser.cpp must return the identical (nnz, 3) f64
    array, in file order, as the pandas fallback."""
    from hic_genome_assembler_tpu.io import hicpro, native

    if not native.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    got = native.parse_coo(hicpro_dir["matrix"])
    import pandas as pd

    want = pd.read_csv(
        hicpro_dir["matrix"], sep="\t", header=None, dtype=np.float64, engine="c"
    ).to_numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)

    # scientific notation, blank lines, \r\n endings
    odd = tmp_path / "odd.matrix"
    odd.write_text("0\t1\t1.5e-3\r\n\n2\t3\t4\n")
    got = native.parse_coo(str(odd))
    np.testing.assert_array_equal(got, [[0, 1, 1.5e-3], [2, 3, 4]])

    # malformed file -> None (caller falls back)
    bad = tmp_path / "bad.matrix"
    bad.write_text("0\t1\tx\n")
    assert native.parse_coo(str(bad)) is None

    # empty file
    empty = tmp_path / "empty.matrix"
    empty.write_text("")
    assert native.parse_coo(str(empty)).shape == (0, 3)


def test_native_library_builds_from_sources_into_ignored_path(tmp_path):
    """The library is built from native/*.cpp into native/build/ (which
    .gitignore lists), keyed on a hash of the sources: an edited source
    builds a new library beside the old one."""
    import ctypes

    from hic_genome_assembler_tpu.io import native

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    real = native.library_path()
    assert os.path.dirname(real) == os.path.join(repo, "native", "build")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert "native/build/" in fh.read().split()

    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int answer() { return 41; }\n')
    first = native.build_library(str(tmp_path))
    assert first == native.library_path(str(tmp_path))
    assert os.path.dirname(first) == str(tmp_path / "build")
    assert ctypes.CDLL(first).answer() == 41
    assert native.build_library(str(tmp_path)) == first  # no rebuild

    src.write_text('extern "C" int answer() { return 42; }\n')
    second = native.build_library(str(tmp_path))
    assert second != first and os.path.exists(first)
    assert ctypes.CDLL(second).answer() == 42
