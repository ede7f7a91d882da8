"""Golden tests for the foundation layer, mirroring the reference's unit
tests (SURVEY §4): reverse_complement, fast_merge, edit_distance, fusion CSV
pos2str, FASTA/FASTQ parsing. The `refdata` tests read the reference's own
test inputs and skip without them; the `_seeded` tests cover the same
behaviour on files written to tmp_path."""

import gzip

import numpy as np
import pytest

from genefuserust_jax.core.sequence import (
    dis_connected_count,
    encode_bases,
    reverse_complement,
)
from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
from genefuserust_jax.core.edit_distance import edit_distance
from genefuserust_jax.models.fusion import Fusion
from genefuserust_jax.io import fasta
from genefuserust_jax.io.fastq import FastqReader, FastqReaderPair


def test_reverse_complement():
    # reference: src/core/sequence.rs:66-70
    assert reverse_complement("ATGCGGGTT") == "AACCCGCAT"
    assert reverse_complement("CGAANTAG") == "CTANTTCG"


def test_dis_connected_count():
    assert dis_connected_count("AAAA") == 0
    assert dis_connected_count("ATAT") == 3
    assert dis_connected_count("A") == 0


def test_encode_bases():
    codes = encode_bases("ATCGN")
    assert list(codes) == [0, 1, 2, 3, 255]


def test_fast_merge_golden():
    # reference: src/core/read.rs:450-486
    left = SequenceRead(
        "@NS500713:64:HFKJJBGXY:1:11101:20469:1097 1:N:0:TATAGCCT+GGTCCCGA",
        "TTTTTTCTCTTGGACTCTAACACTGTTTTTTCTTATGAAAACACAGGAGTGATGACTAGTTGAGTGCATTCTTATGAGACTCATAGTCATTCTATGATGTAG",
        "+",
        "AAAAA6EEEEEEEEEEEEEEEEE#EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEAEEEAEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE",
    )
    right = SequenceRead(
        "@NS500713:64:HFKJJBGXY:1:11101:20469:1097 1:N:0:TATAGCCT+GGTCCCGA",
        "AAAAAACTACACCATAGAATGACTATGAGTCTCATAAGAATGCACTCAACTAGTCATCACTCCTGTGTTTTCATAAGAAAAAACAGTGTTAGAGTCCAAGAG",
        "+",
        "AAAAA6EEEEE/EEEEEEEEEEE#EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEAEEEAEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE",
    )
    merged = SequenceReadPair(left, right).fast_merge()
    assert merged is not None
    assert (
        merged.seq
        == "TTTTTTCTCTTGGACTCTAACACTGTTTTTTCTTATGAAAACACAGGAGTGATGACTAGTTGAGTGCATTCTTATGAGACTCATAGTCATTCTATGATGTAGTTTTTT"
    )
    assert merged.name.endswith("merged_diff_0") or "merged_diff_" in merged.name
    assert merged.strand == "+"


def test_edit_distance_golden():
    # reference: src/core/edit_distance.rs:221-261
    s1 = [
        "CCTATCAGGGAGCTGTGGGCCAGCCAGGAGGCAGCACATGCCCAATCCCAGGCCCCTCCCGTTGTAAGTTCCCGTTCTACCCGACAGGGACCTGCTGACAAAAGACAGGGCTGGAGAGCCAGCCTGAAGGCCCTGGGACCCTTCTATCCAC",
        "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTATAAAGTACCCATCTAGTACTTCAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACACAGTAAGATCGGA",
        "TAGGGGTATGAGTAGAGCTGAGCTGGGGGAAAAGAGGGAAATTCCCAGGGGTGGAGGAAGAGTCAAGTCCCCCTCTACACCTAGAGGATGAACTTAAGGAAGGAGTGAAGGTCATATGTGTTGTTCCTGAGGAAAAGGCCGCTGTAGAAAA",
    ]
    s2 = [
        "CCTATCAGGGAGCTGTGGGCCAGCCAGGAGGCAGCACATGCCCAATCCCAGGCCCCTCCCGTTGTAAGTTCCCGTTCTACCCGACAGGGACCTGCTGACAAAAGACAGGGCTGGAGAGCCAGCCTGAAGGCCCTGGGACCCTTCTATCCAC",
        "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTATAAAGTACCCATCTAGTACTTGAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACACAGTAAGATCGGA",
        "CCTGGGCCTGGCCCTTGTCTAAAACTGACTCTTTTGAGGGTGATTTTGGATGTTCTTAGTAGAGTCTCTCACCTGTACTTTCCTTGCCTAAGGTGCTGTCTTCTCTTGCAGGTTGCCTACACGTTCCTCACATGCCCTAAGAACCATGGGA",
    ]
    expect = [0, 1, 90]
    for a, b, e in zip(s1, s2, expect):
        assert edit_distance(a, b) == e
    # basics
    assert edit_distance("", "abc") == 3
    assert edit_distance("abc", "") == 3
    assert edit_distance("kitten", "sitting") == 3


def test_fusion_csv_pos2str(refdata):
    # reference: src/core/fusion.rs:115-149
    fusions = Fusion.parse_csv(str(refdata / "fusions.csv"))
    by_name = {f.gene.name: f.gene for f in fusions}
    assert set(by_name) == {"ALK", "ROS1", "RET", "EML4"}
    alk = by_name["ALK"]
    assert alk.pos2str(-30582) == "ALK:exon:20|-chr2:29446222"
    assert alk.pos2str(31060) == "ALK:intron:19|+chr2:29446700"
    eml4 = by_name["EML4"]
    assert eml4.pos2str(95365) == "EML4:exon:6|+chr2:42491855"
    assert eml4.pos2str(95346) == "EML4:intron:5|+chr2:42491836"
    # ALK is a reversed gene (exons descending)
    assert alk.is_reversed()
    assert not eml4.is_reversed()


def test_fasta_reader(refdata):
    # reference: src/core/fasta_reader.rs:232-255
    contig1 = "GATCACAGGTCTATCACCCTATTAATTGGTATTTTCGTCTGGGGGGTGTGGAGCCGGAGCACCCTATGTCGCAGT"
    contig2 = "GTCTGCACAGCCGCTTTCCACACAGAACCCCCCCCTCCCCCCGCTTCTGGCAAACCCCAAAAACAAAGAACCCTA"
    for name in ("tinyref.fa", "tinyref.fa.gz"):
        contigs = fasta.read_all(str(refdata / name), force_upper_case=True)
        assert contigs["contig1"] == contig1
        assert contigs["contig2"] == contig2


def test_fastq_reader(refdata):
    # reference: src/core/fastq_reader.rs:271-293
    plain = list(FastqReader(str(refdata / "R1.fq")))
    gz = list(FastqReader(str(refdata / "R1.fq.gz")))
    assert len(plain) == len(gz) == 3
    for a, b in zip(plain, gz):
        assert a.seq == b.seq
        assert a.name == b.name
        assert a.quality == b.quality
    assert plain[0].name.startswith("@NB551106:23:")
    pairs = list(FastqReaderPair(str(refdata / "R1.fq"), str(refdata / "R2.fq")))
    assert len(pairs) == 3


def test_fusion_csv_pos2str_seeded(tmp_path):
    # a forward synthetic panel gene plus a reversed gene (exons listed in
    # descending order, as for ALK); pos2str = NAME:exon|intron:N|±chr:pos
    from genefuserust_jax.utils.synthetic import make_panel

    csv = tmp_path / "fusions.csv"
    csv.write_text(
        make_panel(seed=5).csv_text
        + "# comment lines are skipped\n"
        + ">REV,chr5:20000-30000\n1,29000,29500\n2,26000,26200\n3,21000,21400\n"
    )
    by_name = {f.gene.name: f.gene for f in Fusion.parse_csv(str(csv))}
    assert list(by_name) == ["GENE1", "GENE2", "REV"]
    fwd, rev = by_name["GENE1"], by_name["REV"]
    assert (fwd.chr, fwd.start, fwd.end) == ("chr1", 5000, 15000)
    assert not fwd.is_reversed() and rev.is_reversed()
    # GENE1 exons: N at [5000 + 1000 (N-1), 5500 + 1000 (N-1)]
    assert fwd.pos2str(100) == "GENE1:exon:1|+chr1:5100"
    assert fwd.pos2str(700) == "GENE1:intron:1|+chr1:5700"
    assert fwd.pos2str(-2200) == "GENE1:exon:3|-chr1:7200"
    assert fwd.pos2str(9800) == "GENE1:+chr1:14800"  # past the last exon
    assert rev.pos2str(-9200) == "REV:exon:1|-chr5:29200"
    assert rev.pos2str(7000) == "REV:intron:1|+chr5:27000"
    assert rev.pos2str(4000) == "REV:intron:2|+chr5:24000"


def test_fasta_reader_seeded(tmp_path):
    # multi-line, mixed-case records with a header description; names sort
    rng = np.random.default_rng(3)
    seqs = {
        name: "".join(rng.choice(list("ACGTacgtN"), size=n))
        for name, n in (("contig2", 157), ("contig1", 203))
    }
    text = "".join(
        f">{name} synthetic record\n"
        + "".join(s[i : i + 60] + "\n" for i in range(0, len(s), 60))
        for name, s in seqs.items()
    )
    (tmp_path / "ref.fa").write_text(text)
    with gzip.open(tmp_path / "ref.fa.gz", "wt") as f:
        f.write(text)
    for name in ("ref.fa", "ref.fa.gz"):
        for upper in (False, True):
            contigs = fasta.read_all(str(tmp_path / name), force_upper_case=upper)
            assert list(contigs) == ["contig1", "contig2"]
            for c, s in seqs.items():
                # the description after the first space joins the sequence
                want = "syntheticrecord" + s
                assert contigs[c] == (want.upper() if upper else want)


def test_fastq_reader_seeded(tmp_path):
    from genefuserust_jax.utils.synthetic import (
        make_panel,
        plant_fusion_pairs,
        write_fastq_files,
    )

    pairs = plant_fusion_pairs(make_panel(seed=9), n_support=2, n_background=5)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    with open(r1, "rb") as src, gzip.open(r1 + ".gz", "wb") as dst:
        dst.write(src.read())
    plain = list(FastqReader(r1))
    gz = list(FastqReader(r1 + ".gz"))
    assert len(plain) == len(gz) == len(pairs)
    for a, b, want in zip(plain, gz, pairs):
        assert (a.name, a.seq, a.quality) == (b.name, b.seq, b.quality)
        assert (a.name, a.seq, a.quality) == (
            want.left.name, want.left.seq, want.left.quality
        )
    got = list(FastqReaderPair(r1, r2))
    assert len(got) == len(pairs)
    assert [p.right.seq for p in got] == [p.right.seq for p in pairs]


def test_read_reverse_complement():
    r = SequenceRead("@x", "ATGCN", "+", "ABCDE")
    rc = r.reverse_complement()
    assert rc.seq == "NGCAT"
    assert rc.quality == "EDCBA"
    assert rc.strand == "-"
    assert rc.reverse_complement().strand == "+"
