"""Direct unit pins for FusionResult semantics (otherwise only covered
through e2e scans)."""

from genefuserust_jax.config import Settings
from genefuserust_jax.core.fusion_result import FusionResult, get_ref_seq, _trunc_div
from genefuserust_jax.core.indexer import GenePos
from genefuserust_jax.core.mapper import ReadMatch
from genefuserust_jax.core.read import SequenceRead


def mk(read_break, lp, rp, gap=1, seq="ACGT" * 40):
    return ReadMatch(
        SequenceRead("@r", seq, "+", "I" * len(seq)),
        read_break,
        GenePos(0, lp),
        GenePos(1, rp),
        gap,
    )


def test_calc_fusion_point_gap_zero_priority():
    fr = FusionResult()
    fr.add_match(mk(70, 100, 200, gap=3))
    fr.add_match(mk(71, 104, 204, gap=0))  # first gap==0 wins outright
    fr.add_match(mk(72, 108, 208, gap=2))
    fr.calc_fusion_point()
    assert (fr.left_gp.position, fr.right_gp.position) == (104, 204)


def test_calc_fusion_point_truncated_mean():
    fr = FusionResult()
    fr.add_match(mk(70, 100, 200, gap=1))
    fr.add_match(mk(70, 101, 201, gap=2))
    fr.add_match(mk(70, 103, 202, gap=3))
    fr.calc_fusion_point()
    # (100+101+103)/3 = 101.33 -> 101 (Rust i64 division truncates)
    assert fr.left_gp.position == 101
    assert fr.right_gp.position == 201
    assert _trunc_div(-7, 2) == -3  # toward zero, not floor


def test_support_same_tolerance():
    fr = FusionResult()
    fr.add_match(mk(70, 100, 200))
    assert fr.support(mk(75, 103, 197))  # +-3 inclusive
    assert not fr.support(mk(75, 104, 200))  # left off by 4
    assert not fr.support(mk(75, 100, 196))  # right off by 4
    other = mk(75, 100, 200)
    other.left_gp.contig = 2
    assert not fr.support(other)


def test_calc_unique_break_len_pairs():
    fr = FusionResult()
    fr.add_match(mk(70, 100, 200, seq="A" * 100))
    fr.add_match(mk(70, 100, 200, seq="A" * 100))  # same (break, len)
    fr.add_match(mk(70, 100, 200, seq="A" * 101))  # same break, new len
    fr.add_match(mk(71, 100, 200, seq="A" * 101))  # new break
    fr.calc_unique()
    assert fr.unique == 3


def test_get_ref_seq_negative_strand():
    ref = "ACGTTACG" + "A" * 20
    # positive strand
    assert get_ref_seq(ref, 1, 4) == "CGTT"
    # negative coords -> reverse complement of [|end|, len)
    assert get_ref_seq(ref, -4, -1) == get_ref_seq(ref, 1, 4) and False or True
    from genefuserust_jax.core.sequence import reverse_complement

    assert get_ref_seq(ref, -4, -1) == reverse_complement(ref[1:5])
    # mixed strand / overflow -> empty
    assert get_ref_seq(ref, -2, 3) == ""
    assert get_ref_seq(ref, 5, 100) == ""


def test_is_deletion_same_contig_same_strand():
    fr = FusionResult()
    fr.left_gp = GenePos(3, 100)
    fr.right_gp = GenePos(3, 400)
    assert fr.is_deletion()
    fr.right_gp = GenePos(3, -400)
    assert not fr.is_deletion()  # mixed strand
    fr.right_gp = GenePos(4, 400)
    assert not fr.is_deletion()  # different contig
    fr.left_gp, fr.right_gp = GenePos(5, -10), GenePos(5, -20)
    assert fr.is_deletion()
