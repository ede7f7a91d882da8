"""Block FASTQ reader must agree with the scalar reader; block scan path
must equal the object scan path."""

import numpy as np

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner, HostEngine
from genefuserust_jax.io.fastq import FastqReader
from genefuserust_jax.io.fastq_block import read_fastq_block, read_pair_block
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)


def test_block_reader_matches_scalar(refdata):
    for name in ("R1.fq", "R1.fq.gz", "R2.fq"):
        scalar = list(FastqReader(str(refdata / name)))
        block = read_fastq_block(str(refdata / name))
        assert len(block) == len(scalar)
        for i, r in enumerate(scalar):
            assert block.name(i) == r.name
            assert block.seq_str(i) == r.seq
            assert block.qual_str(i) == r.quality


def test_block_reader_matches_scalar_seeded(tmp_path):
    import gzip

    pairs = plant_fusion_pairs(make_panel(seed=4), n_support=3, n_background=40)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    with open(r1, "rb") as src, gzip.open(r1 + ".gz", "wb") as dst:
        dst.write(src.read())
    for path in (r1, r1 + ".gz", r2):
        scalar = list(FastqReader(path))
        block = read_fastq_block(path)
        assert len(block) == len(scalar) == len(pairs)
        for i, r in enumerate(scalar):
            assert block.name(i) == r.name
            assert block.seq_str(i) == r.seq
            assert block.qual_str(i) == r.quality


def test_block_reader_edge_cases(tmp_path):
    # no trailing newline; varying lengths; incomplete trailing record
    p = tmp_path / "x.fq"
    p.write_text("@a\nACGTACGTACGTACGTAC\n+\nIIIIIIIIIIIIIIIIII\n@b\nACGT\n+\nJJJJ\n@c\nAC")
    block = read_fastq_block(str(p))
    assert len(block) == 2  # incomplete record dropped (scalar: None)
    assert block.seq_str(0) == "ACGTACGTACGTACGTAC"
    assert block.seq_str(1) == "ACGT"
    assert block.qual_str(1) == "JJJJ"
    scalar = list(FastqReader(str(p)))
    assert len(scalar) == 2


def test_block_scan_equals_object_scan(tmp_path):
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=50)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    _, csv_path = write_panel_files(panel, str(tmp_path))

    def run_block(engine, name):
        sc = Scanner(
            csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
            engine=engine, command="blk",
        )
        return (
            sc.scan_pair_block(read_pair_block(r1, r2)),
            (tmp_path / name).read_text(),
        )

    def run_obj(engine, name):
        sc = Scanner(
            csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
            engine=engine, command="blk",
        )
        return sc.scan_pairs(pairs), (tmp_path / name).read_text()

    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    m1, j1 = run_obj(HostEngine(), "a.json")
    m2, j2 = run_block(DeviceEngine(Settings(), batch_size=32), "b.json")
    m3, j3 = run_block(HostEngine(), "c.json")
    assert strip(j1) == strip(j2) == strip(j3)
    assert [f.title for f in m1.fusion_results] == [
        f.title for f in m2.fusion_results
    ]


def test_streamed_blocks_equal_whole_file(tmp_path):
    from genefuserust_jax.io.fastq_block import (
        read_pair_block,
        stream_pair_blocks,
    )

    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=4, n_background=30)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    whole = read_pair_block(r1, r2)
    # tiny chunks force many block boundaries
    streamed = list(stream_pair_blocks(r1, r2, chunk_bytes=1024))
    assert len(streamed) > 3
    tot = sum(len(b) for b in streamed)
    assert tot == len(whole)
    k = 0
    for blk in streamed:
        for i in range(len(blk)):
            assert blk.left.name(i) == whole.left.name(k)
            assert blk.left.seq_str(i) == whole.left.seq_str(k)
            assert blk.right.qual_str(i) == whole.right.qual_str(k)
            k += 1
    # full streamed scan equals whole-block scan
    _, csv_path = write_panel_files(panel, str(tmp_path))
    sA = Scanner(csv_path, panel.contigs, "", str(tmp_path / "a.json"), Settings(),
                 engine=DeviceEngine(Settings(), batch_size=16), command="s")
    mA = sA.scan_pair_stream(stream_pair_blocks(r1, r2, chunk_bytes=2048))
    sB = Scanner(csv_path, panel.contigs, "", str(tmp_path / "b.json"), Settings(),
                 engine=DeviceEngine(Settings(), batch_size=64), command="s")
    mB = sB.scan_pair_block(read_pair_block(r1, r2))
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip((tmp_path / "a.json").read_text()) == strip(
        (tmp_path / "b.json").read_text()
    )


def test_coalesce_pair_blocks(tmp_path):
    """coalesce_pair_blocks must re-chunk byte-sized stream blocks into
    exact batch multiples (all but the last), preserve order/content, and
    keep name/read_obj delegation to the source buffers intact."""
    from genefuserust_jax.io.fastq_block import (
        coalesce_pair_blocks,
        coalesce_read_blocks,
        read_pair_block,
        stream_fastq_blocks,
        stream_pair_blocks,
    )

    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=4, n_background=60)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    whole = read_pair_block(r1, r2)
    n = len(whole)
    for bs in (7, 16, 64, 1000):
        out = list(
            coalesce_pair_blocks(stream_pair_blocks(r1, r2, chunk_bytes=777), bs)
        )
        sizes = [len(b) for b in out]
        assert sum(sizes) == n
        assert all(s % bs == 0 for s in sizes[:-1])
        assert all(s > 0 for s in sizes)
        k = 0
        for blk in out:
            for i in range(len(blk)):
                assert blk.left.name(i) == whole.left.name(k)
                assert blk.left.seq_str(i) == whole.left.seq_str(k)
                assert blk.right.qual_str(i) == whole.right.qual_str(k)
                ro = blk.left.read_obj(i)
                assert ro.seq == whole.left.seq_str(k)
                k += 1
    # single-end analog
    out = list(
        coalesce_read_blocks(stream_fastq_blocks(r1, chunk_bytes=777), 16)
    )
    sizes = [len(b) for b in out]
    assert sum(sizes) == n and all(s % 16 == 0 for s in sizes[:-1])
    k = 0
    for blk in out:
        for i in range(len(blk)):
            assert blk.name(i) == whole.left.name(k)
            assert blk.seq_str(i) == whole.left.seq_str(k)
            k += 1


def test_mismatched_widths_and_short_reads(tmp_path):
    """Regression: R1/R2 blocks with different max widths (trimmed mates)
    must scan identically to the host oracle; all-short batches must not
    crash the device kernels."""
    from genefuserust_jax.io.fastq_block import read_pair_block

    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=5, n_background=20)
    # trim every R2 to 120bp (R1 stays 150) -> different block widths
    from genefuserust_jax.core.read import SequenceRead, SequenceReadPair

    trimmed = [
        SequenceReadPair(
            p.left,
            SequenceRead(p.right.name, p.right.seq[:120], "+", p.right.quality[:120]),
        )
        for p in pairs
    ]
    r1, r2 = write_fastq_files(trimmed, str(tmp_path))
    _, csv_path = write_panel_files(panel, str(tmp_path))
    blk = read_pair_block(r1, r2)
    assert blk.left.seq.shape[1] != blk.right.seq.shape[1]

    def run(engine, name):
        sc = Scanner(csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
                     engine=engine, command="w")
        return sc.scan_pair_block(read_pair_block(r1, r2)), (tmp_path / name).read_text()

    mh, jh = run(HostEngine(), "h.json")
    mt, jt = run(DeviceEngine(Settings(), batch_size=16), "t.json")
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(jh) == strip(jt)
    assert len(mh.fusion_results) >= 1  # fusion still detected on trimmed mates

    # all-short reads (<30bp): no crash, zero matches, both engines agree
    shorts = [
        SequenceReadPair(
            SequenceRead(f"@s{k}", "ACGTACGTACGTACGTACGTAC", "+", "I" * 22),
            SequenceRead(f"@s{k}", "GTACGTACGTACGTACGTACGT", "+", "I" * 22),
        )
        for k in range(5)
    ]
    r1s, r2s = write_fastq_files(shorts, str(tmp_path))
    mh2, _ = (
        Scanner(csv_path, panel.contigs, "", "", Settings(), engine=HostEngine(), command="x").scan_pair_block(read_pair_block(r1s, r2s)),
        None,
    )
    mt2 = Scanner(
        csv_path, panel.contigs, "", "", Settings(),
        engine=DeviceEngine(Settings(), batch_size=8), command="x",
    ).scan_pair_block(read_pair_block(r1s, r2s))
    assert mh2.fusion_results == [] and mt2.fusion_results == []


def test_native_parser_equals_numpy():
    """The native gf_fastq_dims/gf_fastq_fill parser must agree with the
    vectorized numpy parser field-for-field on every edge the numpy
    parser defines (it in turn mirrors the reference record semantics,
    src/core/fastq_reader.rs:19-219 + the LimitedBufReader line cap)."""
    import pytest

    from genefuserust_jax import native
    from genefuserust_jax.io.fastq_block import (
        _parse_fastq_buffer_np,
        parse_fastq_buffer,
    )

    if not native.available():
        pytest.skip("native library unavailable")

    rec = b"@r1 d\nACGTACGTAC\n+x\nIIIIIIIIII\n"
    cases = [
        b"",
        rec,
        rec * 3,
        rec * 2 + b"@partial\nACGT",  # partial record dropped
        # partial record whose seq line is the LONGEST -> must not widen L
        rec + b"@p\n" + b"A" * 500 + b"\n+",
        # final unterminated line
        rec[:-1],
        # qual line longer than seq line (truncated to L)
        b"@a\nACGT\n+\nIIIIIIIIII\n",
        # varying lengths
        b"@a\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n@b\nAC\n+\nJJ\n",
        # final unterminated line of exactly 1000 bytes: allowed
        rec + b"@x\n" + b"A" * 1000,
    ]
    for data in cases:
        a = parse_fastq_buffer(data)  # native
        b = _parse_fastq_buffer_np(data)
        assert len(a) == len(b)
        assert a.seq.shape == b.seq.shape, data[:40]
        np.testing.assert_array_equal(a.seq, b.seq)
        np.testing.assert_array_equal(a.qual, b.qual)
        np.testing.assert_array_equal(a.lens, b.lens)
        np.testing.assert_array_equal(a.name_spans, b.name_spans)
        np.testing.assert_array_equal(a.strand_spans, b.strand_spans)

    # line-limit violations raise identically (index + message)
    bad_cases = [
        b"@x\n" + b"A" * 1000 + b"\n+\nI\n",        # terminated 1000B line
        rec + b"@y\n" + b"A" * 1500 + b"\nrest\n",  # mid-file long line
    ]
    for data in bad_cases:
        with pytest.raises(RuntimeError) as e1:
            parse_fastq_buffer(data)
        with pytest.raises(RuntimeError) as e2:
            _parse_fastq_buffer_np(data)
        assert str(e1.value) == str(e2.value)


def test_strand_line_preserved(tmp_path):
    p = tmp_path / "s.fq"
    p.write_text("@a desc\nACGTACGTACGTACGTACGT\n+a extra text\nIIIIIIIIIIIIIIIIIIII\n")
    from genefuserust_jax.io.fastq_block import read_fastq_block

    blk = read_fastq_block(str(p))
    r = blk.read_obj(0)
    assert r.strand == "+a extra text"
    scalar = FastqReader(str(p)).read()
    assert scalar.strand == r.strand
