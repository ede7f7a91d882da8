"""Device map_read must agree with the scalar oracle, read-for-read.

Covers: planted junction reads, background reads, reads with Ns, reverse
complements, and a dupe-rich panel (dupe lists + high-level dupes)."""

import numpy as np
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.indexer import Indexer
from genefuserust_jax.core.sequence import encode_bases, reverse_complement
from genefuserust_jax.models.fusion import Fusion
from genefuserust_jax.ops.hashtable import (
    EMPTY,
    lookup_np,
    lookup_np_kv,
    pack_index,
    pack_index_kv,
    pack_index_kv16,
)
from genefuserust_jax.utils.synthetic import make_panel, plant_fusion_pairs, write_panel_files


def build_indexer(panel, tmp_path, settings=Settings()):
    _, csv_path = write_panel_files(panel, str(tmp_path))
    fusions = Fusion.parse_csv(csv_path)
    ix = Indexer(panel.contigs, fusions, settings)
    ix.make_index()
    return ix


def batch_of(reads, L):
    codes = np.full((len(reads), L), 255, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, s in enumerate(reads):
        c = encode_bases(s)
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, lengths


def run_device(ix, reads, L=None, layout="split"):
    import jax.numpy as jnp
    from genefuserust_jax.ops.map_read import map_read_batch

    L = L or max(16, max(len(r) for r in reads))
    codes, lengths = batch_of(reads, L)
    if layout == "kv":
        packed = pack_index_kv(ix)
        assert packed is not None, "panel should fit the KV payload budget"
        tbl1 = jnp.asarray(packed.kv_tbl)
        tbl2 = jnp.zeros((1, 2), jnp.int32)
        statics = dict(kv=True, cbits=packed.cbits, pos_bias=packed.pos_bias)
    elif layout == "kv16":
        packed = pack_index_kv16(ix)
        assert packed is not None, "panel should fit the KV16 layout"
        tbl1 = jnp.asarray(packed.kv_tbl)
        tbl2 = jnp.zeros((1, 2), jnp.int32)
        statics = dict(kv=2, cbits=packed.cbits, pos_bias=packed.pos_bias)
    else:
        packed = pack_index(ix)
        tbl1 = jnp.asarray(packed.keys_tbl)
        tbl2 = jnp.asarray(packed.vals_tbl)
        statics = {}
    res = map_read_batch(
        jnp.asarray(codes),
        jnp.asarray(lengths),
        tbl1,
        tbl2,
        jnp.asarray(packed.dupes),
        packed.shift,
        packed.max_dupe,
        ix.settings.major_gene_key_requirement,
        ix.settings.minor_gene_key_requirement,
        ix.settings.mismatch_threshold,
        **statics,
    )
    return [
        [
            (
                int(res.seg_start[i, t]),
                int(res.seg_end[i, t]),
                int(res.seg_contig[i, t]),
                int(res.seg_pos[i, t]),
            )
            for t in range(2)
            if bool(res.seg_valid[i, t])
        ]
        for i in range(len(reads))
    ]


def oracle_segs(ix, reads):
    out = []
    for r in reads:
        segs = ix.map_read(r)
        out.append(
            [(s.seq_start, s.seq_end, s.start_gp.contig, s.start_gp.position) for s in segs]
        )
    return out


def make_reads(panel, n_junction=8, n_background=30, seed=3):
    rng = np.random.default_rng(seed)
    g1 = panel.genes[0]
    g2 = panel.genes[1]
    jpoint1 = g1[2] + 5000
    jpoint2 = g2[2] + 6000
    fused = (
        panel.contigs[g1[1]][jpoint1 - 300 : jpoint1 + 1]
        + panel.contigs[g2[1]][jpoint2 : jpoint2 + 300]
    )
    reads = []
    for k in range(n_junction):
        off = 300 - 150 + 10 + 11 * k
        reads.append(fused[off : off + 150])
    # in-gene reads (should be single-segment / rejected)
    for k in range(n_background):
        chrom = list(panel.contigs)[int(rng.integers(2))]
        s = panel.contigs[chrom]
        off = int(rng.integers(0, len(s) - 150))
        reads.append(s[off : off + 150])
    # RCs of junction reads
    reads += [reverse_complement(r) for r in reads[:4]]
    # reads with Ns sprinkled
    for k in range(4):
        r = list(reads[k])
        for p in rng.integers(0, 150, size=3):
            r[int(p)] = "N"
        reads.append("".join(r))
    # short read, all-N read
    reads.append("ACGT" * 5)
    reads.append("N" * 150)
    return reads


def test_hashtable_roundtrip(tmp_path):
    panel = make_panel()
    ix = build_indexer(panel, tmp_path)
    packed = pack_index(ix)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    c, p = lookup_np(packed, keys)
    exp = np.array([ix.kmer_gp[int(k)] for k in keys], np.int64)
    assert (c == exp[:, 0]).all()
    assert (p == exp[:, 1]).all()
    # misses
    rng = np.random.default_rng(0)
    probe = rng.integers(0, 2**32, size=2000, dtype=np.uint64).astype(np.uint32)
    known = set(ix.kmer_gp) | set(ix.kmer_dupe) | set(ix.kmer_high)
    c, p = lookup_np(packed, probe)
    for k, ci in zip(probe.tolist(), c.tolist()):
        if k not in known:
            assert ci == EMPTY


def test_device_matches_oracle_basic(tmp_path):
    panel = make_panel()
    ix = build_indexer(panel, tmp_path)
    reads = make_reads(panel)
    exp = oracle_segs(ix, reads)
    assert run_device(ix, reads) == exp
    assert run_device(ix, reads, layout="kv") == exp
    assert run_device(ix, reads, layout="kv16") == exp


def test_kv_table_roundtrip(tmp_path):
    panel = make_panel()
    ix = build_indexer(panel, tmp_path)
    split = pack_index(ix)
    kvp = pack_index_kv(ix)
    assert kvp is not None
    rng = np.random.default_rng(0)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    cs, ps = lookup_np(split, probe)
    ck, pk = lookup_np_kv(kvp, probe)
    assert (cs == ck).all()
    # positions only meaningful where an entry exists (dupe rows are
    # layout-local indices but must agree in count semantics)
    reg = cs >= 0
    assert (ps[reg] == pk[reg]).all()
    from genefuserust_jax.ops.hashtable import DUPE

    dup = cs == DUPE
    if dup.any():
        # dupe row CONTENT must agree after decoding
        pbits = 32 - kvp.cbits
        rows_kv = kvp.dupes[pk[dup]]
        tag = (rows_kv.astype(np.uint32) >> np.uint32(pbits)).astype(np.int32)
        val = (rows_kv.astype(np.uint32) & np.uint32((1 << pbits) - 1)).astype(
            np.int64
        )
        rows_sp = split.dupes[ps[dup]]
        for r_kv_t, r_kv_v, r_sp in zip(tag, val, rows_sp):
            got = [
                (int(t - 3), int(v + kvp.pos_bias))
                for t, v in zip(r_kv_t, r_kv_v)
                if t >= 3
            ]
            exp = [
                (int(c), int(p)) for c, p in r_sp if c != EMPTY
            ]
            assert got == exp


def test_device_matches_oracle_with_dupes(tmp_path):
    # plant a motif 3x within gene1 (dupe lists) and 8x within gene2
    # (high-level dupes); also repeat a 40bp block to create many dupes
    panel = make_panel(seed=11)
    g1n, g1c, g1s, g1e = panel.genes[0]
    g2n, g2c, g2s, g2e = panel.genes[1]
    motif = "ACGTTGCAACGGTTACGATCCAGTTACG"  # 28bp -> 13 internal 16-mers
    s1 = panel.contigs[g1c]
    for off in (g1s + 1000, g1s + 3000, g1s + 7000):
        s1 = s1[:off] + motif + s1[off + len(motif) :]
    panel.contigs[g1c] = s1
    s2 = panel.contigs[g2c]
    for k in range(8):
        off = g2s + 500 + 1100 * k
        s2 = s2[:off] + motif + s2[off + len(motif) :]
    panel.contigs[g2c] = s2
    ix = build_indexer(panel, tmp_path)
    assert ix.kmer_dupe, "expected dupe entries"
    assert ix.kmer_high, "expected high-level dupes"
    reads = make_reads(panel)
    # reads overlapping the dupe motifs
    reads.append(s1[g1s + 990 : g1s + 990 + 150])
    reads.append(s2[g2s + 490 : g2s + 490 + 150])
    # chimeric read through a dupe motif
    reads.append(s1[g1s + 2950 : g1s + 3030] + s2[g2s + 5000 : g2s + 5070])
    exp = oracle_segs(ix, reads)
    assert run_device(ix, reads) == exp
    assert run_device(ix, reads, layout="kv") == exp
    assert run_device(ix, reads, layout="kv16") == exp


def test_device_matches_oracle_tinyref_panel(tmp_path, refdata):
    # real panel CSV against a synthetic chr2 stand-in: gene slices resolve
    # via the chr-fallback path with realistic exon structures
    from genefuserust_jax.utils.synthetic import random_seq

    rng = np.random.default_rng(5)
    fusions = Fusion.parse_csv(str(refdata / "fusions.csv"))
    # synthesize just chr2 segment covering ALK+EML4 (other genes dropped)
    contigs = {"chr2": random_seq(rng, 100000)}
    # remap gene coords into the synthetic contig
    alk = next(f for f in fusions if f.gene.name == "ALK").gene
    eml4 = next(f for f in fusions if f.gene.name == "EML4").gene
    alk.start, alk.end = 1000, 31000
    eml4.start, eml4.end = 40000, 70000
    fusions = [f for f in fusions if f.gene.name in ("ALK", "EML4")]
    ix = Indexer(contigs, fusions, Settings())
    ix.make_index()
    assert ix.fusion_seq[0] != ""
    # junction read ALK(rc, since ALK slice indexes fwd+rc)=EML4
    jread = contigs["chr2"][20000:20080] + contigs["chr2"][50000:50072]
    reads = [jread, reverse_complement(jread)]
    exp = oracle_segs(ix, reads)
    assert run_device(ix, reads) == exp
    assert run_device(ix, reads, layout="kv") == exp
    assert run_device(ix, reads, layout="kv16") == exp


def test_device_matches_oracle_small_panel(tmp_path):
    # the tinyref-panel case on a seeded CSV: a reversed gene (exons
    # descending) and a forward gene on one synthetic chr2, each with a
    # realistic exon structure, and junction reads across them
    from genefuserust_jax.utils.synthetic import random_seq

    rng = np.random.default_rng(5)
    contigs = {"chr2": random_seq(rng, 100000)}
    csv = tmp_path / "fusions.csv"
    rev_exons = "".join(
        f"{k + 1},{30000 - 1500 * k},{30000 - 1500 * k + 180}\n" for k in range(18)
    )
    fwd_exons = "".join(
        f"{k + 1},{40500 + 1400 * k},{40500 + 1400 * k + 120}\n" for k in range(20)
    )
    csv.write_text(
        f">REVG,chr2:1000-31000\n{rev_exons}>FWDG,chr2:40000-70000\n{fwd_exons}"
    )
    fusions = Fusion.parse_csv(str(csv))
    assert fusions[0].gene.is_reversed() and not fusions[1].gene.is_reversed()
    ix = Indexer(contigs, fusions, Settings())
    ix.make_index()
    assert ix.fusion_seq[0] != ""
    s = contigs["chr2"]
    reads = [
        s[20000:20080] + s[50000:50072],
        s[12000:12090] + reverse_complement(s[60000:60070]),
        s[45000:45150],
    ]
    reads += [reverse_complement(r) for r in reads]
    exp = oracle_segs(ix, reads)
    assert any(len(e) == 2 for e in exp)
    assert run_device(ix, reads) == exp
    assert run_device(ix, reads, layout="kv") == exp
    assert run_device(ix, reads, layout="kv16") == exp
