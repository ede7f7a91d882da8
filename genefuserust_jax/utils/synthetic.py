"""Synthetic data generation: genomes, panels, and planted-fusion reads.

Used by the end-to-end tests, bench.py and chip_smoke.py. The reference
validates e2e behavior manually against hg19/hg38 (SURVEY §4); those
references are not available here, so we synthesize deterministic genomes
with planted fusion junctions whose expected detections are known by
construction.

Two scales live here: `make_panel` is a two-gene toy for tests, and
`make_bench_panel` + `real_profile_pairs` are the deployment-size capture
panel and read workload the benchmark and the chip smoke run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.read import SequenceRead, SequenceReadPair
from ..core.sequence import reverse_complement

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng: np.random.Generator, n: int) -> str:
    return rng.choice(_BASES, size=n).tobytes().decode()


@dataclasses.dataclass
class SyntheticPanel:
    contigs: Dict[str, str]
    csv_text: str
    # per gene: (name, chrom, start, end)
    genes: List[Tuple[str, str, int, int]]


def make_panel(
    seed: int = 7,
    chrom_len: int = 30000,
    n_genes: int = 2,
    gene_len: int = 10000,
) -> SyntheticPanel:
    """Two-chromosome genome with one forward gene per chromosome, each with
    evenly spaced exons (exon 500bp / intron 500bp)."""
    rng = np.random.default_rng(seed)
    contigs = {}
    genes = []
    lines = []
    # Poly-A decoy: real genomes contain abundant poly-A runs, which give the
    # quirky Matcher's 1-base query keys (0..3) more than skip_threshold=50
    # index positions so they are skipped (matcher.rs:397,426-429). Without
    # this, tiny random genomes drive the reference binary into its
    # inverted-membership panic (matcher.rs:486-491) — see core/matcher.py.
    decoy = ("A" * 16 + "T" + "A" * 16 + "C" + "A" * 16 + "G") * 60
    for gi in range(n_genes):
        chrom = f"chr{gi + 1}"
        seq = random_seq(rng, chrom_len)
        if gi == 0:
            pos = chrom_len - len(decoy) - 100
            seq = seq[:pos] + decoy + seq[pos + len(decoy) :]
        contigs[chrom] = seq
        start = 5000
        end = start + gene_len
        name = f"GENE{gi + 1}"
        genes.append((name, chrom, start, end))
        lines.append(f">{name},{chrom}:{start}-{end}")
        eid = 1
        pos = start
        while pos + 500 <= end:
            lines.append(f"{eid},{pos},{pos + 500}")
            eid += 1
            pos += 1000
    return SyntheticPanel(contigs, "\n".join(lines) + "\n", genes)


def plant_fusion_pairs(
    panel: SyntheticPanel,
    n_support: int = 6,
    n_background: int = 50,
    read_len: int = 150,
    seed: int = 13,
) -> List[SequenceReadPair]:
    """Paired-end reads: `n_support` spanning a junction between GENE1 and
    GENE2 (left break at gene1-relative 5000, right at gene2-relative 6000),
    plus background pairs sampled from the genome."""
    rng = np.random.default_rng(seed)
    g1_name, g1_chr, g1_start, _ = panel.genes[0]
    g2_name, g2_chr, g2_start, _ = panel.genes[1]
    left_break = g1_start + 5000  # chrom coords; gene-relative 5000
    right_break = g2_start + 6000
    fused = (
        panel.contigs[g1_chr][left_break - 400 : left_break + 1]
        + panel.contigs[g2_chr][right_break : right_break + 400]
    )
    pairs = []
    for k in range(n_support):
        off = 400 - read_len + 25 + 7 * k  # junction near middle of R1
        r1 = fused[off : off + read_len]
        r2_span = fused[off + 40 : off + 40 + read_len]
        name = f"@SYNTH:fusion:{k} 1:N:0:ACGT"
        qual = "I" * read_len
        pairs.append(
            SequenceReadPair(
                SequenceRead(name, r1, "+", qual),
                SequenceRead(name, reverse_complement(r2_span), "+", qual),
            )
        )
    chroms = list(panel.contigs)
    for k in range(n_background):
        chrom = chroms[int(rng.integers(len(chroms)))]
        s = panel.contigs[chrom]
        off = int(rng.integers(0, len(s) - read_len - 60))
        r1 = s[off : off + read_len]
        r2_span = s[off + 40 : off + 40 + read_len]
        name = f"@SYNTH:bg:{k} 1:N:0:ACGT"
        qual = "I" * read_len
        pairs.append(
            SequenceReadPair(
                SequenceRead(name, r1, "+", qual),
                SequenceRead(name, reverse_complement(r2_span), "+", qual),
            )
        )
    return pairs


def write_panel_files(panel: SyntheticPanel, tmpdir: str) -> Tuple[str, str]:
    """-> (fasta_path, csv_path)"""
    import os

    fasta_path = os.path.join(tmpdir, "ref.fa")
    with open(fasta_path, "w") as f:
        for name, seq in panel.contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + "\n")
    csv_path = os.path.join(tmpdir, "panel.csv")
    with open(csv_path, "w") as f:
        f.write(panel.csv_text)
    return fasta_path, csv_path


def write_fastq_files(pairs: List[SequenceReadPair], tmpdir: str) -> Tuple[str, str]:
    import os

    r1 = os.path.join(tmpdir, "R1.fq")
    r2 = os.path.join(tmpdir, "R2.fq")
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for p in pairs:
            f1.write(f"{p.left.name}\n{p.left.seq}\n+\n{p.left.quality}\n")
            f2.write(f"{p.right.name}\n{p.right.seq}\n+\n{p.right.quality}\n")
    return r1, r2


# ---------------- deployment-size panel and read workload ----------------

BENCH_PANEL_GENES = 136
BENCH_PANEL_BP = 15_200_000


def bench_gene_spans(
    seed: int = 1, n_genes: int = BENCH_PANEL_GENES, total_bp: int = BENCH_PANEL_BP
) -> List[Tuple[str, int]]:
    """Seeded gene list of a cancer capture panel: `n_genes` genomic spans
    (log-normal lengths, as gene lengths are) summing to exactly
    `total_bp`. Default: 136 genes, 15.2 Mbp — a targeted cancer panel's
    size, whose kv2 device table packs to int32[2^26, 2] (512 MiB)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(np.log(60_000), 1.0, n_genes)
    spans = np.maximum(2_000, np.floor(raw * (total_bp / raw.sum()))).astype(np.int64)
    spans[int(np.argmax(spans))] += total_bp - int(spans.sum())
    return [(f"G{i:03d}", int(sp)) for i, sp in enumerate(spans)]


def make_bench_panel(
    panel_mbp: float = BENCH_PANEL_BP / 1e6, seed: int = 1
) -> SyntheticPanel:
    """One synthetic contig per gene of `bench_gene_spans(seed)`, taken in
    order until `panel_mbp` is reached. Each gene spans its contig from
    position 50 with up to 40 exons of 300 bp."""
    rng = np.random.default_rng(seed)
    spans = bench_gene_spans(seed)
    contigs: Dict[str, str] = {}
    genes = []
    lines = []
    total = 0
    for i, (name, span) in enumerate(spans):
        if total / 1e6 >= panel_mbp:
            break
        cn = f"c{i:03d}"
        contigs[cn] = random_seq(rng, span + 100)
        genes.append((name, cn, 50, 50 + span))
        lines.append(f">{name},{cn}:50-{50 + span}")
        step = max(1000, span // 20)
        eid = 1
        pos = 60
        while pos + 300 < span and eid <= 40:
            lines.append(f"{eid},{50 + pos},{50 + pos + 300}")
            eid += 1
            pos += step
        total += span
    return SyntheticPanel(contigs, "\n".join(lines) + "\n", genes)


def gene_seqs(panel: SyntheticPanel) -> List[str]:
    """Each gene's genomic sequence, in CSV order."""
    return [panel.contigs[c][s:e] for _, c, s, e in panel.genes]


class MatrixReads:
    """Reads held as padded (n, L) byte matrices; the block interface the
    engine scans (seq, qual, lens, name, read_obj)."""

    def __init__(self, seq, qual, lens, tag: str):
        self.seq = seq
        self.qual = qual
        self.lens = lens
        self.tag = tag

    def __len__(self):
        return len(self.lens)

    def name(self, i: int) -> str:
        return f"@bench:{self.tag}:{i}"

    def read_obj(self, i: int) -> SequenceRead:
        n = self.lens[i]
        return SequenceRead(
            self.name(i),
            self.seq[i, :n].tobytes().decode("latin-1"),
            "+",
            self.qual[i, :n].tobytes().decode("latin-1"),
        )

    def write_fastq(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(
                "".join(
                    f"{self.name(i)}\n"
                    f"{self.seq[i, :n].tobytes().decode('latin-1')}\n+\n"
                    f"{self.qual[i, :n].tobytes().decode('latin-1')}\n"
                    for i, n in enumerate(self.lens.tolist())
                )
            )


class MatrixPairs:
    def __init__(self, left: MatrixReads, right: MatrixReads):
        self.left = left
        self.right = right

    def __len__(self):
        return min(len(self.left), len(self.right))


# 'real'-profile constants (see real_profile_pairs for calibration)
_INSERT_MEAN, _INSERT_SD = 168.0, 8.0
_SUB_ERR_RATE = 0.003          # per base per read
_ERR_LOWQ_FRAC = 0.8           # errors that get a low-qual ('/'=Q14) call
_N_RATE = 0.0005               # no-call rate ('N' base, '#' qual)
_QUAL_CHARS = np.frombuffer(b"EA</6", np.uint8)   # Q36 Q32 Q27 Q14 Q21
_QUAL_P = np.array([0.80, 0.10, 0.04, 0.05, 0.01])


def real_profile_pairs(
    genes: List[str],
    n: int,
    read_len: int = 151,
    seed: int = 2,
    junction_frac: float = 0.001,
    planted: List[Tuple[int, int]] = (),
    n_support: int = 6,
) -> MatrixPairs:
    """Paired-end capture reads with a realistic error and insert model.

    Calibrated to the reference's shipped test reads (151bp reads, merged
    lengths 161-178bp, ~5.7% sub-Q20 bases): insert sizes N(168,8) clipped
    to [read_len+1, 200], a NextSeq-like quality profile, 0.3%/base
    substitution errors (80% of them low-qual, as base-call errors are) and
    0.05% N bases. Most pairs merge via the <=2 low-qual-diff tolerance;
    ~15% fail merge (a high-qual error in the overlap) and take the
    two-lane unmerged path.

    Composition: 70% on-target single-gene fragments from `genes`,
    `junction_frac` random two-gene chimeras (at most the remaining 30%)
    and off-target fragments.
    Each (a, b) in `planted` adds `n_support` pairs across one fixed
    junction, the middle of gene a joined to the middle of gene b, with
    staggered fragment starts, so that it is reported as a fusion.
    """
    from ..core.sequence import COMPLEMENT_LUT

    if not 0 <= junction_frac <= 0.3:
        raise ValueError("junction_frac must lie in [0, 0.3] (the off-target share)")
    rng = np.random.default_rng(seed)
    n_planted = len(planted) * n_support
    n_rand = n - n_planted
    lens = np.clip(
        np.rint(rng.normal(_INSERT_MEAN, _INSERT_SD, n)), read_len + 1, 200
    ).astype(np.int64)
    lmax = int(lens.max())

    n_on = int(n_rand * 0.70)
    n_junc = max(1, int(n_rand * junction_frac))
    n_off = n_rand - n_on - n_junc
    offtarget = random_seq(rng, 200000)
    frags = []
    for i in range(n_on):
        L = int(lens[i])
        s = genes[int(rng.integers(len(genes)))]
        off = int(rng.integers(0, max(1, len(s) - L)))
        frags.append(s[off : off + L].ljust(lmax, "A"))
    for i in range(n_on, n_on + n_off):
        L = int(lens[i])
        off = int(rng.integers(0, len(offtarget) - L))
        frags.append(offtarget[off : off + L].ljust(lmax, "A"))
    for i in range(n_on + n_off, n_rand):
        L = int(lens[i])
        s1 = genes[int(rng.integers(len(genes)))]
        s2 = genes[int(rng.integers(len(genes)))]
        o1 = int(rng.integers(0, len(s1) - L))
        o2 = int(rng.integers(0, len(s2) - L))
        frags.append((s1[o1 : o1 + L // 2] + s2[o2 : o2 + L - L // 2]).ljust(lmax, "A"))
    i = n_rand
    for a, b in planted:
        s1, s2 = genes[a], genes[b]
        b1, b2 = len(s1) // 2, len(s2) // 2
        for k in range(n_support):
            L = int(lens[i])
            left = L // 2 - 12 + 5 * k
            frags.append((s1[b1 - left : b1] + s2[b2 : b2 + L - left]).ljust(lmax, "A"))
            i += 1
    order = rng.permutation(n)
    frags = [frags[i] for i in order]
    lens = lens[order]

    buf = np.frombuffer("".join(frags).encode(), np.uint8).reshape(n, lmax)
    b1 = buf[:, :read_len].copy()
    # R2 = reverse complement of the fragment's last read_len bases
    idx2 = lens[:, None] - read_len + np.arange(read_len)[None, :]
    b2 = COMPLEMENT_LUT[np.take_along_axis(buf, idx2, 1)][:, ::-1].copy()

    base_idx = np.zeros(256, np.uint8)
    base_idx[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def corrupt(b):
        q = rng.choice(_QUAL_CHARS, p=_QUAL_P, size=b.shape)
        err = rng.random(b.shape) < _SUB_ERR_RATE
        sub = rng.integers(1, 4, b.shape).astype(np.uint8)
        b2_ = np.where(err, bases[(base_idx[b] + sub) % 4], b)
        q = np.where(err & (rng.random(b.shape) < _ERR_LOWQ_FRAC), ord("/"), q)
        nmask = rng.random(b.shape) < _N_RATE
        b2_ = np.where(nmask, ord("N"), b2_)
        q = np.where(nmask, ord("#"), q)
        return np.ascontiguousarray(b2_), np.ascontiguousarray(q.astype(np.uint8))

    b1, q1 = corrupt(b1)
    b2, q2 = corrupt(b2)
    rl = np.full(n, read_len, np.int32)
    return MatrixPairs(
        MatrixReads(b1, q1, rl.copy(), "L"), MatrixReads(b2, q2, rl.copy(), "R")
    )
