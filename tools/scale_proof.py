"""Whole-genome scale proof (VERDICT r1 item 4).

Exercises the two genome-scale components at real scale and writes the
timings to SCALE.md:

  (a) the whole-genome Matcher build (core/matcher.py, reference
      matcher.rs:120-169) over a synthetic 1 Gbp genome — the memory-heavy
      structure behind remove_alignables on hg19/hg38;
  (b) a large panel (default 512 Mbp -> ~17 GB of split-layout tables)
      built, contig-sharded over an
      8-way mesh (parallel/sharded_index.py), and scanned end-to-end
      through the PRODUCT ShardedIndexEngine with a planted fusion that
      must be detected.

Run on the forced-CPU 8-device mesh (no accelerator needed; the sharding
logic is device-agnostic):

    JAX_PLATFORM_NAME=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scale_proof.py [--genome-mbp 1000] [--panel-mbp 512]
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, ".bench_cache")


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def gen_genome(mbp: float, n_contigs: int = 8, seed: int = 7):
    """Synthetic genome as in-memory contigs; includes a poly-A decoy
    region (random test genomes otherwise hit the reference Matcher's
    would-panic path — see utils/synthetic.py)."""
    from genefuserust_jax.utils.synthetic import random_seq

    rng = np.random.default_rng(seed)
    per = int(mbp * 1e6 / n_contigs)
    contigs = {}
    for c in range(n_contigs):
        s = random_seq(rng, per)
        if c == 0:
            s = s[:1000] + "A" * 400 + s[1400:]
        contigs[f"chr{c + 1}"] = s
    return contigs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=1000.0)
    ap.add_argument("--panel-mbp", type=float, default=256.0)
    ap.add_argument(
        "--skip-matcher",
        action="store_true",
        help="skip phase (a); paste its timings via --matcher-note",
    )
    ap.add_argument("--matcher-note", default="")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args()

    lines = [
        "# SCALE — whole-genome scale proof (round 4: parallel native builds)",
        "",
        f"Host: {os.uname().nodename}, RAM "
        f"{os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES') / 1e9:.0f} GB. "
        "Forced-CPU 8-device virtual mesh (sharding logic is device-agnostic).",
        "",
    ]

    # ---------- (a) whole-genome Matcher ----------
    t0 = time.time()
    contigs = gen_genome(args.genome_mbp)
    t_gen = time.time() - t0
    gbp = sum(len(s) for s in contigs.values()) / 1e9
    print(f"# genome: {gbp:.2f} Gbp in {t_gen:.0f}s, rss={rss_gb():.1f}GB",
          flush=True)

    if args.skip_matcher:
        lines += [
            "## (a) Whole-genome Matcher (remove_alignables backend)",
            "",
            args.matcher_note
            or "- (phase run separately; see recorded timings)",
            "",
        ]
    else:
        from genefuserust_jax.core.matcher import Matcher

        rng = np.random.default_rng(1)
        cands = []
        names = list(contigs)
        for _ in range(200):
            s = contigs[names[int(rng.integers(len(names)))]]
            off = int(rng.integers(0, len(s) - 150))
            cands.append(s[off : off + 150])
        t0 = time.time()
        matcher = Matcher(contigs, cands)
        t_build = time.time() - t0
        t0 = time.time()
        n_aln = sum(1 for s in cands[:50] if matcher.do_match(s) is not None)
        t_match = time.time() - t0
        print(
            f"# matcher: build {t_build:.0f}s, 50 do_match {t_match:.1f}s, "
            f"alignable={n_aln}, rss={rss_gb():.1f}GB",
            flush=True,
        )
        lines += [
            "## (a) Whole-genome Matcher (remove_alignables backend)",
            "",
            f"- genome: {gbp:.2f} Gbp synthetic ({len(contigs)} contigs), "
            f"generated in {t_gen:.0f}s",
            f"- `Matcher(contigs, 200 candidate reads)` build: **{t_build:.0f}s**, "
            f"peak RSS {rss_gb():.1f} GB",
            f"- 50 `do_match` queries: {t_match:.1f}s, alignable={n_aln} "
            "(quirk-faithful near-no-op, matcher.rs:810-885 mistranslation)",
            "",
        ]
        del matcher

    # ---------- (b) sharded whole-genome panel ----------
    import jax

    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.mapper import FusionMapper
    from genefuserust_jax.core.scanner import HostEngine, Scanner
    from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
    from genefuserust_jax.core.sequence import reverse_complement
    from genefuserust_jax.parallel.mesh import make_mesh
    from genefuserust_jax.parallel.sharded_engine import ShardedIndexEngine

    # panel CSV: tile genes over the first panel-mbp of the genome
    n_keep = int(args.panel_mbp * 1e6)
    csv_path = os.path.join(CACHE, f"scale_panel_{args.panel_mbp:g}.csv")
    gene_len = 2_000_000
    with open(csv_path, "w") as f:
        total = 0
        gid = 0
        for name, s in contigs.items():
            pos = 0
            while pos + gene_len <= len(s) and total < n_keep:
                f.write(f">G{gid:04d},{name}:{pos + 1}-{pos + gene_len}\n")
                f.write(f"1,{pos + 100},{pos + 400}\n")
                f.write(f"2,{pos + 1000},{pos + 1400}\n")
                gid += 1
                total += gene_len
                pos += gene_len
            if total >= n_keep:
                break
    print(f"# panel csv: {gid} genes, {total/1e6:.0f} Mbp", flush=True)

    t0 = time.time()
    mapper = FusionMapper(contigs, csv_path, Settings())
    t_index = time.time() - t0
    n_entries = len(mapper.indexer.uniq_keys)
    print(
        f"# make_index: {t_index:.0f}s, {n_entries/1e6:.0f}M unique kmers, "
        f"rss={rss_gb():.1f}GB",
        flush=True,
    )

    devices = jax.devices()[: args.shards]
    mesh = make_mesh(devices, axis="shard")
    engine = ShardedIndexEngine(Settings(), mesh=mesh, batch_size=64)
    t0 = time.time()
    engine._prepare(mapper)
    t_pack = time.time() - t0
    tbl_gb = (
        engine._keys3.nbytes + engine._vals3.nbytes + engine._dupes4.nbytes
    ) / 1e9
    print(
        f"# sharded pack: {t_pack:.0f}s, {tbl_gb:.1f}GB across "
        f"{args.shards} shards, rss={rss_gb():.1f}GB",
        flush=True,
    )

    # planted fusion: junction between two genes on different contigs
    rng = np.random.default_rng(1)
    g1 = contigs["chr1"]
    g2 = contigs["chr2"]
    fused = g1[500_000:500_150] + g2[700_000 : 700_000 + 150]
    pairs = []
    for k in range(6):
        frag = fused[k * 5 : k * 5 + 260]
        r1 = frag[:150]
        r2 = reverse_complement(frag[-150:])
        q = "I" * 150
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@p{k}", r1, "+", q),
                SequenceRead(f"@p{k} 2", r2, "+", q),
            )
        )
    for k in range(40):
        off = int(rng.integers(0, len(g1) - 260))
        frag = g1[off : off + 260]
        q = "I" * 150
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@b{k}", frag[:150], "+", q),
                SequenceRead(f"@b{k} 2", reverse_complement(frag[-150:]), "+", q),
            )
        )
    t0 = time.time()
    engine.scan_pairs(mapper, pairs)
    mapper.filter_matches()
    mapper.sort_matches()
    mapper.cluster_matches()
    t_scan = time.time() - t0
    n_fusions = len(mapper.fusion_results)
    print(f"# scan: {t_scan:.1f}s, fusions={n_fusions}", flush=True)
    assert n_fusions >= 1, "planted fusion not detected at scale"

    lines += [
        "## (b) Sharded whole-genome panel (product path)",
        "",
        f"- panel: {gid} genes / {total / 1e6:.0f} Mbp tiled over the genome",
        f"- `Indexer.make_index`: **{t_index:.0f}s**, "
        f"{n_entries / 1e6:.0f}M unique k-mers, peak RSS {rss_gb():.1f} GB",
        f"- contig-sharded pack + upload ({args.shards} shards): "
        f"**{t_pack:.0f}s**, {tbl_gb:.1f} GB of tables "
        f"({tbl_gb / args.shards:.1f} GB/shard; one 80 GB H100 holds "
        "this panel unsharded, but an hg38-scale whole-genome panel "
        "(3.2 Gbp, ~6.4G entries, ~77 GB of tables) leaves no room for "
        "batch buffers on one card and needs this sharding)",
        f"- planted-fusion scan through `--engine sharded-index`: "
        f"{t_scan:.1f}s, fusions detected: {n_fusions} (>=1 required)",
        "",
        "Conclusion: both genome-scale components run at Gbp scale; the "
        "sharded index is reachable from the product CLI "
        "(`--engine sharded-index --mesh N`).",
    ]
    with open(os.path.join(REPO, "SCALE.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("# SCALE.md written", flush=True)


if __name__ == "__main__":
    main()
