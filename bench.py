"""Benchmark: paired-end scan throughput on one GPU, true engine path.

Workload: a cancer-panel-scale synthetic index (a seeded 136-gene, 15.2 Mbp
gene-span list on synthetic contigs, utils/synthetic.make_bench_panel) and
realistic targeted-capture read pairs (151bp 'real' profile, 70% on-target
single-gene, ~30% off-target, 0.1% fusion-junction).

Measures DeviceEngine.scan_pair_block end-to-end per batch: host merge,
lane compaction, device two-phase map_read (vote gate -> compacted
mask/segments), host assembly of matches. Prints ONE JSON line, naming the
device it ran on. Refuses to run without a GPU.

Baseline derivation (BASELINE.md row 5: reference binary, hg19 +
testdata/cancer.csv, 18.41 s on 8 cores): the reference's bench fastqs are
the OpenGene GeneFuse demo pair (~1.34M read pairs); 1.34e6/18.41 s ≈
72.8k pairs/s on a Ryzen 5800X. vs_baseline = our pairs/s / 72,800.

Panel fasta/csv, built index, packed tables and read blocks are cached
under .bench_cache/ after the first run; compiled programs go to the
persistent compile cache (utils/compile_cache.py).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from genefuserust_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from genefuserust_jax.utils.synthetic import (  # noqa: E402
    MatrixPairs,
    MatrixReads,
    write_panel_files,
)

BASELINE_PAIRS_PER_SEC = 72_800.0
CACHE = os.path.join(REPO, ".bench_cache")

# Always-on compile/cache accounting: every XLA compile and persistent-cache
# hit in the process is captured here and summarized into the bench JSON,
# so cold-start cost splits into compile vs first run vs scan.
COMPILE_LOG = {"compiles": [], "hits": 0, "block_cache": "n/a"}


def install_compile_capture():
    import logging

    class _Cap(logging.Handler):
        def emit(self, rec):
            try:
                m = rec.getMessage()
            except Exception:
                return
            if "Finished XLA compilation of" in m:
                mt = re.search(
                    r"Finished XLA compilation of (\S+?)[) ].* in ([0-9.]+) sec", m
                )
                if mt:
                    COMPILE_LOG["compiles"].append(
                        (mt.group(1).replace("jit(", ""), float(mt.group(2)))
                    )
            elif "compilation cache hit" in m:
                COMPILE_LOG["hits"] += 1

    h = _Cap()
    h.setLevel(logging.DEBUG)
    for name in ("jax._src.dispatch", "jax._src.compiler"):
        lg = logging.getLogger(name)
        lg.setLevel(logging.DEBUG)
        lg.addHandler(h)
        if not os.environ.get("GENEFUSE_BENCH_DEBUG_COMPILES"):
            lg.propagate = False


def device_info():
    """The device every bench record names: platform, kind and count."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def provenance(args=None):
    """Config/environment fields for the bench record: cross-run deltas
    (config vs regression) are not attributable without these."""
    import subprocess

    try:
        rev = subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except Exception:
        rev = ""
    import jax

    jc = jax.config.jax_compilation_cache_dir or ""
    try:
        n_jc = len(os.listdir(jc))
    except OSError:
        n_jc = 0
    p = {
        "git_rev": rev,
        "host_cores": os.cpu_count(),
        "parallel_compile": os.environ.get("GENEFUSE_PARALLEL_COMPILE", "4"),
        "jaxcache_entries_before": n_jc,
        "block_cache": COMPILE_LOG["block_cache"],
    }
    if args is not None:
        p["layout"] = args.layout
        p["kv_load"] = args.kv_load
    return p


def compile_summary(warmup_s=None):
    cs = COMPILE_LOG["compiles"]
    out = {
        "programs_compiled": len(cs),
        "compile_s": round(sum(t for _, t in cs), 1),
        "cache_hits": COMPILE_LOG["hits"],
        # list only the substantive programs (tiny probe/setup dispatches
        # like broadcast_in_dim clutter the record; their time is in
        # compile_s regardless)
        "programs": sorted({n for n, t in cs if t >= 1.0}),
    }
    if warmup_s is not None:
        # residual = first-execution program loads + the warmup scan itself
        out["load_exec_s"] = round(max(0.0, warmup_s - out["compile_s"]), 1)
    return out


def panel_dir(panel_mbp: float) -> str:
    """Cache directory of one synthetic panel and everything derived
    from it (packed tables, read blocks, FASTQ, split CSVs)."""
    return os.path.join(CACHE, f"panel_{panel_mbp:g}")


def panel_files(panel_mbp: float):
    """Write (once) and return paths of the synthetic panel ref.fa/panel.csv."""
    from genefuserust_jax.utils.synthetic import make_bench_panel

    d = panel_dir(panel_mbp)
    fa = os.path.join(d, "ref.fa")
    csv = os.path.join(d, "panel.csv")
    if os.path.exists(fa) and os.path.exists(csv):
        return fa, csv
    os.makedirs(d, exist_ok=True)
    return write_panel_files(make_bench_panel(panel_mbp), d)


def get_mapper(panel_mbp: float):
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.mapper import FusionMapper
    from genefuserust_jax.io import fasta

    fa, csv = panel_files(panel_mbp)
    contigs = fasta.read_all(fa, force_upper_case=False)
    return FusionMapper(
        contigs, csv, Settings(), index_cache_dir=CACHE, ref_file=fa
    )


# per-layout (cache-suffix, the load the bare suffix was cached at, the
# load used when --kv-load is not given). Load semantics are the packer's
# native target_load: keys/(buckets*slots) for kv8/kv4, keys/bucket for
# the single-probe layouts.
_LAYOUTS = {
    # v8/v6 cache-suffix bump: round-5 shape bucketing (pow4 nb grid,
    # dupe-row floor, pow2 pos_bias) changed the packed layouts
    "kv8": ("v5kv", 0.7, 0.9),
    "kv4": ("v7kv4", 0.6, 0.6),
    "kv2": ("v8kv2", 0.5, 0.5),
    "kvs": ("v6kvs", 1.0, 1.0),
    "kv16": ("v6kv16", 4.0, 4.0),
}


def get_packed(mapper, panel_mbp: float, layout: str = "kv8",
               kv_load: float = None):
    """Device table (PackedIndexKV 2-gather rows by default; kv4 narrow
    rows / kvs / kv16 single-probe layouts for --layout / --ab runs),
    mmap-cached. `kv_load` tunes the table's load factor (smaller table =
    faster gathers; None = the layout's default)."""
    import functools

    from genefuserust_jax.ops.hashtable import (
        PackedIndexKV, PackedIndexKV16, PackedIndexKVS,
        pack_index_kv, pack_index_kv16, pack_index_kvs,
    )

    cls, fn = {
        "kv16": (PackedIndexKV16, pack_index_kv16),
        "kvs": (PackedIndexKVS, pack_index_kvs),
        "kv8": (PackedIndexKV, pack_index_kv),
        "kv4": (PackedIndexKV, functools.partial(pack_index_kv, slots=2)),
        "kv2": (PackedIndexKV, functools.partial(pack_index_kv, slots=1)),
    }[layout]
    base_suffix, cache_default, layout_default = _LAYOUTS[layout]
    load = kv_load if kv_load is not None else layout_default
    suffix = base_suffix if load == cache_default else f"{base_suffix}_l{load:g}"
    builder = functools.partial(fn, target_load=load)
    base = os.path.join(panel_dir(panel_mbp), f"packed_{suffix}")
    if os.path.exists(base + "_meta.npy"):
        meta = np.load(base + "_meta.npy")
        return cls(
            np.load(base + "_kv.npy", mmap_mode="r"),
            np.load(base + "_dupes.npy", mmap_mode="r"),
            int(meta[0]), int(meta[1]), int(meta[2]),
            int(meta[3]), int(meta[4]), int(meta[5]),
        )
    t0 = time.time()
    packed = builder(mapper.indexer)
    assert packed is not None, "bench panel must fit the KV payload budget"
    print(
        f"# pack: {time.time() - t0:.1f}s, {packed.nbytes / 1e6:.0f} MB",
        file=sys.stderr,
    )
    np.save(base + "_kv.npy", packed.kv_tbl)
    np.save(base + "_dupes.npy", packed.dupes)
    np.save(
        base + "_meta.npy",
        np.array(
            [
                packed.n_buckets,
                packed.shift,
                packed.cbits,
                packed.pos_bias,
                packed.max_dupe,
                packed.empty_key,
            ],
            np.int64,
        ),
    )
    return packed


def gen_block_cached(mapper, panel_mbp: float, n: int, read_len: int,
                     profile: str, seed: int = 2):
    """mmap-cached gen_block: workload synthesis costs ~28 s per process
    at 524k pairs — pure fixed cost on the driver record. Arrays are
    cached per (panel, n, read_len, profile, seed) and memory-mapped."""
    base = os.path.join(
        panel_dir(panel_mbp), f"block_{n}_{read_len}_{profile}_{seed}"
    )
    names = ("b1", "q1", "l1", "b2", "q2", "l2")
    paths = [f"{base}_{x}.npy" for x in names]
    if all(os.path.exists(p) for p in paths):
        b1, q1, l1, b2, q2, l2 = (np.load(p, mmap_mode="r") for p in paths)
        COMPILE_LOG["block_cache"] = "hit"
        return MatrixPairs(MatrixReads(b1, q1, l1, "L"), MatrixReads(b2, q2, l2, "R"))
    blk = gen_block(mapper, n, read_len, seed=seed, profile=profile)
    os.makedirs(panel_dir(panel_mbp), exist_ok=True)
    for p, a in zip(
        paths,
        (blk.left.seq, blk.left.qual, blk.left.lens,
         blk.right.seq, blk.right.qual, blk.right.lens),
    ):
        np.save(p, a)
    COMPILE_LOG["block_cache"] = "miss"
    return blk


def gen_block(mapper, n: int, read_len: int = 150, seed: int = 2,
              profile: str = "real"):
    """Read-pair workload as matrices.

    Composition in both profiles: 70% on-target single-gene, ~30%
    off-target, 0.1% fusion-junction pairs.

    profile='real' — utils/synthetic.real_profile_pairs: the error,
    quality and insert-size model calibrated to the reference's shipped
    test reads, with its realistic mix of merge outcomes.

    profile='clean' — error-free fixed-length fragments (read_len+40),
    kept for perf A/B comparisons.
    """
    from genefuserust_jax.core.sequence import COMPLEMENT_LUT
    from genefuserust_jax.utils.synthetic import random_seq, real_profile_pairs

    gene_seqs = [s for s in mapper.indexer.fusion_seq if s]
    if profile == "real":
        return real_profile_pairs(gene_seqs, n, read_len, seed=seed)
    rng = np.random.default_rng(seed)
    frag_len = read_len + 40
    frags = []
    n_on = int(n * 0.70)
    n_junc = max(1, int(n * 0.001))
    n_off = n - n_on - n_junc
    offtarget = random_seq(rng, 200000)
    for _ in range(n_on):
        s = gene_seqs[int(rng.integers(len(gene_seqs)))]
        off = int(rng.integers(0, max(1, len(s) - frag_len)))
        frags.append(s[off : off + frag_len])
    for _ in range(n_off):
        off = int(rng.integers(0, len(offtarget) - frag_len))
        frags.append(offtarget[off : off + frag_len])
    for _ in range(n_junc):
        s1 = gene_seqs[int(rng.integers(len(gene_seqs)))]
        s2 = gene_seqs[int(rng.integers(len(gene_seqs)))]
        o1 = int(rng.integers(0, len(s1) - frag_len))
        o2 = int(rng.integers(0, len(s2) - frag_len))
        frags.append(s1[o1 : o1 + frag_len // 2] + s2[o2 : o2 + frag_len // 2])
    order = rng.permutation(n)
    frags = [frags[i] for i in order]
    buf = np.frombuffer("".join(frags).encode(), np.uint8).reshape(n, frag_len)
    b1 = buf[:, :read_len].copy()
    r2span = buf[:, frag_len - read_len :]
    b2 = COMPLEMENT_LUT[r2span][:, ::-1].copy()  # raw R2
    q1 = rng.integers(ord("5"), ord("J"), size=(n, read_len)).astype(np.uint8)
    q2 = rng.integers(ord("5"), ord("J"), size=(n, read_len)).astype(np.uint8)
    lens = np.full(n, read_len, np.int32)
    return MatrixPairs(
        MatrixReads(b1, q1, lens.copy(), "L"), MatrixReads(b2, q2, lens.copy(), "R")
    )


def split_panel_csvs(panel_mbp: float, n_csv: int):
    """Split the synthetic panel's genes into n_csv sub-panel CSVs
    (multi-CSV batch-mode workload, reference bench_res.md:79-92)."""
    fa, csv = panel_files(panel_mbp)
    lines = open(csv).read().splitlines(keepends=False)
    genes = []  # list of [header, exon lines...]
    for line in lines:
        if line.startswith(">"):
            genes.append([line])
        elif genes:
            genes[-1].append(line)
    paths = []
    for k in range(n_csv):
        part = genes[k::n_csv]
        p = os.path.join(panel_dir(panel_mbp), f"part{k}of{n_csv}.csv")
        with open(p, "w") as f:
            for g in part:
                f.write("\n".join(g) + "\n")
        paths.append(p)
    return fa, paths


def _multi_csv_mappers(args, n):
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.mapper import FusionMapper
    from genefuserust_jax.io import fasta

    fa, csv_paths = split_panel_csvs(args.panel_mbp, n)
    contigs = fasta.read_all(fa, force_upper_case=False)
    return [
        FusionMapper(contigs, p, Settings(), True, CACHE, fa) for p in csv_paths
    ]


def run_multi_csv_scale(args):
    """Amortization scaling curve: for N in 2/4/8/16,
    paired single-vs-N-CSV timings in ONE process -> pair-CSV-scans/s and
    speedup-vs-sequential per N. Shows where the shared merge+pack+upload
    amortization saturates. Writes .bench_cache/BENCH_MULTICSV_SCALE.json."""
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.scanner import finish_scan
    from genefuserust_jax.parallel.engine import DeviceEngine

    block = gen_block_cached(
        get_mapper(args.panel_mbp), args.panel_mbp, args.pairs, args.read_len,
        args.profile,
    )
    iters = min(args.iters, 3)
    curve = []
    for n in (2, 4, 8, 16):
        t0 = time.time()
        mappers = _multi_csv_mappers(args, n)
        engine = DeviceEngine(Settings(), batch_size=args.batch)
        for m in mappers:
            engine._prepare(m)
        setup = time.time() - t0
        t0 = time.time()
        engine.scan_pair_block_multi(mappers, block)
        engine.flush()
        engine.scan_pair_block_multi(mappers[:1], block)
        engine.flush()
        warm = time.time() - t0
        singles, multis = [], []
        for _ in range(iters):
            t0 = time.time()
            engine.scan_pair_block_multi(mappers[:1], block)
            engine.flush()
            singles.append(time.time() - t0)
            t0 = time.time()
            engine.scan_pair_block_multi(mappers, block)
            engine.flush()
            multis.append(time.time() - t0)
        for m in mappers:
            finish_scan(m, "", "", "bench", Settings())
        speedup = float(np.median([n * s / m for s, m in zip(singles, multis)]))
        rate = float(np.median([args.pairs * n / m for m in multis]))
        curve.append(
            {
                "n_csv": n,
                "pair_csv_scans_per_sec": round(rate, 1),
                "speedup_vs_sequential": round(speedup, 2),
                "setup_s": round(setup, 1),
                "warmup_s": round(warm, 1),
                "t_single_s": [round(s, 2) for s in singles],
                "t_multi_s": [round(m, 2) for m in multis],
            }
        )
        print(
            f"# N={n}: {rate:,.0f} pair-csv-scans/s, amortization "
            f"{speedup:.2f}x, warmup {warm:.1f}s",
            file=sys.stderr,
        )
    with open(os.path.join(CACHE, "BENCH_MULTICSV_SCALE.json"), "w") as f:
        json.dump(
            {
                "workload": {
                    "panel_mbp": args.panel_mbp,
                    "pairs": args.pairs,
                    "read_len": args.read_len,
                    "profile": args.profile,
                    "iters": iters,
                },
                "curve": curve,
                "warmup": compile_summary(),
                "provenance": provenance(args),
            },
            f,
            indent=1,
        )
    best = max(curve, key=lambda c: c["pair_csv_scans_per_sec"])
    print(
        json.dumps(
            {
                "metric": "pe_multi_csv_scale_best_pair_scans_per_sec",
                "value": best["pair_csv_scans_per_sec"],
                "unit": "pair-csv-scans/s",
                "vs_baseline": round(
                    best["pair_csv_scans_per_sec"] / BASELINE_PAIRS_PER_SEC, 3
                ),
                "curve": [
                    (c["n_csv"], c["pair_csv_scans_per_sec"],
                     c["speedup_vs_sequential"])
                    for c in curve
                ],
                "device": device_info(),
            }
        )
    )


def run_multi_csv(args):
    """Multi-CSV batch-mode throughput: one shared device pass (upload +
    merge + per-panel vote/mask pipelines) serves N panel CSVs at once —
    the reference's flagship workload (bench_res.md:79-92: 16 CSVs, hg38,
    its headline 3797% vs GeneFuse_Plus).

    Reports TWO metrics, medians over paired per-iteration timings
    (single-CSV and N-CSV alternate within one process, so drift hits both
    arms):
      - pe_multi{N}_csv_pair_scans_per_sec: pairs x CSVs / s — the batch
        mode's real unit of work (each pair is scanned against every CSV).
        vs_baseline compares against the 72.8k single-CSV bar, i.e. the
        value a user gets over running N independent single-CSV jobs on
        the reference.
      - pe_multi{N}_csv_speedup_vs_sequential: N*t_single/t_multi — how
        much the shared upload+merge amortization buys over our own
        sequential per-CSV scans.
    Persists both (plus the per-iter record) to .bench_cache/BENCH_MULTICSV.json.
    """
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.scanner import finish_scan
    from genefuserust_jax.parallel.engine import DeviceEngine

    n = args.multi_csv
    t0 = time.time()
    mappers = _multi_csv_mappers(args, n)
    print(f"# {n} mappers ready: {time.time() - t0:.1f}s", file=sys.stderr)
    engine = DeviceEngine(Settings(), batch_size=args.batch)
    for m in mappers:
        engine._prepare(m)
    print(f"# tables packed+uploaded: {time.time() - t0:.1f}s", file=sys.stderr)
    block = gen_block_cached(
        get_mapper(args.panel_mbp), args.panel_mbp, args.pairs, args.read_len,
        args.profile,
    )

    # warmup (compiles; covers every distinct per-CSV table shape)
    t0 = time.time()
    engine.scan_pair_block_multi(mappers, block)
    engine.flush()
    warmup_s = time.time() - t0
    wsum = compile_summary(warmup_s)
    print(
        f"# warmup: {warmup_s:.1f}s = compile {wsum['compile_s']}s "
        f"({wsum['programs_compiled']} programs, {wsum['cache_hits']} cache "
        f"hits) + load/exec {wsum['load_exec_s']}s", file=sys.stderr,
    )
    engine.scan_pair_block_multi(mappers[:1], block)
    engine.flush()

    singles, multis = [], []
    for _ in range(args.iters):
        t0 = time.time()
        engine.scan_pair_block_multi(mappers[:1], block)
        engine.flush()
        singles.append(time.time() - t0)
        t0 = time.time()
        engine.scan_pair_block_multi(mappers, block)
        engine.flush()
        multis.append(time.time() - t0)
    n_matches = sum(sum(len(b) for b in m.fusion_matches) for m in mappers)
    for m in mappers:
        finish_scan(m, "", "", "bench", Settings())
    speedups = [n * s / m for s, m in zip(singles, multis)]
    rates = [args.pairs * n / m for m in multis]
    speedup = float(np.median(speedups))
    rate = float(np.median(rates))
    print(
        f"# paired iters: single {[f'{s:.2f}' for s in singles]}s; "
        f"{n}-CSV {[f'{m:.2f}' for m in multis]}s; "
        f"speedups {[f'{x:.2f}' for x in speedups]}x; matches={n_matches}",
        file=sys.stderr,
    )
    records = [
        {
            "metric": f"pe_multi{n}_csv_pair_scans_per_sec",
            "value": round(rate, 1),
            "unit": "pair-csv-scans/s",
            "vs_baseline": round(rate / BASELINE_PAIRS_PER_SEC, 3),
        },
        {
            "metric": f"pe_multi{n}_csv_speedup_vs_sequential",
            "value": round(speedup, 2),
            "unit": "x",
            "vs_baseline": round(rate / BASELINE_PAIRS_PER_SEC, 3),
        },
    ]
    with open(os.path.join(CACHE, "BENCH_MULTICSV.json"), "w") as f:
        json.dump(
            {
                "workload": {
                    "panel_mbp": args.panel_mbp,
                    "n_csv": n,
                    "pairs": args.pairs,
                    "read_len": args.read_len,
                    "profile": args.profile,
                    "iters": args.iters,
                    "comparison_basis": "pairs*CSVs/s vs the 72.8k pairs/s "
                    "single-CSV reference bar (BASELINE.md row 5)",
                },
                "per_iter": {"t_single_s": singles, "t_multi_s": multis},
                "matches": n_matches,
                "metrics": records,
                "warmup_s": round(warmup_s, 1),
                "warmup": wsum,
                "provenance": provenance(args),
            },
            f,
            indent=1,
        )
    for r in records:
        print(json.dumps({**r, "device": device_info()}))


def fastq_files(args, mapper):
    """Write (once) the bench workload as real gzip-free FASTQ files so the
    --from-fastq mode exercises the PRODUCT input path (block FASTQ reader
    -> engine), not prebuilt matrices."""
    base = os.path.join(
        panel_dir(args.panel_mbp),
        f"reads_{args.profile}_{args.pairs}_{args.read_len}",
    )
    r1p, r2p = base + "_R1.fq", base + "_R2.fq"
    if os.path.exists(r1p) and os.path.exists(r2p):
        return r1p, r2p
    block = gen_block_cached(mapper, args.panel_mbp, args.pairs,
                             args.read_len, args.profile)
    block.left.write_fastq(r1p)
    block.right.write_fastq(r2p)
    return r1p, r2p


def run_from_fastq(args):
    """Product-path throughput: stream the workload from REAL FASTQ files
    through the block reader and engine (closes the 'bench bypasses FASTQ
    parsing' gap: this is what `python -m genefuserust_jax` does, minus
    argparse)."""
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.scanner import finish_scan
    from genefuserust_jax.io.fastq_block import (
        coalesce_pair_blocks, stream_pair_blocks,
    )
    from genefuserust_jax.parallel.engine import DeviceEngine

    mapper = get_mapper(args.panel_mbp)
    packed = get_packed(mapper, args.panel_mbp, args.layout, args.kv_load)
    r1p, r2p = fastq_files(args, mapper)
    engine = DeviceEngine(Settings(), batch_size=args.batch)
    engine.use_packed(packed, mapper)

    def one_pass():
        t0 = time.time()
        n = 0
        blocks = coalesce_pair_blocks(
            stream_pair_blocks(r1p, r2p), args.batch
        )
        for block in blocks:
            n += len(block)
            engine.scan_pair_block(mapper, block)
        engine.flush(mapper)
        return n, time.time() - t0

    # paired comparison: the fastq-vs-cached-pack comparison alternates
    # both arms within one process (same methodology as --ab) and reports
    # the paired ratio
    mem_block = gen_block_cached(mapper, args.panel_mbp, args.pairs,
                                  args.read_len, args.profile)

    def mem_pass():
        t0 = time.time()
        engine.scan_pair_block(mapper, mem_block)
        engine.flush(mapper)
        return args.pairs, time.time() - t0

    n, dt = one_pass()  # warmup: compile + OS page cache
    print(f"# warmup(compile): {dt:.1f}s, {n} pairs", file=sys.stderr)
    mem_pass()
    rates, mem_rates = [], []
    for _ in range(args.iters):
        n, dt = mem_pass()
        mem_rates.append(n / dt)
        n, dt = one_pass()
        rates.append(n / dt)
    import contextlib

    with contextlib.redirect_stdout(sys.stderr):
        # fusion text blocks go to stderr: bench stdout is ONE JSON line
        finish_scan(mapper, "", os.path.join(CACHE, "fastq_bench.json"),
                    "bench", Settings())
    pairs_per_sec = float(np.median(rates))
    mem_pps = float(np.median(mem_rates))
    ratios = [f / m for f, m in zip(rates, mem_rates)]
    ratio = float(np.median(ratios))
    print(
        f"# fastq-path: {[f'{r:,.0f}' for r in rates]} "
        f"(median {pairs_per_sec:,.0f})",
        file=sys.stderr,
    )
    print(
        f"# paired in-memory arm: {[f'{r:,.0f}' for r in mem_rates]} "
        f"(median {mem_pps:,.0f}); fastq/mem per-cycle ratios "
        f"{[f'{r:.2f}' for r in ratios]} (median {ratio:.3f})",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "pe_fastq_path_pairs_per_sec_per_chip",
                "value": round(pairs_per_sec, 1),
                "unit": "pairs/s",
                "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 3),
                "paired_mem_pairs_per_sec": round(mem_pps, 1),
                "fastq_over_mem_ratio": round(ratio, 3),
                "device": device_info(),
            }
        )
    )


def run_ab(args):
    """Interleaved A/B: cross-process layout comparisons are confounded by
    run-to-run drift, so this mode keeps every candidate table resident and
    alternates iterations A,B,A,B within one process. Spec: --ab 'kv8,kv8:0.9,kvs'
    (layout[:kv_load] comma-separated)."""
    from genefuserust_jax.config import Settings
    from genefuserust_jax.parallel.engine import DeviceEngine

    mapper = get_mapper(args.panel_mbp)
    specs = []
    for s in args.ab.split(","):
        layout, _, load = s.partition(":")
        specs.append((layout, float(load) if load else None))
    block = gen_block_cached(mapper, args.panel_mbp, args.pairs,
                              args.read_len, args.profile)
    engines, names, arm_matches = [], [], []
    for layout, load in specs:
        packed = get_packed(mapper, args.panel_mbp, layout, load)
        eng = DeviceEngine(Settings(), batch_size=args.batch)
        eng.use_packed(packed, mapper)
        name = f"{layout}:{load:g}" if load is not None else layout
        m0 = sum(len(b) for b in mapper.fusion_matches)
        t0 = time.time()
        eng.scan_pair_block(mapper, block)
        eng.flush(mapper)
        dm = sum(len(b) for b in mapper.fusion_matches) - m0
        print(
            f"# warmup {name} ({packed.nbytes / 1e6:.0f} MB): "
            f"{time.time() - t0:.1f}s, matches={dm}",
            file=sys.stderr,
        )
        engines.append(eng)
        names.append(name)
        arm_matches.append(dm)
    if len(set(arm_matches)) > 1:
        print(
            f"# WARNING: arms disagree on matches: "
            f"{dict(zip(names, arm_matches))}",
            file=sys.stderr,
        )
    rates = [[] for _ in specs]
    for _ in range(args.iters):
        for i, eng in enumerate(engines):
            t0 = time.time()
            eng.scan_pair_block(mapper, block)
            eng.flush(mapper)
            rates[i].append(args.pairs / (time.time() - t0))
    out = {}
    for name, rs in zip(names, rates):
        print(
            f"# {name}: {[f'{r:,.0f}' for r in rs]} "
            f"(median {np.median(rs):,.0f})",
            file=sys.stderr,
        )
        out[name] = round(float(np.median(rs)), 1)
    best = max(out, key=out.get)
    print(
        json.dumps(
            {
                "metric": "pe_ab_pairs_per_sec_per_chip",
                "value": out[best],
                "unit": "pairs/s",
                "vs_baseline": round(out[best] / BASELINE_PAIRS_PER_SEC, 3),
                "arms": out,
                "device": device_info(),
            }
        )
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--panel-mbp", type=float, default=15.2)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--pairs", type=int, default=None,
                    help="default: 1048576 for the single-scan and "
                    "--from-fastq modes (the reference's own bench jobs "
                    "are 1.34M pairs and short blocks leave the per-block "
                    "flush/fill bubble unamortized); "
                    "524288 for the multi-CSV modes (16x work per iter)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--read-len", type=int, default=None,
                    help="default: 151 (real profile) / 150 (clean)")
    ap.add_argument("--profile", choices=["real", "clean"], default="real",
                    help="read workload: 'real' = error/insert-size model "
                    "calibrated to the reference testdata (default); "
                    "'clean' = error-free fixed-length workload")
    ap.add_argument("--kv-load", type=float, default=None,
                    help="table target load factor (higher = smaller table "
                    "= cheaper gathers; default = the layout's own)")
    ap.add_argument("--layout", choices=["kv2", "kv4", "kv8", "kvs", "kv16"],
                    default="kv2",
                    help="device table layout: kv2 = 2-gather 2-wide rows "
                    "(default, the product's), kv4 = 2-gather 4-wide "
                    "rows, kv8/kvs/kv16 = A/B variants")
    ap.add_argument("--from-fastq", action="store_true",
                    help="stream the workload from real FASTQ files through "
                    "the product block reader instead of prebuilt matrices")
    ap.add_argument("--ab", type=str, default="",
                    help="interleaved A/B over table layouts, e.g. "
                    "'kv8,kv8:0.9,kvs' (paired comparison in one process)")
    ap.add_argument(
        "--multi-csv",
        type=int,
        default=0,
        help="N>0: run the N-CSV batch-mode bench instead of the single scan",
    )
    ap.add_argument(
        "--multi-csv-scale",
        action="store_true",
        help="run the N=2/4/8/16 amortization scaling curve "
        "(BENCH_MULTICSV_SCALE.json)",
    )
    args = ap.parse_args()
    if args.read_len is None:
        args.read_len = 151 if args.profile == "real" else 150
    if args.pairs is None:
        args.pairs = (
            524288 if (args.multi_csv or args.multi_csv_scale) else 1048576
        )

    import jax

    enable_compile_cache()
    proc_t0 = time.time()
    if jax.devices()[0].platform != "gpu":
        print(
            f"# bench.py measures the GPU; JAX found {jax.devices()[0]}",
            file=sys.stderr,
        )
        sys.exit(2)
    init_s = time.time() - proc_t0
    print(f"# device: {device_info()}", file=sys.stderr)
    try:
        # needed for the always-on compile accounting (install_compile_
        # capture): the per-compile elapsed-time lines carry the data
        jax.config.update("jax_log_compiles", True)
    except Exception:
        pass
    install_compile_capture()
    if os.environ.get("GENEFUSE_BENCH_DEBUG_COMPILES"):
        # Cold-start diagnosis mode: log every XLA compile (with elapsed
        # time) and every persistent-cache hit/miss so the warmup cost can
        # be attributed.
        import logging as _logging

        _h = _logging.StreamHandler(sys.stderr)
        _h.setFormatter(_logging.Formatter("# jaxlog %(name)s: %(message)s"))
        for name in ("jax._src.dispatch", "jax._src.compiler",
                     "jax._src.compilation_cache", "jax._src.interpreters.pxla"):
            lg = _logging.getLogger(name)
            lg.setLevel(_logging.DEBUG)
            lg.addHandler(_h)
        try:
            jax.config.update("jax_explain_cache_misses", True)
        except Exception:
            pass

    from genefuserust_jax.config import Settings
    from genefuserust_jax.parallel.engine import DeviceEngine

    if args.multi_csv_scale:
        run_multi_csv_scale(args)
        return
    if args.multi_csv > 0:
        run_multi_csv(args)
        return
    if args.ab:
        run_ab(args)
        return
    if args.from_fastq:
        run_from_fastq(args)
        return

    t0 = time.time()
    mapper = get_mapper(args.panel_mbp)
    packed = get_packed(mapper, args.panel_mbp, args.layout, args.kv_load)
    block = gen_block_cached(
        mapper, args.panel_mbp, args.pairs, args.read_len, args.profile
    )
    setup_s = time.time() - t0
    print(f"# mapper+index+block ready: {setup_s:.1f}s", file=sys.stderr)

    engine = DeviceEngine(Settings(), batch_size=args.batch)
    engine.use_packed(packed, mapper)

    # warmup: scan the WHOLE block once so every per-batch shape variant
    # (lane pads, width buckets, exception pads) is compiled/loaded before
    # the timed iterations — a fresh process pays executable reload per
    # variant otherwise, polluting the first iteration
    t0 = time.time()
    engine.scan_pair_block(mapper, block)
    engine.flush(mapper)
    warmup_s = time.time() - t0
    wsum = compile_summary(warmup_s)
    print(
        f"# warmup: {warmup_s:.1f}s = compile {wsum['compile_s']}s "
        f"({wsum['programs_compiled']} programs, {wsum['cache_hits']} cache "
        f"hits) + load/exec {wsum['load_exec_s']}s", file=sys.stderr,
    )

    n_matches0 = sum(len(b) for b in mapper.fusion_matches)
    # per-iteration timing, report the median
    rates = []
    for _ in range(args.iters):
        t0 = time.time()
        engine.scan_pair_block(mapper, block)
        engine.flush(mapper)
        rates.append(args.pairs / (time.time() - t0))
    n_matches = sum(len(b) for b in mapper.fusion_matches) - n_matches0
    pairs_per_sec = float(np.median(rates))
    print(
        f"# steady: {args.iters}x{args.pairs} pairs, per-iter "
        f"{[f'{r:,.0f}' for r in rates]} pairs/s "
        f"(median {pairs_per_sec:,.0f}), matches={n_matches}",
        file=sys.stderr,
    )
    wall_s = time.time() - proc_t0
    print(
        f"# wall: total {wall_s:.1f}s = init {init_s:.1f}s + setup "
        f"{setup_s:.1f}s + warmup {warmup_s:.1f}s + timed iters "
        f"{wall_s - init_s - setup_s - warmup_s:.1f}s",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "pe_pairs_per_sec_per_chip",
                "value": round(pairs_per_sec, 1),
                "unit": "pairs/s",
                "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 3),
                "pairs_per_iter": args.pairs,
                "wall_s": round(wall_s, 1),
                "init_s": round(init_s, 1),
                "setup_s": round(setup_s, 1),
                "warmup_s": round(warmup_s, 1),
                "warmup": wsum,
                "device": device_info(),
                "provenance": provenance(args),
            }
        )
    )


if __name__ == "__main__":
    main()
