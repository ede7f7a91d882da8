"""Chip smoke: drive the fusion scan end to end on the GPU through the CLI.

    python chip_smoke.py           # one GPU: phases a-e
    python chip_smoke.py --four    # four GPUs: the multi-device paths only

Everything runs in this one process: `cli.main` is called in-process,
because a second JAX process on the card would find its memory taken. The
panel and reads are generated from fixed seeds into `smoke_out/data` beside
this script, which is removed at the end; reports and run logs stay in
`smoke_out/`. Lines starting
with "# " carry each phase's checks and smoke timings (bring-up figures,
not benchmark metrics). Only when every phase passed, the last line of
stdout is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases of the one-GPU run:
  a. device check: platform, kind and count as JAX reports them, the
     card's name and power limit from nvidia-smi, the native host library
     and its build key.
  b. full-size paired run: the 136-gene, 15.2 Mbp bench panel and 524,288
     'real'-profile 151 bp pairs (8 batches of 65536) with 8 planted
     fusions of 6 supporting pairs each, as FASTA/CSV/FASTQ files through
     `-1 -2 -f -r -h -j --index-cache`. Every planted fusion must be
     reported.
  c. oracle parity: a 32,768-pair subsample with 4% junction pairs, enough
     to pass more than the 1024-survivor cap of one batch (so the overflow
     path runs) and 512 edit-distance jobs (so they run on the device).
     `--engine device` paired and single-end and `--engine sharded-index
     --mesh 1` must write JSON and HTML byte-identical to `--engine host`,
     after masking the timestamp and the command line.
  d. multi-CSV batch mode: 4 sub-panel CSVs of unequal size on the same
     subsample, `--engine device` against `--engine host`, every per-CSV
     report byte-identical.
  e. device edit distance against the host Myers on 4096 pairs of widths
     151-301, exactly.

With --four: phase b's full-size run at `--mesh 4` against `--mesh 1`
(JSON identical, each card's peak memory printed), and phase c's subsample
through `--engine sharded-index --mesh 4` against `--engine host`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))

FULL_PAIRS = 524_288
SUB_PAIRS = 32_768
SUB_JUNCTION = 0.04
N_PLANTED = 8
N_SUPPORT = 6
ED_PAIRS = 4096
SUB_PANEL_SHARES = (0.4, 0.3, 0.2, 0.1)

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ [+-]\d{2}:?\d{2}")


class SmokeError(Exception):
    pass


def say(msg: str) -> None:
    print(f"# {msg}", flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (r.stdout.strip() or r.stderr.strip()).replace("\n", "; ")


def _mib(n) -> str:
    return "n/a" if n is None else f"{n / 2**20:.1f} MiB"


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


# ---------------- instrumentation ----------------


class _Timeline(logging.Handler):
    """The program's 'genefuse' log with arrival times, and the XLA
    compiles JAX logs (program name, seconds)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.events = []
        self.compiles = []
        self.cache_hits = 0

    def emit(self, rec):
        msg = rec.getMessage()
        if rec.name.startswith("jax"):
            m = re.search(r"Finished XLA compilation of (\S+) in ([0-9.]+) sec", msg)
            if m:
                self.compiles.append((m.group(1), float(m.group(2))))
            elif "cache hit" in msg.lower():
                self.cache_hits += 1
            return
        self.events.append((time.monotonic(), msg))

    def at(self, *prefixes):
        for t, msg in self.events:
            if msg.startswith(prefixes):
                return t
        return None

    def message(self, prefix):
        for _, msg in self.events:
            if msg.startswith(prefix):
                return msg
        return None


_JAX_LOGGERS = ("jax._src.dispatch", "jax._src.compiler", "jax._src.interpreters.pxla")


@contextlib.contextmanager
def timeline():
    import jax

    tl = _Timeline()
    saved = []
    lg = logging.getLogger("genefuse")
    lg.addHandler(tl)
    for name in _JAX_LOGGERS:
        jl = logging.getLogger(name)
        saved.append((jl, jl.level, jl.propagate))
        jl.setLevel(logging.DEBUG)
        jl.propagate = False
        jl.addHandler(tl)
    log_compiles = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)
    try:
        yield tl
    finally:
        jax.config.update("jax_log_compiles", log_compiles)
        lg.removeHandler(tl)
        for jl, level, prop in saved:
            jl.removeHandler(tl)
            jl.setLevel(level)
            jl.propagate = prop


@contextlib.contextmanager
def spy(obj, name: str):
    """Wrap obj.name so that its calls are recorded as (args, kwargs)."""
    orig = getattr(obj, name)
    calls = []

    def wrapper(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(obj, name, wrapper)
    try:
        yield calls
    finally:
        setattr(obj, name, orig)


def run_cli(argv, log_path: str) -> float:
    """cli.main(argv) in this process, its stdout to log_path; -> seconds."""
    from genefuserust_jax import cli

    t0 = time.monotonic()
    try:
        with open(log_path, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(argv)
    except SystemExit as e:
        raise SmokeError(f"cli exited with {e.code}; see {log_path}") from e
    if rc != 0:
        raise SmokeError(f"cli returned {rc}; see {log_path}")
    return time.monotonic() - t0


def masked(path: str) -> str:
    text = open(path).read()
    return _TS.sub("<time>", text).replace(" ".join(sys.argv), "<command>")


# ---------------- workload ----------------


def prepare(
    data: str,
    panel_mbp: float = 15.2,
    n_full: int = FULL_PAIRS,
    n_sub: int = SUB_PAIRS,
    sub_junction: float = SUB_JUNCTION,
    n_planted: int = N_PLANTED,
    n_support: int = N_SUPPORT,
    seed: int = 7,
):
    """Write the panel, the full read set, the subsample and the sub-panel
    CSVs under `data`. -> namespace of paths and the planted gene pairs."""
    import numpy as np

    from genefuserust_jax.utils.synthetic import (
        gene_seqs,
        make_bench_panel,
        real_profile_pairs,
        write_panel_files,
    )

    t0 = time.monotonic()
    os.makedirs(data, exist_ok=True)
    panel = make_bench_panel(panel_mbp)
    fa, csv = write_panel_files(panel, data)
    genes = gene_seqs(panel)
    names = [g[0] for g in panel.genes]
    pick = np.random.default_rng(seed).choice(len(genes), 2 * n_planted, replace=False)
    planted = [(int(pick[2 * i]), int(pick[2 * i + 1])) for i in range(n_planted)]
    w = types.SimpleNamespace(
        data=data, fa=fa, csv=csv, index_cache=os.path.join(data, "index"),
        planted=[(names[a], names[b]) for a, b in planted],
    )
    for tag, n, junc, rseed in (
        ("full", n_full, 0.001, seed + 1),
        ("sub", n_sub, sub_junction, seed + 2),
    ):
        pairs = real_profile_pairs(
            genes, n, seed=rseed, junction_frac=junc, planted=planted,
            n_support=n_support,
        )
        r1 = os.path.join(data, f"{tag}_R1.fq")
        r2 = os.path.join(data, f"{tag}_R2.fq")
        pairs.left.write_fastq(r1)
        pairs.right.write_fastq(r2)
        setattr(w, tag, (r1, r2))
    # unequal sub-panels: consecutive gene blocks of SUB_PANEL_SHARES
    blocks = re.split(r"(?m)^(?=>)", panel.csv_text)[1:]
    cuts = np.rint(np.cumsum((0,) + SUB_PANEL_SHARES) * len(blocks)).astype(int)
    csvs = []
    for k in range(len(SUB_PANEL_SHARES)):
        part = blocks[cuts[k] : max(cuts[k + 1], cuts[k] + 1)]
        p = os.path.join(data, f"sub{k}.csv")
        with open(p, "w") as f:
            f.write("".join(part))
        csvs.append(p)
    w.csv_list = os.path.join(data, "csv_list.txt")
    with open(w.csv_list, "w") as f:
        f.write("".join(p + "\n" for p in csvs))
    w.sub_csv_stems = [os.path.splitext(os.path.basename(p))[0] for p in csvs]
    say(
        f"data: {len(panel.genes)} genes / {sum(e - s for _, _, s, e in panel.genes)} bp, "
        f"{n_full} + {n_sub} pairs, {n_planted} planted fusions, "
        f"{len(csvs)} sub-panels of {[cuts[k + 1] - cuts[k] for k in range(len(csvs))]} genes; "
        f"generated in {time.monotonic() - t0:.1f} s"
    )
    return w


def cli_args(w, reads, out_stem, engine="device", mesh=None, fusion=None):
    args = ["-1", reads[0]]
    if len(reads) > 1:
        args += ["-2", reads[1]]
    args += [
        "-f", fusion or w.csv, "-r", w.fa,
        "-h", out_stem + ".html", "-j", out_stem + ".json",
        "--index-cache", w.index_cache, "--engine", engine,
    ]
    if mesh is not None:
        args += ["--mesh", str(mesh)]
    return args


# ---------------- phases ----------------


def phase_device() -> None:
    """a. What the run is on."""
    import jax

    from genefuserust_jax import native

    devs = jax.devices()
    say(
        f"a. device: platform {devs[0].platform}, kind {devs[0].device_kind}, "
        f"count {len(devs)}"
    )
    say(f"a. nvidia-smi name, power.limit: {nvidia_smi()}")
    if not native.available():
        raise SmokeError("native host library did not build or load")
    say(f"a. native host library ready, build key {native.build_key()}")


def _report_fusions(json_path: str):
    with open(json_path) as f:
        report = json.load(f)
    return {
        frozenset((v["left"]["gene_name"], v["right"]["gene_name"]))
        for v in report["fusions"].values()
    }


def phase_full(w, out: str, mesh=None, tag="b") -> str:
    """b. The deployment-size paired run; -> the masked JSON report."""
    import jax

    from genefuserust_jax.ops import fused

    stem = os.path.join(out, f"{tag}_full" + (f"_mesh{mesh}" if mesh else ""))
    with timeline() as tl, spy(fused, "fused_scan_lanes") as scans:
        t0 = time.monotonic()
        wall = run_cli(cli_args(w, w.full, stem, mesh=mesh), stem + ".log")
    found = _report_fusions(stem + ".json")
    missing = [p for p in w.planted if frozenset(p) not in found]
    if missing:
        raise SmokeError(f"{tag}: planted fusions not reported: {missing}")
    say(f"{tag}. all {len(w.planted)} planted fusions reported ({len(found)} fusions in all)")
    t_index = tl.at("mapper indexing done.", "index cache hit")
    t_pack = tl.at("device index ready")
    t_scan = tl.at("sequence number before filtering")
    if None in (t_index, t_pack, t_scan):
        raise SmokeError(f"{tag}: expected log lines missing; see {stem}.log")
    compile_s = sum(s for _, s in tl.compiles)
    say(
        f"{tag}. smoke timings: index build {t_index - t0:.1f} s (FASTA read + "
        f"k-mer index), pack+upload {t_pack - t_index:.1f} s, scan "
        f"{t_scan - t_pack:.1f} s (XLA compile {compile_s:.1f} s within), "
        f"filter+cluster+reports {t0 + wall - t_scan:.1f} s; CLI wall {wall:.1f} s"
    )
    for prefix in ("device engine:", "device index ready", "device fetches:"):
        say(f"{tag}. log: {tl.message(prefix)}")
    progs = {}
    for name, s in tl.compiles:
        progs.setdefault(name, []).append(s)
    say(
        f"{tag}. {len(tl.compiles)} programs compiled, {tl.cache_hits} compile-cache hits: "
        + ", ".join(
            f"{n} x{len(v)} {sum(v):.1f} s"
            for n, v in sorted(progs.items(), key=lambda kv: -sum(kv[1]))
            if sum(v) >= 0.5
        )
    )
    if mesh in (None, 1):
        _scan_memory(scans, tag)
    peaks = [peak_bytes(d) for d in jax.devices()]
    say(f"{tag}. peak_bytes_in_use per device: {[_mib(p) for p in peaks]}")
    return masked(stem + ".json")


def _scan_memory(scans, tag: str) -> None:
    """compiled.memory_analysis() of each distinct fused-scan program."""
    import jax

    from genefuserust_jax.ops import fused

    seen = {}
    for a, k in scans:
        abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), a)
        key = (str(abstract), tuple(sorted(k.items())))
        seen.setdefault(key, (abstract, k))
    for abstract, k in seen.values():
        lanes = [tuple(b.shape) for b in abstract[0]]
        ma = fused.fused_scan_lanes.lower(*abstract, **k).compile().memory_analysis()
        say(
            f"{tag}. fused_scan_lanes lanes {lanes} cap {k['cap']}: "
            + (
                "memory_analysis unavailable"
                if ma is None
                else f"args {_mib(ma.argument_size_in_bytes)}, out "
                f"{_mib(ma.output_size_in_bytes)}, temp {_mib(ma.temp_size_in_bytes)}"
            )
        )


def run_sub(w, out: str, tag: str, engine: str, mesh=None, single_end=False):
    """One CLI run on the subsample; -> masked (JSON, HTML) texts."""
    stem = os.path.join(out, f"c_{tag}")
    reads = w.sub[:1] if single_end else w.sub
    wall = run_cli(cli_args(w, reads, stem, engine, mesh), stem + ".log")
    say(f"c. {tag}: {wall:.1f} s")
    return masked(stem + ".json"), masked(stem + ".html")


def phase_parity(w, out: str) -> None:
    """c. Device engines against the host oracle on the subsample."""
    from genefuserust_jax.ops import edit_distance
    from genefuserust_jax.parallel.engine import DeviceEngine

    host_pe = run_sub(w, out, "host_pe", "host")
    with spy(DeviceEngine, "_p2_overflow") as ovf, spy(
        edit_distance, "edit_distance_batch"
    ) as edb:
        dev_pe = run_sub(w, out, "device_pe", "device")
    say(
        f"c. device_pe: survivor-cap overflow ran {len(ovf)}x, device edit "
        f"distance ran {len(edb)}x"
    )
    if not ovf or not edb:
        raise SmokeError("c: the overflow path or device edit distance did not run")
    sharded = run_sub(w, out, "sharded_pe_mesh1", "sharded-index", mesh=1)
    host_se = run_sub(w, out, "host_se", "host", single_end=True)
    dev_se = run_sub(w, out, "device_se", "device", single_end=True)
    for tag, got, want in (
        ("device_pe", dev_pe, host_pe),
        ("sharded_pe_mesh1", sharded, host_pe),
        ("device_se", dev_se, host_se),
    ):
        _same(f"c. {tag}", got, want)
    say(f"c. {_n_fusions(host_pe[0])} fusions (paired), {_n_fusions(host_se[0])} (single-end)")


def _n_fusions(json_text: str) -> int:
    return len(json.loads(json_text)["fusions"])


def _same(tag: str, got, want) -> None:
    for kind, g, h in zip(("JSON", "HTML"), got, want):
        if g != h:
            raise SmokeError(f"{tag}: {kind} differs from the host oracle")
    say(f"{tag}: JSON and HTML byte-identical to the host oracle")


def phase_sharded(w, out: str, mesh: int) -> None:
    """--four: the contig-sharded index over `mesh` devices vs the host."""
    tag = f"sharded_pe_mesh{mesh}"
    _same(
        f"c. {tag}",
        run_sub(w, out, tag, "sharded-index", mesh),
        run_sub(w, out, "host_pe", "host"),
    )


def phase_multi_csv(w, out: str) -> None:
    """d. One read pass against 4 unequal sub-panels, device vs host."""
    for engine in ("device", "host"):
        stem = os.path.join(out, f"d_{engine}")
        wall = run_cli(
            cli_args(w, w.sub, stem, engine, fusion=w.csv_list), stem + ".log"
        )
        say(f"d. {engine}: {wall:.1f} s for {len(w.sub_csv_stems)} CSVs")
    for s in w.sub_csv_stems:
        got = [masked(os.path.join(out, f"d_device_{s}.{x}")) for x in ("json", "html")]
        want = [masked(os.path.join(out, f"d_host_{s}.{x}")) for x in ("json", "html")]
        _same(f"d. {s} ({_n_fusions(want[0])} fusions)", got, want)


def phase_edit_distance(n: int = ED_PAIRS, seed: int = 11) -> None:
    """e. Device Myers edit distance against the host implementation."""
    import numpy as np

    from genefuserust_jax.core.edit_distance import edit_distance
    from genefuserust_jax.ops import edit_distance as ed_ops
    from genefuserust_jax.parallel.ed_batch import EdBatcher

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        a = acgt[rng.integers(0, 4, int(rng.integers(151, 302)))]
        if i % 4 == 0:  # unrelated
            b = acgt[rng.integers(0, 4, int(rng.integers(151, 302)))]
        else:  # a few substitutions and indels
            b = a.copy()
            k = int(rng.integers(0, 12))
            b[rng.integers(0, len(b), k)] = acgt[rng.integers(0, 4, k)]
            cut = int(rng.integers(0, len(b) - 10))
            b = np.concatenate([b[:cut], b[cut + int(rng.integers(0, 6)):]])
            if len(b) < 151:
                b = np.concatenate([b, acgt[rng.integers(0, 4, 151 - len(b))]])
        pairs.append((a.tobytes().decode(), b.tobytes().decode()))
    got = [None] * n
    batcher = EdBatcher(min_device_jobs=1)
    for i, (a, b) in enumerate(pairs):
        batcher.submit(a, b, lambda d, i=i: got.__setitem__(i, d))
    t0 = time.monotonic()
    with spy(ed_ops, "edit_distance_batch") as calls:
        batcher.flush()
    t_dev = time.monotonic() - t0
    t0 = time.monotonic()
    want = [edit_distance(a, b) for a, b in pairs]
    t_host = time.monotonic() - t0
    if not calls:
        raise SmokeError("e: the device edit-distance kernel did not run")
    bad = [i for i in range(n) if got[i] != want[i]]
    if bad:
        raise SmokeError(f"e: {len(bad)} of {n} distances differ, first at {bad[0]}")
    say(
        f"e. edit distance: {n} pairs of widths 151-301 equal the host "
        f"(distances {min(want)}-{max(want)}); device {t_dev:.2f} s incl. "
        f"compile, host {t_host:.2f} s"
    )


# ---------------- entry point ----------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the multi-device paths, on four GPUs",
    )
    args = ap.parse_args(argv)
    try:
        import jax

        from genefuserust_jax.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"# chip smoke: the program is not importable: {e}", file=sys.stderr)
        return 1
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"# chip smoke needs a GPU; JAX found {devs[0]}", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"# chip smoke needs {need} GPUs; JAX found {len(devs)}", file=sys.stderr)
        return 1
    enable_compile_cache()
    out = os.path.join(REPO, "smoke_out")
    data = os.path.join(out, "data")
    t0 = time.monotonic()
    try:
        phase_device()
        w = prepare(data)
        if args.four:
            four = phase_full(w, out, mesh=4)
            one = phase_full(w, out, mesh=1)
            if four != one:
                raise SmokeError("b: --mesh 4 JSON differs from --mesh 1")
            say("b. --mesh 4 JSON byte-identical to --mesh 1")
            phase_sharded(w, out, mesh=4)
        else:
            phase_full(w, out)
            phase_parity(w, out)
            phase_multi_csv(w, out)
            phase_edit_distance()
    except SmokeError as e:
        print(f"# FAILED: {e}", flush=True)
        return 1
    finally:
        shutil.rmtree(data, ignore_errors=True)
    say(f"all phases passed in {time.monotonic() - t0:.1f} s")
    say(f"card: {nvidia_smi()}")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
