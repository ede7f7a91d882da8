"""Run driver: settings, command echo, timing, mode dispatch.

reference: src/genefuse.rs:14-87 and src/core/fusion_scan.rs:311-330
(single-CSV when the fusion file ends in .csv; otherwise the file is a LIST
of CSV paths -> multi-CSV mode with per-CSV reports named
`{stem}_{csv_stem}.{ext}`, logs suppressed during jobs).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from .config import Settings
from .version import GENEFUSE_VER

log = logging.getLogger("genefuse")


@dataclasses.dataclass
class RunConfig:
    r1_file: str
    r2_file: str
    fusion_file: str
    html: str
    json: str
    ref_file: str
    thread_num: Optional[int] = None
    settings: Settings = dataclasses.field(default_factory=Settings)
    engine: str = "device"
    index_cache_dir: str = ""
    mesh: str = "auto"  # 'auto' | chip count for data-parallel scanning


def init_logger() -> None:
    """stderr logging, reference pattern `[{d}] {T} {t} {l}>> {m}`
    (src/utils/logging.rs:7-40), root level INFO."""
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(
        logging.Formatter(
            "[%(asctime)s] %(threadName)s %(name)s %(levelname)s>> %(message)s"
        )
    )
    root = logging.getLogger("genefuse")
    if not root.handlers:
        root.addHandler(h)
    root.setLevel(logging.INFO)


def check_file_valid(path: str) -> None:
    """reference: src/utils/mod.rs:11-29."""
    if not os.path.isfile(path):
        print(f"ERROR: file '{path}' doesn't exist, quit now")
        raise SystemExit(-1)


def make_engine(kind: str, settings: Settings, mesh: str = "auto",
                thread_num=None):
    if kind == "host":
        from .core.scanner import HostEngine

        return HostEngine()
    if kind == "sharded-index":
        # contig-sharded index for panels beyond one device's memory
        import jax

        from .parallel.mesh import make_mesh
        from .parallel.sharded_engine import ShardedIndexEngine

        m = _resolve_mesh(mesh) or make_mesh(jax.devices()[:1], axis="shard")
        return ShardedIndexEngine(settings, mesh=m)
    from .parallel.engine import DeviceEngine

    # `-t N` maps to the number of in-flight batches (pipeline depth): the
    # device-pipeline analog of the reference's N scanner worker threads
    # (pescanner.rs:296-311) — it bounds how much host-side pack/assembly
    # work overlaps device compute, exactly as the thread count bounded
    # concurrent consumers there. Results are `-t`-independent (the match
    # bins are ordered by batch, not completion).
    return DeviceEngine(
        settings,
        mesh=_resolve_mesh(mesh),
        # -t maps to the in-flight batch bound; unset -> the tuned default
        pipeline_depth=(6 if thread_num is None else max(2, min(16, thread_num))),
    )


def _resolve_mesh(spec: str):
    """'auto' -> a data mesh over all local devices when more than one is
    available; 'N' -> a mesh over the first N devices; '1'/'' -> None
    (single-device flow, no sharding machinery)."""
    import jax

    devices = jax.devices()
    if spec in ("", "1"):
        return None
    if spec == "auto":
        n = len(devices)
    else:
        n = int(spec)
        if n > len(devices):
            print(
                f"ERROR: --mesh {n} requested but only {len(devices)} "
                "devices are available, quit now"
            )
            raise SystemExit(-1)
    if n <= 1:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(devices[:n])


def genefuse(config: RunConfig) -> None:
    init_logger()
    command = " ".join(sys.argv) if sys.argv else "genefuse-jax"
    check_file_valid(config.ref_file)
    check_file_valid(config.r1_file)
    if config.r2_file:
        check_file_valid(config.r2_file)
    if config.fusion_file:
        check_file_valid(config.fusion_file)
    print(f"\n# {command}\n")
    t0 = time.time()
    scan(config, command)
    print(f"# genefuse v{GENEFUSE_VER}, time used: {time.time() - t0} seconds\n")
    log.info("done")


def scan(config: RunConfig, command: str) -> None:
    from .io import fasta
    from .io.fastq import FastqReader, FastqReaderPair
    from .core.scanner import Scanner

    ext = Path(config.fusion_file).suffix
    engine = make_engine(
        config.engine, config.settings, config.mesh, config.thread_num
    )

    from .io.fastq_block import read_fastq_block, read_pair_block

    if ext == ".csv":
        contigs = fasta.read_all(config.ref_file, force_upper_case=False)
        scanner = Scanner(
            config.fusion_file,
            contigs,
            config.html,
            config.json,
            config.settings,
            engine,
            multi_csv_mode=False,
            command=command,
            index_cache_dir=config.index_cache_dir,
            ref_file=config.ref_file,
        )
        from .io.fastq_block import stream_fastq_blocks, stream_pair_blocks

        if config.r2_file:
            scanner.scan_pair_stream(
                stream_pair_blocks(config.r1_file, config.r2_file)
            )
        else:
            scanner.scan_single_stream(stream_fastq_blocks(config.r1_file))
        return

    # ---- multi-CSV mode (reference: fusion_scan.rs:62-188) ----
    contigs = fasta.read_all(config.ref_file, force_upper_case=False)
    log.info("Reading input seqeunces...")
    if config.r2_file:
        pairs = read_pair_block(config.r1_file, config.r2_file)
        reads = None
    else:
        reads = read_fastq_block(config.r1_file)
        pairs = None

    csv_paths = _read_csv_list(config.fusion_file)
    html_names = _report_names(config.html, csv_paths)
    json_names = _report_names(config.json, csv_paths)
    log.info(
        "Multi csv input mode enabled. Suppress all logging messages while "
        "doing jobs in parallel."
    )
    prev_level = logging.getLogger("genefuse").level
    logging.getLogger("genefuse").setLevel(logging.CRITICAL)
    from .utils.pbar import prepare_pbar_force, set_multi_csv_mode

    set_multi_csv_mode(True)
    pb = prepare_pbar_force(len(csv_paths))
    pb.set_message("Scanning fusions given in csv...")
    try:
        if pairs is not None and hasattr(engine, "scan_pair_block_multi"):
            # throughput mode: ONE device pass over the reads serves every
            # CSV (pack/upload/merge are panel-independent; see
            # DeviceEngine.scan_pair_block_multi). Reference analog: the outer
            # rayon pool of fusion_scan.rs:109-181.
            from .core.mapper import FusionMapper
            from .core.scanner import finish_scan

            mappers = [
                FusionMapper(
                    contigs,
                    csv,
                    config.settings,
                    multi_csv_mode=True,
                    index_cache_dir=config.index_cache_dir,
                    ref_file=config.ref_file,
                )
                for csv in csv_paths
            ]
            engine.scan_pair_block_multi(mappers, pairs)
            engine.flush()
            for i, mapper in enumerate(mappers):
                finish_scan(
                    mapper,
                    html_names[i] if html_names else "",
                    json_names[i] if json_names else "",
                    command,
                    config.settings,
                )
                pb.inc(1)
        else:
            for i, csv in enumerate(csv_paths):
                scanner = Scanner(
                    csv,
                    contigs,
                    html_names[i] if html_names else "",
                    json_names[i] if json_names else "",
                    config.settings,
                    engine,
                    multi_csv_mode=True,
                    command=command,
                    index_cache_dir=config.index_cache_dir,
                    ref_file=config.ref_file,
                )
                if pairs is not None:
                    scanner.scan_pair_block(pairs)
                else:
                    scanner.scan_single_block(reads)
                pb.inc(1)
    finally:
        pb.finish_and_clear()
        set_multi_csv_mode(False)
        logging.getLogger("genefuse").setLevel(prev_level)


def _read_csv_list(path: str) -> List[str]:
    """reference: fusion_scan.rs:253-280."""
    out = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if not os.path.isfile(s):
                print(f"Fusion csv file '{s}' was not found.", file=sys.stderr)
                raise SystemExit(-1)
            out.append(s)
    return out


def _report_names(report_file: str, csv_paths: List[str]) -> List[str]:
    """`{parent}/{stem}_{csv_stem}.{ext}` per CSV (fusion_scan.rs:190-251)."""
    if not report_file:
        return []
    p = Path(report_file)
    parent = str(p.parent) if str(p.parent) != "." else ""
    out = []
    for csv in csv_paths:
        name = f"{p.stem}_{Path(csv).stem}{p.suffix}"
        out.append(os.path.join(parent, name) if parent else name)
    return out
