"""genefuserust_jax — a JAX gene-fusion detection engine.

A from-scratch reimplementation of the capabilities of GeneFuseRust
(a Rust port of OpenGene/GeneFuse 0.8.0): k-mer-index-based detection of
gene fusions in NGS FASTQ reads against a fusion-gene panel (CSV) and a
reference FASTA.

Architecture (accelerator-first, not a port):
  - Host (Python/numpy): FASTA/FASTQ/CSV parsing, panel index *construction*,
    match filtering/clustering (tiny post-filter sets), HTML/JSON reporting.
  - Device (JAX/XLA): the per-read hot path — paired-end overlap
    merging, two-pass k-mer vote/mask mapping against the panel index
    (immutable device arrays + bucketed hash table), batched edit distance.
  - Scale-out (jax.sharding / shard_map): read batches data-parallel over a
    device mesh; per-shard match records gathered and merged on host with a
    deterministic (read_break desc, len asc, name desc) sort, reproducing the
    reference's determinism guarantee (reference: src/read_match.rs:203-229).

The exact output semantics (fusion titles, breakpoints, unique/total counts,
JSON/HTML layout) follow the reference byte-for-byte; every module docstring
cites the reference file:line it reproduces.
"""

import os as _os

# Large-allocation hygiene: numpy >=1.22 madvises MADV_HUGEPAGE on big
# mallocs; on hosts where THP compaction is slow this turns first-touch
# page faults into the dominant cost of every genome-scale build
# (measured here: 512 MB np.empty+fill 4-13 s with hugepages vs 0.27 s
# without — ~25-50x). Default it OFF for this process; honor an explicit
# user setting either way.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # numpy may already be imported by the embedding process
    if _os.environ["NUMPY_MADVISE_HUGEPAGE"] == "0":
        import numpy as _np  # noqa: F401

        try:
            from numpy._core import multiarray as _ma  # numpy 2.x
        except ImportError:  # pragma: no cover - numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
except Exception:  # pragma: no cover - never block import on tuning
    pass

from .version import GENEFUSE_VER

__all__ = ["GENEFUSE_VER"]
