"""Sharded-index engine: whole-genome panels across a device mesh.

Product wrapper around parallel/sharded_index.build_sharded_map_read for
panels whose packed k-mer tables outgrow one device's memory
(SURVEY §5 "long-context analog", the hg38 whole-genome case). The index
is partitioned by contig over the mesh's 'shard' axis; each read batch is
replicated, mapped per shard, and the shard-local top-2 votes / flag
masks are merged with the exactness argument documented in
parallel/sharded_index.py (equal to the single-device kernel bit-for-bit).

Reachable from the CLI via `--engine sharded-index` (+ `--mesh N` for the
shard count). The host pair decision tree matches pescanner.rs:427-518
exactly (same as core/scanner.scan_one_pair); map_read is the only device
call, so report equality with the host oracle follows from kernel
equality (tests/test_sharded_engine.py checks end-to-end anyway).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from ..config import KMER, Settings
from ..core.indexer import GenePos, SeqMatch
from ..core.read import SequenceRead

log = logging.getLogger("genefuse")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class ShardedIndexEngine:
    """Object-stream engine with a contig-sharded device index."""

    def __init__(self, settings: Settings, mesh=None, batch_size: int = 4096):
        import jax

        from .mesh import make_mesh

        self.settings = settings
        if mesh is None:
            mesh = make_mesh(jax.devices(), axis="shard")
        self.mesh = mesh
        self.n_shards = int(np.prod(mesh.devices.shape))
        self.batch_size = batch_size
        self._prepared_for = None
        self._fns = {}  # L -> jitted sharded map_read

    # ------------- index partitioning -------------

    def _prepare(self, mapper) -> None:
        if self._prepared_for is mapper:
            return
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .sharded_index import pack_index_sharded, stack_packs

        owner, packs = pack_index_sharded(mapper.indexer, self.n_shards)
        keys, vals, dupes, shift, max_dupe = stack_packs(packs)
        sh = NamedSharding(self.mesh, P(self.mesh.axis_names[0]))
        self._keys3 = jax.device_put(keys, sh)
        self._vals3 = jax.device_put(vals, sh)
        self._dupes4 = jax.device_put(dupes, sh)
        self._shift = shift
        self._max_dupe = max_dupe
        self._prepared_for = mapper
        self._fns = {}
        log.info(
            "sharded device index ready: %d shards x %d buckets (%.1f MB/shard)",
            self.n_shards,
            keys.shape[1],
            (keys.nbytes + vals.nbytes + dupes.nbytes) / self.n_shards / 1e6,
        )

    def _fn_for(self, L: int):
        f = self._fns.get(L)
        if f is None:
            from .sharded_index import build_sharded_map_read

            st = self.settings
            f = build_sharded_map_read(
                self.mesh, self._shift, self._max_dupe, L,
                st.major_gene_key_requirement, st.minor_gene_key_requirement,
                st.mismatch_threshold, axis=self.mesh.axis_names[0],
            )
            self._fns[L] = f
        return f

    # ------------- batched map_read -------------

    def _map_batch(self, seqs: List[str]):
        """-> per-seq list of SeqMatch (mapping) + mapable flags."""
        import jax.numpy as jnp

        from ..core.sequence import encode_bases

        n = len(seqs)
        L = _round_up(max(32, max((len(s) for s in seqs), default=32)), 32)
        pb = 8
        while pb < n:
            pb *= 2
        codes = np.full((pb, L), 255, np.uint8)
        lens = np.zeros(pb, np.int32)
        for i, s in enumerate(seqs):
            c = encode_bases(s)
            codes[i, : len(c)] = c
            lens[i] = len(c)
        sv, ss, se, sc, sp = self._fn_for(L)(
            jnp.asarray(codes), jnp.asarray(lens),
            self._keys3, self._vals3, self._dupes4,
        )
        sv = np.asarray(sv)
        ss = np.asarray(ss)
        se = np.asarray(se)
        sc = np.asarray(sc)
        sp = np.asarray(sp)
        out = []
        for i in range(n):
            segs = [
                SeqMatch(
                    int(ss[i, t]), int(se[i, t]),
                    GenePos(int(sc[i, t]), int(sp[i, t])),
                )
                for t in range(2)
                if bool(sv[i, t])
            ]
            out.append(segs)
        return out

    # ------------- object-stream API -------------

    def scan_pairs(self, mapper, pairs: Iterable) -> None:
        self._prepare(mapper)
        batch = []
        for pair in pairs:
            batch.append(pair)
            if len(batch) >= self.batch_size:
                self._scan_pair_batch(mapper, batch)
                batch = []
        if batch:
            self._scan_pair_batch(mapper, batch)

    def scan_singles(self, mapper, reads: Iterable) -> None:
        self._prepare(mapper)
        batch = []
        for r in reads:
            batch.append(r)
            if len(batch) >= self.batch_size:
                self._scan_single_batch(mapper, batch)
                batch = []
        if batch:
            self._scan_single_batch(mapper, batch)

    def _scan_pair_batch(self, mapper, pairs: List) -> None:
        """pescanner.rs:427-518 decision tree, with map_read batched."""
        from .ed_batch import EdBatcher

        merged = [p.fast_merge() for p in pairs]
        # lane work-list: (pair idx, lane, read) — lane 0 merged, 1/2 = R1/R2
        work: List[Tuple[int, int, SequenceRead]] = []
        for i, (p, m) in enumerate(zip(pairs, merged)):
            if m is not None:
                work.append((i, 0, m))
            else:
                work.append((i, 1, p.left))
                work.append((i, 2, p.right))
        segs = self._map_batch([r.seq for _, _, r in work])
        ed = EdBatcher()
        retries: List[Tuple[int, int, SequenceRead]] = []
        for (i, lane, r), mapping in zip(work, segs):
            if len(mapping) < 2:
                continue  # not mapable: no RC retry (pescanner.rs:448-454)
            if mapper.indexer.in_required_direction(mapping):
                m = mapper.make_match(r, mapping, ed_batcher=ed)
                m.original_reads = [pairs[i].left, pairs[i].right]
                mapper.add_match(m)
            else:
                retries.append((i, lane, r.reverse_complement()))
        if retries:
            rsegs = self._map_batch([r.seq for _, _, r in retries])
            for (i, lane, rc), mapping in zip(retries, rsegs):
                if len(mapping) < 2:
                    continue
                if not mapper.indexer.in_required_direction(mapping):
                    continue
                m = mapper.make_match(rc, mapping, ed_batcher=ed)
                m.original_reads = [pairs[i].left, pairs[i].right]
                if lane != 0:
                    # merged-lane RC matches keep reversed=False
                    # (faithful: pescanner.rs:465-468 vs :487-490)
                    m.reversed = True
                mapper.add_match(m)
        ed.flush()

    def _scan_single_batch(self, mapper, reads: List) -> None:
        from .ed_batch import EdBatcher

        segs = self._map_batch([r.seq for r in reads])
        ed = EdBatcher()
        retries: List[Tuple[int, SequenceRead]] = []
        for (r, mapping) in zip(reads, segs):
            if len(mapping) < 2:
                continue
            if mapper.indexer.in_required_direction(mapping):
                m = mapper.make_match(r, mapping, ed_batcher=ed)
                m.original_reads = [r]
                mapper.add_match(m)
            else:
                retries.append((r, r.reverse_complement()))
        if retries:
            rsegs = self._map_batch([rc.seq for _, rc in retries])
            for (r, rc), mapping in zip(retries, rsegs):
                if len(mapping) < 2:
                    continue
                if not mapper.indexer.in_required_direction(mapping):
                    continue
                m = mapper.make_match(rc, mapping, ed_batcher=ed)
                m.original_reads = [r]
                m.reversed = True
                mapper.add_match(m)
        ed.flush()
