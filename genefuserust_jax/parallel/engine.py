"""Device batch engine: host merge + one-dispatch device scan + host assembly.

Replaces the reference's producer/consumer thread pipeline
(src/core/pescanner.rs:296-425) with a batched device pipeline:

  producer thread: FASTQ byte matrices -> native C++ overlap-merge
        (gf_merge_pack_pe2, bit-exact with fast_merge / read.rs:313-440)
        -> width-bucketed lane compaction -> 2-bit code pack (+ non-ACGT
        exception list) -> upload. Quality scores
        never leave the host; the device only receives the code rows it
        will scan (merged lane at the batch's bucketed width, live
        unmerged lanes at read width).
  device (ONE dispatch, ops/fused.fused_scan_lanes): vote pass over the
        width-bucketed lanes -> on-device survivor compaction (stable sort by row) ->
        mask/segment pass over the first `cap` survivors. One small
        (cap+1, 13) fetch per batch; the full vote bitmap stays on device
        and is fetched only on (rare) capacity overflow.
  host assembly: segment -> direction check -> make_match + batched
        edit-distance verification -> match bins; direction-rejected rows
        accumulate into a DEFERRED batched RC retry (the only case the
        reference retries with the reverse complement —
        pescanner.rs:455-513), flushed at a threshold / engine flush.
  Assembly is readiness-gated: up to pipeline_depth batches ride the
  device/transfer pipe concurrently. The single-end path uses the same
  pipeline with one read lane.

This shape follows what each side does well: the vote/segment passes
are gather-bound device-memory work, while the overlap merge is branchy
byte work a CPU does at memory speed, and moving it host-side removes
the quality-class upload entirely. It is also the fewest-launches form:
one execute and one small fetch per batch.

Multi-CSV mode (reference: fusion_scan.rs:62-188 outer rayon pool): the
engine scans ONE read batch against MANY panels at once —
`scan_pair_block_multi` merges/packs/uploads each batch a single time
(stage 0 is panel-independent) and fans out per-panel scan dispatches and
assembly, so the per-batch host merge and upload cost is amortized across
all CSVs.

Semantics are identical to the scalar host oracle (cross-checked in
tests/test_engine_equality.py); only the schedule differs.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from ..config import KMER, MIN_OVERLAP, Settings
from ..core.indexer import GenePos, SeqMatch
from ..core.read import SequenceRead
from ..core.sequence import BASE_CODE_LUT

log = logging.getLogger("genefuse")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _Fetch:
    """Background device->host fetch: started at kernel issue time so stage
    advancement consumes an already-landed numpy array.

    `copy_to_host_async` starts the transfer as soon as the result is
    computed. The thread polls `is_ready()` in a sleep loop that releases
    the GIL before calling `np.asarray`: a plain `np.asarray` on a pending
    array holds the GIL for its whole wait, stalling the producer thread
    and other dispatches. An exception in the thread is raised from
    `get()`. `inflight_s` is the time from issue until the array landed
    on the host."""

    __slots__ = ("_arr", "_out", "_exc", "_thread", "inflight_s")

    def __init__(self, arr):
        self._arr = arr
        self._out = None
        self._exc = None
        self.inflight_s = 0.0
        if arr is None:
            self._thread = None
            return
        arr.copy_to_host_async()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        t0 = time.monotonic()
        try:
            while not self._arr.is_ready():
                time.sleep(0.004)
            self._out = np.asarray(self._arr)
        except Exception as e:  # surfaced from get(), not lost in the thread
            self._exc = e
        self.inflight_s = time.monotonic() - t0

    def get(self):
        if self._thread is None:
            return None
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._out


def _tokenize_bytes(strings: List[bytes], L: int) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.zeros((len(strings), L), np.uint8)
    lens = np.zeros(len(strings), np.int32)
    for i, s in enumerate(strings):
        n = len(s)
        arr[i, :n] = np.frombuffer(s, np.uint8)
        lens[i] = n
    return arr, lens


class DeviceEngine:
    """Batched engine; device selection follows JAX's default backend,
    which is logged once per engine.

    Several devices: pass a 1-D `jax.sharding.Mesh` (axis name "data") and
    the engine shards every read batch over it while replicating the index
    tables, in place of the reference's consumer thread pool
    (pescanner.rs:296-311). The kernels are batch-parallel, so
    jit's auto-SPMD partitioning runs them collective-free per shard; host
    compaction/assembly sees gathered summaries exactly as in the
    single-device flow, keeping results byte-identical (checked in
    tests/test_mesh_engine.py)."""

    def __init__(self, settings: Settings, batch_size: int = 65536, mesh=None,
                 pipeline_depth: int = 6):
        self.settings = settings
        self.batch_size = batch_size
        self.mesh = mesh
        # in-flight batch bound (the `-t` analog; see driver.make_engine)
        self.pipeline_depth = max(1, pipeline_depth)
        self._n_dev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
        self._batch_sharding = None
        self._repl_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            axis = mesh.axis_names[0]
            self._batch_sharding = NamedSharding(mesh, P(axis))
            self._repl_sharding = NamedSharding(mesh, P())
        self._prepared_for = None
        self._default_entry = None
        self._tables = {}  # id(mapper) -> table entry dict
        self._progress_t0 = None
        self._progress_n = 0
        self._queue = []
        self._producer = None  # pack/upload producer thread pool
        # producer parallelism: per-batch merge+pack+upload are
        # independent; batch ORDER is preserved by the per-batch futures
        # (the queue consumes each batch's own future), so >1 worker only
        # changes completion overlap, not results. Default 1 until the
        # GPU host measures more.
        self._producer_workers = int(
            os.environ.get("GENEFUSE_PRODUCER_WORKERS", "1")
        )
        # Deferred RC retries: direction-rejected survivors are rare (a
        # handful per batch) but a synchronous retry dispatch costs two
        # full device round trips mid-stage-3. Batch them per mapper and
        # flush at a threshold / engine flush; final output is order-invariant
        # (deterministic sort before clustering, read_match.rs:227 analog).
        self._retry_pend = {}  # id(mapper) -> (mapper, [(lane, rc, originals)])
        self._retry_flush_at = 4096
        # fused-scan survivor capacity: the one fetched matrix carries at
        # most this many vote-gate survivors per batch; beyond it the
        # (equality-tested) _p2_overflow path kicks in. Pass 2 and the
        # result fetch scale with the cap, and the vote gate passes only
        # ~100 rows/batch on the bench workload; 1024 keeps ~10x headroom
        # for junction-rich samples.
        self._surv_cap = 1024
        # opt-in wall-time decomposition: maps label -> [total_s, calls];
        # ~two time.time() calls per probe
        import os as _os

        self._timers = (
            {} if _os.environ.get("GENEFUSE_STAGE_TIMERS") else None
        )
        # Parallel first-compile: a NEW shape signature's jit call blocks
        # its calling thread for the full XLA compile; issued serially
        # from the scheduler thread, a cold start pays sum(compiles).
        # Routing unseen-/still-compiling-signature dispatches through a
        # small worker pool overlaps the compiles (XLA releases the GIL),
        # cutting the cold start toward max(compiles). Steady state is
        # untouched: ready
        # signatures dispatch inline. GENEFUSE_PARALLEL_COMPILE=0 opts out.
        _pc = _os.environ.get("GENEFUSE_PARALLEL_COMPILE", "4")
        self._compile_workers = 0 if _pc == "0" else max(1, int(_pc))
        self._compile_pool = None
        self._sig_ready = set()
        # shape-variant memos (see _pad_rows/_sticky_width): every distinct
        # program shape costs a full compile
        self._pad_memo = set()
        self._width_memo = set()
        # shape policy knobs (A/B-able per engine instance)
        self._pad_small_floor = 128  # pad floor for small lanes
        self._wlong_grid = 64  # long-merged lane width grid
        self._wshort_grid = 32  # short-merged lane width grid
        # device-fetch accounting, logged at flush:
        # [fetches, summed get() wait s, summed issue-to-landed s]
        self._fetch_stats = [0, 0.0, 0.0]
        import jax

        devs = list(mesh.devices.flat) if mesh is not None else jax.devices()[:1]
        log.info(
            "device engine: platform %s, %s, %d of %d devices",
            devs[0].platform, devs[0].device_kind, len(devs),
            len(jax.devices()),
        )

    def _timed(self, label, fn):
        """Run fn() and charge its wall time to `label` (no-op unless
        GENEFUSE_STAGE_TIMERS is set)."""
        if self._timers is None:
            return fn()
        import time as _time

        t0 = _time.time()
        r = fn()
        e = self._timers.setdefault(label, [0.0, 0])
        e[0] += _time.time() - t0
        e[1] += 1
        return r

    def _get(self, fetch: _Fetch):
        """fetch.get(), charging its blocking wait to the fetch stats."""
        t0 = time.monotonic()
        out = fetch.get()
        st = self._fetch_stats
        st[0] += 1
        st[1] += time.monotonic() - t0
        st[2] += fetch.inflight_s
        return out

    def _submit_producer(self, fn, *args):
        from concurrent.futures import ThreadPoolExecutor

        if self._producer is None:
            self._producer = ThreadPoolExecutor(
                max_workers=self._producer_workers
            )
        return self._producer.submit(fn, *args)

    def _put_batch(self, x):
        """Upload a batch-dim array (sharded over the mesh if present)."""
        import jax
        import jax.numpy as jnp

        if self._batch_sharding is None:
            return jnp.asarray(x)
        return jax.device_put(np.asarray(x), self._batch_sharding)

    def _put_repl(self, x):
        import jax
        import jax.numpy as jnp

        if self._repl_sharding is None:
            return jnp.asarray(x)
        return jax.device_put(np.asarray(x), self._repl_sharding)

    # ------------- index upload -------------

    def _entry_from_packed(self, packed) -> dict:
        """Upload a PackedIndex / PackedIndexKV; tables are replicated
        across the mesh (they are small vs HBM)."""
        if hasattr(packed, "kv_tbl"):
            keys = self._put_repl(packed.kv_tbl)
            vals = self._put_repl(np.zeros((1, 2), np.int32))  # unused
            # 16-wide rows = single-gather KV16; 8-wide single_probe = KVS;
            # plain 8-wide = 2-gather KV
            if packed.kv_tbl.shape[1] == 16:
                kv = 2
            elif getattr(packed, "single_probe", False):
                kv = 3
            else:
                kv = True
            statics = dict(
                shift=packed.shift, max_dupe=packed.max_dupe, kv=kv,
                cbits=packed.cbits, pos_bias=packed.pos_bias,
            )
        else:
            keys = self._put_repl(packed.keys_tbl)
            vals = self._put_repl(packed.vals_tbl)
            statics = dict(
                shift=packed.shift, max_dupe=packed.max_dupe, kv=False,
                cbits=0, pos_bias=0,
            )
        return dict(
            packed=packed,
            keys=keys,
            vals=vals,
            dupes=self._put_repl(packed.dupes),
            statics=statics,
        )

    def use_packed(self, packed, mapper=None) -> None:
        """Install a pre-built device index. With `mapper`, it is bound to
        that mapper immediately; without, it is consumed by the first
        mapper `_table_entry` sees (the historical next-prepared
        contract, now honored without callers poking privates)."""
        entry = self._entry_from_packed(packed)
        if mapper is not None:
            entry["mapper"] = mapper
            self._tables[id(mapper)] = entry
        else:
            self._default_entry = entry
            self._prepared_for = None

    def _table_entry(self, mapper) -> dict:
        # keyed by id(mapper); each entry pins the mapper so the id cannot
        # be recycled by a different FusionMapper while the entry lives
        key = id(mapper)
        e = self._tables.get(key)
        if e is not None:
            assert e.get("mapper") is mapper
            return e
        if self._default_entry is not None and (
            self._prepared_for is None or self._prepared_for is mapper
        ):
            e, self._default_entry = self._default_entry, None
            e["mapper"] = mapper
            self._tables[key] = e
            return e
        from ..ops.hashtable import build_packed_index

        packed = build_packed_index(mapper.indexer)
        e = self._entry_from_packed(packed)
        e["mapper"] = mapper
        self._tables[key] = e
        log.info(
            "device index ready: %d buckets, %.1f MB%s",
            packed.n_buckets,
            packed.nbytes / 1e6,
            " (kv rows)" if hasattr(packed, "kv_tbl") else "",
        )
        return e

    def _prepare(self, mapper) -> None:
        self._table_entry(mapper)

    def _pad_rows(self, n: int) -> int:
        """Compacted-kernel row padding: next power of two, refined down in
        quarter-pow2 steps (..., 3/4·2^k, 2^k). At most two compiled shape
        variants per octave, but up to 25% less dead gather work — which
        matters once realistic merge-failure rates split a batch across the
        merged and unmerged-lane kernels. Keeps at least one row per mesh
        device (quarter steps stay n_dev-divisible for pow2 meshes).

        Two compile guards on top (each DISTINCT program costs a full XLA
        compile, so shape-variant count drives the cold-start cost):
        - small-lane floor 128: tiny lanes (the long-merged tail, retry
          and overflow pads) would otherwise flicker across 48/64/96...
          per batch, compiling a fresh program each time; scanning <=128
          dead rows is orders of magnitude cheaper than one recompile.
        - sticky reuse: a pad size this engine has already emitted is
          reused for any later n it can hold (within 2x of the fresh
          pad), so repeated batches converge onto one program."""
        floor = max(8, self._n_dev)
        pb = floor
        while pb < n:
            pb *= 2
        step = pb // 4
        if step >= floor:
            while pb - step >= n:
                pb -= step
        if n <= self._pad_small_floor:
            pb = max(pb, self._pad_small_floor)
        # reuse window: at most ONE quarter-pow2 step above the fresh pad
        # (1.33x). A 2x window was tried first and let the unmerged lane
        # reuse the merged lane's 65536 pad for ~30k rows — doubling that
        # lane's gather volume (~8% of the scan) to save one compile.
        cands = [p for p in self._pad_memo if pb <= p and 3 * p <= 4 * pb]
        if cands:
            return min(cands)
        self._pad_memo.add(pb)
        return pb

    def _sticky_width(self, need: int, tol: int = 32) -> int:
        """Lane-width selection with compiled-width reuse: a width within
        `tol` columns above `need` that this engine already emitted is
        reused instead of compiling a new program (the extra columns cost
        ~tol/width more probes on that lane). Fresh widths are recorded."""
        cands = [w for w in self._width_memo if need <= w <= need + tol]
        if cands:
            return min(cands)
        self._width_memo.add(need)
        return need

    def _progress(self, n: int) -> None:
        """Scan progress: unknown-length 8Hz spinner with reads/s on a TTY
        (reference progress bars: src/aux/pbar.rs), throughput log lines
        otherwise."""
        import time

        from ..utils.pbar import prepare_pbar

        if self._progress_t0 is None:
            self._progress_t0 = time.time()
            self._pbar = prepare_pbar(0)
            self._pbar.set_message("scanning reads...")
        self._progress_n += n
        self._pbar.inc(n)
        dt = time.time() - self._progress_t0
        if (
            self._pbar.is_hidden()
            and dt > 0
            and self._progress_n % (self.batch_size * 8) < n
        ):
            log.info(
                "scanned %d reads (%.0f reads/s)", self._progress_n,
                self._progress_n / dt,
            )

    # ------------- public API: object streams -------------

    def scan_pairs(self, mapper, pairs: Iterable) -> None:
        self._prepare(mapper)
        batch: List = []
        for pair in pairs:
            batch.append(pair)
            if len(batch) >= self.batch_size:
                self._pairs_from_objects(mapper, batch)
                batch = []
        if batch:
            self._pairs_from_objects(mapper, batch)

    def scan_singles(self, mapper, reads: Iterable) -> None:
        self._prepare(mapper)
        batch: List = []
        for r in reads:
            batch.append(r)
            if len(batch) >= self.batch_size:
                self._singles_from_objects(mapper, batch)
                batch = []
        if batch:
            self._singles_from_objects(mapper, batch)

    # ------------- public API: block matrices -------------

    def scan_pair_block(self, mapper, block) -> None:
        """block: io.fastq_block.PairBlock."""
        self.scan_pair_block_multi([mapper], block)

    def scan_pair_block_multi(self, mappers: List, block) -> None:
        """Scan one pair block against MANY panels: per batch, one
        pack/upload/merge (panel-independent) fans out into per-panel
        pass1/pass2/assembly contexts (fusion_scan.rs:62-188 analog)."""
        for m in mappers:
            self._prepare(m)
        n = len(block)
        lb, rb = block.left, block.right
        for s in range(0, n, self.batch_size):
            e = min(n, s + self.batch_size)
            sl = slice(s, e)
            self._scan_pair_matrices(
                mappers,
                lb.seq[sl],
                lb.qual[sl],
                lb.lens[sl],
                rb.seq[sl],
                rb.qual[sl],
                rb.lens[sl],
                lambda i, s=s: (
                    block.left.read_obj(s + i),
                    block.right.read_obj(s + i),
                ),
            )

    def scan_single_block(self, mapper, rblock) -> None:
        self._prepare(mapper)
        n = len(rblock)
        for s in range(0, n, self.batch_size):
            e = min(n, s + self.batch_size)
            sl = slice(s, e)
            self._scan_single_matrices(
                mapper,
                rblock.seq[sl],
                rblock.lens[sl],
                lambda i, s=s: rblock.read_obj(s + i),
            )

    # ------------- object adapters -------------

    def _pairs_from_objects(self, mapper, pairs: List) -> None:
        Lr = _round_up(
            max(KMER, max(max(len(p.left.seq), len(p.right.seq)) for p in pairs)), 32
        )
        b1, l1 = _tokenize_bytes([p.left.seq.encode("latin-1") for p in pairs], Lr)
        q1, _ = _tokenize_bytes([p.left.quality.encode("latin-1") for p in pairs], Lr)
        b2, l2 = _tokenize_bytes([p.right.seq.encode("latin-1") for p in pairs], Lr)
        q2, _ = _tokenize_bytes([p.right.quality.encode("latin-1") for p in pairs], Lr)
        self._scan_pair_matrices(
            [mapper],
            b1,
            q1,
            l1,
            b2,
            q2,
            l2,
            lambda i: (pairs[i].left, pairs[i].right),
        )

    def _singles_from_objects(self, mapper, reads: List) -> None:
        Lr = _round_up(max(KMER, max(len(r.seq) for r in reads)), 32)
        rows, lens = _tokenize_bytes([r.seq.encode("latin-1") for r in reads], Lr)
        self._scan_single_matrices(mapper, rows, lens, lambda i: reads[i])

    # ------------- core batch processing -------------

    def _scan_pair_matrices(
        self, mappers: List, b1, q1, l1, b2, q2, l2, pair_obj: Callable
    ) -> None:
        """Paired-end pipeline entry: host merge on the producer thread ->
        one-dispatch scan -> readiness-gated assembly (see module
        docstring); engine.flush drains."""
        shared = dict(
            fut=self._submit_producer(
                self._st0_produce, b1, q1, l1, b2, q2, l2
            ),
            mappers=list(mappers),
            pair_obj=pair_obj,
            orig_B=b1.shape[0],
            fetched=False,
            merged_read_cache={},
        )
        self._enqueue_batch(shared, mappers)

    def _enqueue_batch(self, shared: dict, mappers: List) -> None:
        for j, m in enumerate(mappers):
            self._queue.append(
                dict(
                    stage=0,
                    mapper=m,
                    tbl=self._table_entry(m),
                    shared=shared,
                    count_progress=(j == len(mappers) - 1),
                )
            )
        # dispatch all older batches' scans (oldest first), then assemble
        # exactly those whose results have landed; the depth cap forces a
        # blocking assemble only when the pipe is truly saturated
        n_new = len(mappers)
        for c in list(self._queue[:-n_new]):
            if c["stage"] == 0:
                self._advance(c)
        depth = self.pipeline_depth * max(1, n_new)
        while self._queue and self._queue[0]["stage"] >= 1:
            c = self._queue[0]
            if c["stage"] >= self._N_STAGES:
                self._queue.pop(0)
                continue
            if self._scan_ready(c) or len(self._queue) > depth:
                self._advance(c)
            else:
                break

    def flush(self, mapper=None) -> None:
        from .ed_batch import EdBatcher

        while self._queue or any(v[1] for v in self._retry_pend.values()):
            # issue pending retry scans FIRST so their device round trips
            # ride the pipe concurrently with the queue drain below (the
            # old synchronous retry dispatch cost two blocking round
            # trips per block flush); draining assemblies may enqueue
            # fresh retries, hence the outer loop
            issued = []
            for k in list(self._retry_pend):
                m, items = self._retry_pend.pop(k)
                if items:
                    issued.append((m, self._retry_issue(m, items)))
            while self._queue:
                c = self._queue.pop(0)
                while c["stage"] < self._N_STAGES:
                    self._advance(c)
            for m, ctxs in issued:
                ed = EdBatcher()
                self._retry_assemble(m, ctxs, ed)
                ed.flush()
        n, wait_s, inflight_s = self._fetch_stats
        if n:
            log.info(
                "device fetches: %d, mean wait %.3f ms, mean in flight %.3f ms",
                n, 1e3 * wait_s / n, 1e3 * inflight_s / n,
            )

    # ---- stage 0: host merge + compact + pack + upload (panel-
    # independent; runs on the producer thread) ----

    def _st0_produce(self, b1, q1, l1, b2, q2, l2):
        """Host-side merge (native gf_merge_pack_pe, bit-exact with the
        fast_merge oracle) + compaction + 4-bit pack + upload. Quality
        scores never leave the host: the device only sees the code rows it
        will scan (merged lane at the batch's bucketed width, live unmerged
        lanes at read width) — under constrained host<->device bandwidth
        the upload is the pipeline's scarcest resource. Exotic rows are
        excluded from both lanes and routed to the scalar oracle by
        _fetch_merge on the main thread."""
        from .. import native

        l1 = np.asarray(l1, np.int32).copy()
        l2 = np.asarray(l2, np.int32).copy()
        # R1/R2 blocks may have different widths (independently parsed
        # files); pad both sides to a common L (floor 32 also guards the
        # MIN_OVERLAP/KMER loops against all-short batches)
        L = _round_up(max(32, b1.shape[1], b2.shape[1]), 32)
        if b1.shape[1] != b2.shape[1]:
            Lin = max(b1.shape[1], b2.shape[1])

            def padw_in(a):
                if a.shape[1] == Lin:
                    return a
                out = np.zeros((a.shape[0], Lin), a.dtype)
                out[:, : a.shape[1]] = a
                return out

            b1, q1, b2, q2 = padw_in(b1), padw_in(q1), padw_in(b2), padw_in(q2)
        res = self._timed(
            "st0.merge_pack",
            lambda: native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L),
        )
        if res is None:  # pure-Python fallback (oracle fast_merge per row)
            res = native.merge_pack_pe_fallback(b1, q1, b2, q2, l1, l2, L)
        m_flag = res["m_flag"]
        m_len = res["m_len"]
        rwork = res["rwork"]
        rows_m = np.nonzero(m_flag)[0]
        n_m = len(rows_m)
        n_u = len(rwork)
        w4 = (L + 3) // 4
        mbuf, ubuf = res["mbuf"], res["ubuf"]
        lens_m = m_len[rows_m]
        # merged-lane length bucketing: a row costs samples(lane width)
        # probes regardless of its true length, so merged rows split into
        # a p95 width bucket and a max-width bucket (both rounded up to
        # bound compiled-shape variants); with tight insert-size
        # distributions the long lane holds only the tail
        if n_m:
            # Wlong rides a 64-column grid with sticky reuse: a per-batch
            # max-derived 32-grid width was the main source of recompiled
            # program variants, while pinning it to the structural maximum
            # (2L-MIN_OVERLAP) makes every survivor pay the widest lane
            # (pass 2 unifies survivor rows to max(widths)). The
            # 64-grid + stickiness converges to at most 2 values per
            # workload while tracking the actual insert-size tail.
            Wcap = _round_up(
                max(KMER, min(2 * L - MIN_OVERLAP, 4 * mbuf.shape[1])), 32
            )
            g = self._wlong_grid
            Wlong = min(
                Wcap,
                self._sticky_width(
                    _round_up(max(KMER, int(lens_m.max())), g), tol=g
                ),
            )
            gs = self._wshort_grid
            Wshort = min(
                Wlong,
                self._sticky_width(
                    _round_up(max(KMER, int(np.percentile(lens_m, 95))), gs),
                    tol=gs,
                ),
            )
        else:
            Wshort = Wlong = 32
        mask_s = lens_m <= Wshort
        sel_s = np.nonzero(mask_s)[0]
        sel_l = np.nonzero(~mask_s)[0]
        # lanes: (kind, sel into the compacted m/u buffers, width)
        lane_defs = [
            ("m", sel_s, Wshort),
            ("m", sel_l, Wlong),
            ("u", np.arange(n_u), L),
        ]
        lane_meta = []
        bufs, lens_arrs = [], []
        offs = [0]
        # local position of each compacted mbuf row within its lane (for
        # exception remapping)
        m_pos = np.zeros(max(n_m, 1), np.int64)
        m_pos[sel_s] = np.arange(len(sel_s))
        m_pos[sel_l] = np.arange(len(sel_l))
        m_lane_off = np.zeros(max(n_m, 1), np.int64)
        for kind, sel, W in lane_defs:
            n_i = len(sel)
            P = self._pad_rows(n_i)
            wi4 = (W + 3) // 4
            buf = np.zeros((P, wi4), np.uint8)
            ln = np.zeros(P, np.int32)
            if kind == "m":
                if n_i:
                    wm = min(wi4, mbuf.shape[1])
                    buf[:n_i, :wm] = mbuf[sel][:, :wm]
                    ln[:n_i] = lens_m[sel]
                    m_lane_off[sel] = offs[-1]
                pair_rows = rows_m[sel]
            else:
                if n_i:
                    buf[:n_i] = ubuf
                    ln[:n_i] = rwork[:, 2]
                pair_rows = None
            lane_meta.append(
                dict(kind=kind, n=n_i, sel=sel, W=W, w4=wi4,
                     pair_rows=pair_rows, off=offs[-1])
            )
            bufs.append(buf)
            lens_arrs.append(ln)
            offs.append(offs[-1] + P)
        N = offs[-1]
        # non-ACGT exceptions remapped into the concat row space; pad
        # entries point past every lane and are scatter-dropped
        m_exc, u_exc = res["m_exc"], res["u_exc"]
        n_exc = len(m_exc) + len(u_exc)
        pe = max(32, self._pad_rows(n_exc))
        exc = np.full((pe, 2), max(Wlong, L), np.int32)
        exc[:, 0] = N
        if len(m_exc):
            exc[: len(m_exc), 0] = m_lane_off[m_exc[:, 0]] + m_pos[m_exc[:, 0]]
            exc[: len(m_exc), 1] = m_exc[:, 1]
        if len(u_exc):
            exc[len(m_exc) : n_exc, 0] = u_exc[:, 0] + offs[2]
            exc[len(m_exc) : n_exc, 1] = u_exc[:, 1]
        out = self._timed(
            "st0.upload",
            lambda: dict(
                bufs_d=tuple(self._put_batch(b) for b in bufs),
                lens_d=tuple(self._put_batch(x) for x in lens_arrs),
                exc_d=self._put_repl(exc),
            ),
        )
        out.update(
            rows_m=rows_m,
            m_len=m_len,
            rwork=rwork,
            exotic=res["exotic"],
            mbuf=mbuf,
            ubuf=ubuf,
            exc_np=exc[:n_exc],
            lane_meta=lane_meta,
            offs=offs,
            widths=tuple(w for _, _, w in lane_defs),
            n_m=n_m,
            n_u=n_u,
            L=L,
        )
        return out

    # Stage graph: 0 issue-scan -> 1 assemble -> 2 done. The whole device
    # scan (vote pass + survivor compaction + segment pass) is ONE
    # dispatch issued at stage 0; assembly is READINESS-GATED — the
    # scheduler only assembles a batch whose result matrix has actually
    # landed, letting up to `pipeline_depth` batches ride the
    # device/transfer pipe concurrently instead of stalling on a fixed
    # cadence.
    _N_STAGES = 2

    def _advance(self, c) -> None:
        if c["stage"] == 0:
            self._st1_issue_scan(c)
        elif c["stage"] == 1:
            self._st3_assemble(c)

    def _scan_ready(self, c) -> bool:
        fut = c.get("scan_fut")
        if fut is not None:
            if not fut.done():
                return False
            self._resolve_scan(c)
        f = c.get("scan_f")
        return f is None or f._thread is None or not f._thread.is_alive()

    def _resolve_scan(self, c) -> None:
        """Adopt the result of a pool-compiled scan dispatch (blocks if
        the compile is still running — only hit on flush / saturation)."""
        fut = c.pop("scan_fut", None)
        if fut is not None:
            c["scan_d"], c["okw_d"], c["scan_f"] = fut.result()

    def _fetch_merge(self, sh: dict) -> None:
        """Join the producer thread and route exotic rows to the scalar
        oracle — once per physical batch. (The merge itself, compaction,
        and uploads all happened on the producer thread.)"""
        if sh["fetched"]:
            return
        fut = sh.pop("fut")
        sh.update(self._timed("st1.producer_join", fut.result))
        # reads with bytes outside ACGTNacgtn go through the scalar oracle
        # (here, on the main thread, so match-bin append order stays
        # deterministic; the sort before clustering removes any remaining
        # order dependence)
        exotic = sh["exotic"]
        if exotic.any():
            from ..core.read import SequenceReadPair
            from ..core.scanner import scan_one_pair

            pair_obj = sh["pair_obj"]
            for i in np.nonzero(exotic)[0].tolist():
                lr = pair_obj(int(i))
                for m in sh["mappers"]:
                    scan_one_pair(m, SequenceReadPair(lr[0], lr[1]))
        sh["fetched"] = True

    # ---- stage 0 advance: join producer, issue the one-dispatch scan ----

    def _st1_issue_scan(self, c) -> None:
        from ..ops.fused import fused_scan_lanes

        st = self.settings
        sh = c["shared"]
        self._fetch_merge(sh)
        tbl = c["tbl"]
        c["scan_d"] = None
        c["okw_d"] = None
        if sh["n_m"] or sh["n_u"]:

            def call():
                return fused_scan_lanes(
                    sh["bufs_d"],
                    sh["lens_d"],
                    sh["exc_d"],
                    tbl["keys"],
                    tbl["vals"],
                    tbl["dupes"],
                    widths=sh["widths"],
                    cap=self._surv_cap,
                    major_req=st.major_gene_key_requirement,
                    minor_req=st.minor_gene_key_requirement,
                    mismatch_thr=st.mismatch_threshold,
                    **tbl["statics"],
                )

            sig = (
                tuple(b.shape for b in sh["bufs_d"]),
                sh["exc_d"].shape,
                sh["widths"],
                tuple(
                    x.shape
                    for x in (tbl["keys"], tbl["vals"], tbl["dupes"])
                    if x is not None
                ),
                tuple(sorted(tbl["statics"].items())),
            )
            if self._compile_workers and sig not in self._sig_ready:
                # first sight of this shape signature (or its compile is
                # still in flight): dispatch from a worker so the XLA
                # compile does not serialize behind the scheduler thread
                if self._compile_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._compile_pool = ThreadPoolExecutor(
                        max_workers=self._compile_workers,
                        thread_name_prefix="gf-compile",
                    )

                def call_fetch(sig=sig):
                    out_d, okw_d = call()
                    self._sig_ready.add(sig)
                    return out_d, okw_d, _Fetch(out_d)

                c["scan_fut"] = self._compile_pool.submit(call_fetch)
                c["stage"] = 1
                return
            out_d, okw_d = call()
            c["scan_d"] = out_d
            c["okw_d"] = okw_d  # fetched only on survivor-cap overflow
        c["scan_f"] = _Fetch(c["scan_d"])
        c["stage"] = 1

    @staticmethod
    def _locate(sh, sidx: int):
        """Map a concat-space survivor row to (pair_row, lane_flag) where
        lane_flag 0 = merged, 1 = R1, 2 = R2."""
        offs = sh["offs"]
        rw = sh["rwork"]
        for li, meta in enumerate(sh["lane_meta"]):
            if sidx < offs[li + 1]:
                local = sidx - offs[li]
                if meta["kind"] == "m":
                    return int(meta["pair_rows"][local]), 0
                return int(rw[local, 0]), int(rw[local, 1])
        raise IndexError(sidx)

    # ---- survivor-cap overflow: pass2 for survivors beyond `cap` ----

    def _p2_overflow(self, c, n_count: int):
        """Synchronous pass2 for survivors the fused scan's fixed capacity
        missed (needs the ok-bitmap fetch; rare — the cap is ~20x the
        observed survivor rate). Returns rows shaped like the scan body:
        [sidx, 1, valid0, valid1, s0, s1, e0, e1, c0, c1, p0, p1, 0]."""
        from ..ops.fused import fused_scan_lanes

        st = self.settings
        sh = c["shared"]
        tbl = c["tbl"]
        okw = np.asarray(c["okw_d"]).view(np.uint32)
        bits = np.unpackbits(
            okw.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little"
        ).reshape(-1)
        sidx_all = np.nonzero(bits)[0]
        tail = sidx_all[self._surv_cap :].astype(np.int64)
        assert len(tail) == n_count - self._surv_cap
        offs = sh["offs"]
        rw = sh["rwork"]
        W = max(sh["widths"])
        ws4 = (W + 3) // 4
        pb = self._pad_rows(len(tail))
        sbuf = np.zeros((pb, ws4), np.uint8)
        lens = np.zeros(pb, np.int32)
        for k, sidx in enumerate(tail.tolist()):
            for li, meta in enumerate(sh["lane_meta"]):
                if sidx < offs[li + 1]:
                    local = sidx - offs[li]
                    wi4 = meta["w4"]
                    if meta["kind"] == "m":
                        src = sh["mbuf"][meta["sel"][local]]
                        lens[k] = sh["m_len"][meta["pair_rows"][local]]
                    else:
                        src = sh["ubuf"][local]
                        lens[k] = rw[local, 2]
                    sbuf[k, : len(src[:wi4])] = src[:wi4]
                    break
        # remap this batch's non-ACGT exceptions onto the tail rows
        old_to_new = {int(t): k for k, t in enumerate(tail)}
        exc_list = [
            (old_to_new[int(r)], int(col))
            for r, col in sh["exc_np"]
            if int(r) in old_to_new
        ]
        pe = max(32, self._pad_rows(len(exc_list)))
        exc = np.full((pe, 2), W, np.int32)
        exc[:, 0] = pb + 8
        for k, (r, col) in enumerate(exc_list):
            exc[k] = (r, col)
        # the scan result does not carry per-row vote keys, so rerun
        # pass1+pass2 via the same scan kernel on just the tail rows
        # (identical votes -> identical segments)
        out_t, _ = fused_scan_lanes(
            (self._put_batch(sbuf),),
            (self._put_batch(lens),),
            self._put_repl(exc),
            tbl["keys"],
            tbl["vals"],
            tbl["dupes"],
            widths=(W,),
            cap=pb,
            major_req=st.major_gene_key_requirement,
            minor_req=st.minor_gene_key_requirement,
            mismatch_thr=st.mismatch_threshold,
            **tbl["statics"],
        )
        res = np.asarray(out_t)
        body = res[:-1]
        # map the tail-kernel's sidx (over the tail buffer) back to the
        # original concatenated row space
        rows = []
        for k in range(int(res[-1, 0])):
            r = body[k].copy()
            r[0] = tail[int(r[0])]
            rows.append(r)
        return rows

    # ---- stage 3: fetch the scan result, assemble matches ----

    def _st3_assemble(self, c) -> None:
        from ..core.read import SequenceReadPair
        from .ed_batch import EdBatcher

        self._resolve_scan(c)
        mapper = c["mapper"]
        sh = c["shared"]
        if sh.get("se"):
            read_at = sh["read_at"]

            def read_for(i: int, lane: int) -> SequenceRead:
                return read_at(i)

            def originals(i: int) -> List[SequenceRead]:
                return [read_at(i)]

        else:
            pair_obj = sh["pair_obj"]
            merged_read_cache = sh["merged_read_cache"]

            def merged_read(i: int) -> SequenceRead:
                if i not in merged_read_cache:
                    lr = pair_obj(i)
                    m = SequenceReadPair(lr[0], lr[1]).fast_merge()
                    assert m is not None, "device/host merge disagreement"
                    merged_read_cache[i] = m
                return merged_read_cache[i]

            def read_for(i: int, lane: int) -> SequenceRead:
                if lane == 0:
                    return merged_read(i)
                lr = pair_obj(i)
                return lr[0] if lane == 1 else lr[1]

            def originals(i: int) -> List[SequenceRead]:
                return list(pair_obj(i))

        ed = EdBatcher()
        retry: List[Tuple[int, int, SequenceRead]] = []
        if c["scan_d"] is not None:
            # (cap+1, 13)
            out = self._timed("st3.out_wait", lambda: self._get(c["scan_f"]))
            t_host = None if self._timers is None else __import__("time").time()
            n_count = int(out[-1, 0])
            rows = list(out[: min(n_count, self._surv_cap)])
            if n_count > self._surv_cap:
                rows.extend(self._p2_overflow(c, n_count))
            for r in rows:
                if not (r[2] and r[3]):
                    continue
                i, lane = self._locate(sh, int(r[0]))
                mapping = [
                    SeqMatch(
                        int(r[4 + t]),
                        int(r[6 + t]),
                        GenePos(int(r[8 + t]), int(r[10 + t])),
                    )
                    for t in range(2)
                ]
                if mapper.indexer.in_required_direction(mapping):
                    rd = read_for(i, lane)
                    m = mapper.make_match(rd, mapping, ed_batcher=ed)
                    m.original_reads = originals(i)
                    mapper.add_match(m)
                else:
                    retry.append((i, lane, read_for(i, lane).reverse_complement()))
            if t_host is not None:
                e = self._timers.setdefault("st3.survivor_loop", [0.0, 0])
                e[0] += __import__("time").time() - t_host
                e[1] += 1
        if retry:
            self._timed(
                "st3.retry_enqueue",
                lambda: self._enqueue_retries(
                    mapper,
                    [(lane, rc, originals(i)) for i, lane, rc in retry],
                ),
            )
        self._timed("st3.ed_flush", ed.flush)
        if c["count_progress"]:
            self._progress(sh["orig_B"])
        c["stage"] = 2

    def _enqueue_retries(self, mapper, items) -> None:
        """Queue [(lane, rc_read, originals)] for a later batched retry
        dispatch (originals are materialized so the source block can be
        dropped). Flushes when the pending set is large."""
        key = id(mapper)
        if key not in self._retry_pend:
            self._retry_pend[key] = (mapper, [])
        pend = self._retry_pend[key][1]
        pend.extend(items)
        if len(pend) >= self._retry_flush_at:
            self._drain_retries(mapper)

    def _drain_retries(self, mapper=None) -> None:
        from .ed_batch import EdBatcher

        keys = (
            list(self._retry_pend)
            if mapper is None
            else [id(mapper)]
        )
        for k in keys:
            entry = self._retry_pend.pop(k, None)
            if entry is None or not entry[1]:
                continue
            m, items = entry
            ed = EdBatcher()
            self._retry_assemble(m, self._retry_issue(m, items), ed)
            ed.flush()

    def _retry_issue(self, mapper, items):
        """Dispatch batched RC retries through the SAME single-lane fused
        scan used by _p2_overflow (identical votes/segments to the main
        kernel), replacing the old two-program map_read_pass1+pass2 route:
        one round trip instead of two, and two fewer distinct programs to
        compile at cold start.
        items: [(lane, rc_read, original_reads)]. Returns async ctxs for
        _retry_assemble; reference behavior: pescanner.rs:455-513 —
        direction-rejected reads are re-mapped reverse-complemented."""
        from ..ops.fused import fused_scan_lanes

        st = self.settings
        tbl = self._table_entry(mapper)
        ctxs = []
        CHUNK = self._retry_flush_at
        for s in range(0, len(items), CHUNK):
            ch = items[s : s + CHUNK]
            Lr = _round_up(max(KMER, max(len(r.seq) for _, r, _ in ch)), 32)
            W = self._sticky_width(Lr)
            rows, lens = _tokenize_bytes(
                [r.seq.encode("latin-1") for _, r, _ in ch], W
            )
            codes = BASE_CODE_LUT[rows]
            col = np.arange(codes.shape[1])[None, :]
            er, ec = np.nonzero((codes == 255) & (col < lens[:, None]))
            codes = np.where(codes == 255, 0, codes).astype(np.uint8)
            w4 = (W + 3) // 4
            if codes.shape[1] != 4 * w4:
                pad = np.zeros((len(ch), 4 * w4 - codes.shape[1]), np.uint8)
                codes = np.concatenate([codes, pad], axis=1)
            packed = (
                codes[:, 0::4]
                | (codes[:, 1::4] << 2)
                | (codes[:, 2::4] << 4)
                | (codes[:, 3::4] << 6)
            )
            # pure pow2 with a 512 floor: retry counts vary block to block,
            # and each distinct pad size is a fresh program
            PAD = max(512, 1 << (len(ch) - 1).bit_length())
            buf = np.zeros((PAD, w4), np.uint8)
            buf[: len(ch)] = packed
            ln = np.zeros(PAD, np.int32)
            ln[: len(ch)] = lens
            n_exc = len(er)
            pe = max(32, self._pad_rows(n_exc))
            exc = np.full((pe, 2), W, np.int32)
            exc[:, 0] = PAD
            exc[:n_exc, 0] = er
            exc[:n_exc, 1] = ec
            out_d, _ = fused_scan_lanes(
                (self._put_batch(buf),),
                (self._put_batch(ln),),
                self._put_repl(exc),
                tbl["keys"],
                tbl["vals"],
                tbl["dupes"],
                widths=(W,),
                cap=PAD,
                major_req=st.major_gene_key_requirement,
                minor_req=st.minor_gene_key_requirement,
                mismatch_thr=st.mismatch_threshold,
                **tbl["statics"],
            )
            ctxs.append((ch, _Fetch(out_d)))
        return ctxs

    def _retry_assemble(self, mapper, ctxs, ed_batcher=None) -> None:
        """Consume _retry_issue results. Survivors come back compacted in
        ascending row order, so matches are appended in the same item
        order as the old synchronous path (determinism-preserving)."""
        for ch, fetch in ctxs:
            out = self._get(fetch)
            body = out[:-1]
            n = int(out[-1, 0])
            for k in range(min(n, len(body))):
                r = body[k]
                i = int(r[0])
                if i >= len(ch) or not (r[2] and r[3]):
                    continue
                lane, rc_read, originals = ch[i]
                mapping = [
                    SeqMatch(
                        int(r[4 + t]),
                        int(r[6 + t]),
                        GenePos(int(r[8 + t]), int(r[10 + t])),
                    )
                    for t in range(2)
                ]
                if not mapper.indexer.in_required_direction(mapping):
                    continue
                m = mapper.make_match(rc_read, mapping, ed_batcher=ed_batcher)
                m.original_reads = originals
                if lane != 0:
                    # merged-lane RC matches keep reversed=False
                    # (faithful: pescanner.rs:465-468 vs :487-490)
                    m.reversed = True
                mapper.add_match(m)

    def _scan_single_matrices(self, mapper, rows, lens, read_at: Callable) -> None:
        """Single-end pipeline entry: same one-dispatch scan + readiness-
        gated assembly as the paired path, with a single read lane (no
        merge; the host pack is vectorized numpy)."""
        rows = np.ascontiguousarray(rows)
        lens = np.asarray(lens, np.int32).copy()
        shared = dict(
            fut=self._submit_producer(self._st0_produce_se, rows, lens),
            mappers=[mapper],
            read_at=read_at,
            se=True,
            orig_B=len(lens),
            fetched=False,
            merged_read_cache={},
        )
        self._enqueue_batch(shared, [mapper])

    def _st0_produce_se(self, rows, lens):
        """Single-end producer: 2-bit pack + non-ACGT exception capture
        (vectorized numpy — no merge to do) + upload. One 'u'-kind lane;
        exotic bytes need no oracle routing here (without a merge the
        byte-level comparison path never runs, so invalid-code semantics
        are already identical to the oracle's k-mer encoding)."""
        B, Lin = rows.shape
        L = _round_up(max(32, Lin), 32)
        w4 = (L + 3) // 4
        codes = BASE_CODE_LUT[rows]
        col = np.arange(Lin)[None, :]
        in_span = col < lens[:, None]
        er, ec = np.nonzero((codes == 255) & in_span)
        codes = np.where(codes == 255, 0, codes).astype(np.uint8)
        if Lin != 4 * w4:
            pad = np.zeros((B, 4 * w4 - Lin), np.uint8)
            codes = np.concatenate([codes, pad], axis=1)
        packed = (
            codes[:, 0::4]
            | (codes[:, 1::4] << 2)
            | (codes[:, 2::4] << 4)
            | (codes[:, 3::4] << 6)
        )
        P = self._pad_rows(B)
        buf = np.zeros((P, w4), np.uint8)
        buf[:B] = packed
        ln = np.zeros(P, np.int32)
        ln[:B] = lens
        rwork = np.stack(
            [np.arange(B, dtype=np.int32), np.ones(B, np.int32), lens], axis=1
        )
        n_exc = len(er)
        pe = max(32, self._pad_rows(n_exc))
        exc = np.full((pe, 2), L, np.int32)
        exc[:, 0] = P
        exc[:n_exc, 0] = er
        exc[:n_exc, 1] = ec
        out = self._timed(
            "st0.upload",
            lambda: dict(
                bufs_d=(self._put_batch(buf),),
                lens_d=(self._put_batch(ln),),
                exc_d=self._put_repl(exc),
            ),
        )
        out.update(
            rows_m=np.zeros(0, np.int64),
            m_len=np.zeros(B, np.int32),
            rwork=rwork,
            exotic=np.zeros(B, bool),
            mbuf=np.zeros((0, 1), np.uint8),
            ubuf=packed,
            exc_np=exc[:n_exc],
            lane_meta=[
                dict(kind="u", n=B, sel=np.arange(B), W=L, w4=w4,
                     pair_rows=None, off=0)
            ],
            offs=[0, P],
            widths=(L,),
            n_m=0,
            n_u=B,
            L=L,
        )
        return out
