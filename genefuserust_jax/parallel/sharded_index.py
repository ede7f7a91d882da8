"""Contig-sharded k-mer index: whole-genome panels across a device mesh.

For panels bigger than one device's memory (the hg38 whole-genome case,
SURVEY §5 "long-context analog"), the index is partitioned by CONTIG
(gene) across the mesh's 'shard' axis; read batches are replicated.
Exactness argument:

  - dupe/high classification is GLOBAL (done on the host before
    partitioning): high-level kmers are dropped everywhere (absence ==
    skip, identical voting/masking effect); a dupe list split across
    shards still votes the same multiset of shifted positions because a
    gplong's contig determines its owning shard — vote counts per gplong
    are complete on exactly one shard.
  - global top-2 = merge of per-shard top-2 candidates by the reference
    rule (count desc, ascending-i64 gplong): since every gplong is counted
    wholly on one shard, the union of shard-local top-2s contains the
    global top-2.
  - pass-2 per-position flags are computed per shard (only the owner of a
    candidate's contig can flag it) and merged with a max over the shard
    axis — exactly the reference's make_mask max semantics.

The result equals the single-device kernel bit-for-bit (tests compare on a
virtual CPU mesh).
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import KMER, PASS1_STEP
from ..ops.hashtable import DUPE, EMPTY, HIGH, PackedIndex, SLOTS, _absent_key, _build
from ..ops import map_read as M


def shard_contigs(indexer, n_shards: int) -> np.ndarray:
    """contig id -> shard, greedy balance by gene sequence length."""
    sizes = [(len(s), c) for c, s in enumerate(indexer.fusion_seq)]
    sizes.sort(reverse=True)
    load = np.zeros(n_shards, np.int64)
    owner = np.zeros(len(indexer.fusion_seq), np.int32)
    for sz, c in sizes:
        s = int(np.argmin(load))
        owner[c] = s
        load[s] += sz
    return owner


def pack_index_sharded(indexer, n_shards: int):
    """-> (owner, [PackedIndex per shard] with a COMMON bucket count).

    Global classification first (thr from settings), then entries routed by
    contig owner; high kmers dropped entirely."""
    thr = indexer.settings.skip_key_dup_threshold
    counts = indexer.group_count
    starts = indexer.group_start
    owner = shard_contigs(indexer, n_shards)

    # expand kept (non-high) groups to entry rows with their group kmer
    keep_groups = counts <= thr
    # rows belonging to kept groups:
    grp_of_row = np.repeat(np.arange(len(counts)), counts)
    row_keep = keep_groups[grp_of_row]
    rows = np.nonzero(row_keep)[0]
    r_kmer = indexer.se_kmer[rows]
    r_contig = indexer.se_contig[rows]
    r_pos = indexer.se_pos[rows]
    r_shard = owner[r_contig]

    from concurrent.futures import ThreadPoolExecutor

    from .. import native

    packs: List[PackedIndex] = []
    per_shard = []
    max_keys = 1
    for s in range(n_shards):
        sel = r_shard == s
        sk, sc, sp = r_kmer[sel], r_contig[sel], r_pos[sel]
        # group within shard (stable by kmer; insertion order preserved)
        srt = native.sort_entries_by_kmer(sk, sc, sp)
        if srt is not None:
            sk, sc, sp = srt
        else:
            order = np.argsort(sk, kind="stable")
            sk, sc, sp = sk[order], sc[order], sp[order]
        per_shard.append((sk, sc, sp))
        # count shard-local unique keys for sizing
        if len(sk):
            gs = native.group_starts(sk)
            nk = len(gs) if gs is not None else len(np.unique(sk))
        else:
            nk = 1
        max_keys = max(max_keys, nk)
    nb = 16
    while nb * 2 < max_keys:
        nb *= 2
    while True:
        # shard packs are independent; gf_pack_table releases the GIL, so
        # thread-parallel across shards (the host analog of the reference's
        # rayon index build, matcher.rs:154-161)
        with ThreadPoolExecutor(max_workers=min(4, max(1, n_shards))) as ex:
            packs = list(
                ex.map(lambda a: _pack_entries(*a, nb, thr), per_shard)
            )
        if all(p is not None for p in packs):
            return owner, packs
        nb *= 2  # a shard overflowed: retry all at the common doubled size


def _pack_entries(sk, sc, sp, nb, thr):
    """Pack grouped (sorted) entry arrays into a PackedIndex at exactly
    `nb` buckets; None on overflow (local dupe lists <= thr entries by
    construction of the global classification)."""
    if len(sk) == 0:
        table = np.zeros((nb, SLOTS, 3), np.int32)
        table[:, :, 1] = EMPTY
        return PackedIndex(
            table, np.full((1, 1, 2), EMPTY, np.int32), nb,
            32 - int(np.log2(nb)), 1,
        )
    from .. import native

    gstart = native.group_starts(sk)
    if gstart is None:
        first = np.concatenate([[True], sk[1:] != sk[:-1]])
        gstart = np.nonzero(first)[0]
    gcount = np.diff(np.append(gstart, len(sk)))
    uk = sk[gstart]
    is_reg = gcount == 1
    reg_i = np.nonzero(is_reg)[0]
    dup_i = np.nonzero(~is_reg)[0]
    keys = np.concatenate([uk[reg_i], uk[dup_i]]).astype(np.uint32)
    contigs = np.concatenate(
        [sc[gstart[reg_i]], np.full(len(dup_i), DUPE, np.int32)]
    ).astype(np.int32)
    poss = np.concatenate(
        [sp[gstart[reg_i]], np.arange(len(dup_i), dtype=np.int32)]
    ).astype(np.int32)
    max_dupe = int(gcount[dup_i].max()) if len(dup_i) else 1
    dupes = np.full((max(1, len(dup_i)), max_dupe, 2), EMPTY, np.int32)
    dupes[:, :, 1] = 0
    if len(dup_i):
        off = np.arange(max_dupe)[None, :]
        src = gstart[dup_i][:, None] + off
        valid = off < gcount[dup_i][:, None]
        srcc = np.clip(src, 0, len(sk) - 1)
        dupes[:, :, 0] = np.where(valid, sc[srcc], EMPTY)
        dupes[:, :, 1] = np.where(valid, sp[srcc], 0)
    shift = 32 - int(round(np.log2(nb)))
    table = native.pack_table(keys, contigs, poss, nb, shift, SLOTS, EMPTY)
    if table is None:
        table = _build(keys, contigs, poss, nb, shift)
    if table is None:
        return None
    return PackedIndex(table, dupes, nb, shift, max_dupe)


def stack_packs(packs: List[PackedIndex]):
    """Pad per-shard packs to common shapes and stack on axis 0 (the shard
    axis for shard_map). -> (keys (S,nb,SLOTS), vals (S,nb*SLOTS,2),
    dupes (S,nd,D,2), shift, max_dupe)."""
    nb = max(p.n_buckets for p in packs)
    D = max(p.max_dupe for p in packs)
    nd = max(p.dupes.shape[0] for p in packs)
    S = len(packs)
    keys = np.zeros((S, nb, SLOTS), np.int32)
    vals = np.zeros((S, nb * SLOTS, 2), np.int32)
    dupes = np.full((S, nd, D, 2), EMPTY, np.int32)
    dupes[..., 1] = 0
    for s, p in enumerate(packs):
        assert p.n_buckets == nb, "pack_index_sharded uses a common nb"
        keys[s] = p.keys_tbl
        vals[s] = p.vals_tbl
        dupes[s, : p.dupes.shape[0], : p.max_dupe] = p.dupes
    shift = packs[0].shift
    return keys, vals, dupes, shift, D


def build_sharded_map_read(mesh, shift: int, max_dupe: int, L: int,
                           major_req: int = 40, minor_req: int = 20,
                           mismatch_thr: int = 10, axis: str = "shard"):
    """Jitted replicated-reads / sharded-index map_read over `mesh`.

    inputs: codes (B, L) uint8 REPLICATED, lengths (B,), per-shard stacked
    keys/vals/dupes SHARDED on axis 0. Output MapReadResult replicated."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    nsh = mesh.shape[axis]

    def per_shard(codes, lengths, keys3, vals3, dupes4):
        keys_tbl = keys3[0]
        vals_tbl = vals3[0]
        dupes = dupes4[0]
        B = codes.shape[0]
        km, kvalid = M.compute_kmers(codes, lengths)
        skm = km[:, ::PASS1_STEP]
        skv = kvalid[:, ::PASS1_STEP]
        contig, pos = M.hash_lookup((keys_tbl, vals_tbl), shift, skm, skv)
        cc, cp, cv = M.expand_candidates(contig, pos, dupes, max_dupe)
        D = cc.shape[-1]
        NS = skm.shape[1]
        i_idx = jax.lax.broadcasted_iota(jnp.int32, (B, NS), 1) * PASS1_STEP
        h1, l1, c1, h2, l2, c2 = M.top2_votes(
            cc.reshape(B, NS * D),
            (cp - i_idx[:, :, None]).reshape(B, NS * D),
            cv.reshape(B, NS * D),
        )
        # gather local top-2 (count, gp) across shards -> global top-2
        local = jnp.stack(
            [c1, h1, l1, c2, h2, l2], axis=1
        )  # (B, 6)
        allc = jax.lax.all_gather(local, axis)  # (S, B, 6)
        cand_c = jnp.concatenate([allc[:, :, 0], allc[:, :, 3]], axis=0).T
        cand_h = jnp.concatenate([allc[:, :, 1], allc[:, :, 4]], axis=0).T
        cand_l = jnp.concatenate([allc[:, :, 2], allc[:, :, 5]], axis=0).T
        # (B, 2S) candidates; pick by (count desc, gplong asc); zero-count
        # and zero-key entries excluded by c==0 guard (top2_votes yields
        # c>=0 and gp!=0 for real candidates)
        g1h, g1l, g1c, g2h, g2l, g2c = _merge_top2(cand_c, cand_h, cand_l)
        pass1_ok = (g1c * PASS1_STEP >= major_req) & (
            g2c * PASS1_STEP >= minor_req
        )
        # ---- pass 2: local flags, pmax over shards ----
        contig2, pos2 = M.hash_lookup((keys_tbl, vals_tbl), shift, km, kvalid)
        c2c, c2p, c2v = M.expand_candidates(contig2, pos2, dupes, max_dupe)
        NK = km.shape[1]
        ii = jax.lax.broadcasted_iota(jnp.int32, (B, NK), 1)
        a_lo = c2p - ii[:, :, None]
        m1 = M._eq_pm1(c2c, a_lo, g1h[:, None, None], g1l[:, None, None])
        m2 = M._eq_pm1(c2c, a_lo, g2h[:, None, None], g2l[:, None, None])
        flag = jnp.where(c2v & m1, 3, jnp.where(c2v & m2, 2, 0)).astype(
            jnp.int32
        )
        flagpos = jnp.max(flag, axis=2)
        flagpos = jax.lax.pmax(flagpos, axis)  # reference make_mask max
        pad = jnp.zeros((B, KMER - 1), jnp.int32)
        padded = jnp.concatenate([pad, flagpos, pad], axis=1)
        mask = jnp.zeros((B, L), jnp.int32)
        for j in range(KMER):
            mask = jnp.maximum(mask, padded[:, KMER - 1 - j : KMER - 1 - j + L])
        t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        within = t_idx < lengths[:, None]
        mism = jnp.sum(((mask < 2) & within).astype(jnp.int32), axis=1)
        read_ok = pass1_ok & (mism <= mismatch_thr)
        v_top, s_top, e_top = M.extract_segments(mask, lengths, 3)
        v_sec, s_sec, e_sec = M.extract_segments(mask, lengths, 2)
        return (
            jnp.stack([v_top & read_ok, v_sec & read_ok], axis=1),
            jnp.stack([s_top, s_sec], axis=1),
            jnp.stack([e_top, e_sec], axis=1),
            jnp.stack([g1h, g2h], axis=1),
            jnp.stack([g1l, g2l], axis=1),
        )

    repl = P()
    sh = P(axis)
    f = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(repl, repl, sh, sh, sh),
        out_specs=(repl, repl, repl, repl, repl),
        check_vma=False,
    )
    return jax.jit(f)


def _merge_top2(cand_c, cand_h, cand_l):
    """(B, K) candidate (count, hi, lo) -> global top-2 by the reference
    (count desc, ascending-i64 first) rule. Candidates with count==0 are
    ignored. Ascending-gplong tie-break via lexicographic min on (hi, lo
    unsigned)."""
    SIGN32 = -2147483648
    neg = cand_c <= 0
    # order key: maximize count; tie -> minimize (hi, lo_unsigned)
    lo_u = cand_l ^ SIGN32
    # two-key sort descending count then ascending gp: sort by
    # (-count, hi, lo_u) lexicographically ascending
    kc = jnp.where(neg, 2**30, -cand_c)
    kh = jnp.where(neg, 2**30, cand_h)
    kl = jnp.where(neg, 2**30, lo_u)
    sc_, sh_, sl_, oc, oh, ol = jax.lax.sort(
        (kc, kh, kl, cand_c, cand_h, cand_l), dimension=1, num_keys=3
    )
    # dedup: the same gplong cannot appear twice with count>0 from
    # different shards (single owner), so rows 0 and 1 are the top-2
    g1c = jnp.maximum(oc[:, 0], 0)
    g2c = jnp.maximum(oc[:, 1], 0)
    return oh[:, 0], ol[:, 0], g1c, oh[:, 1], ol[:, 1], g2c
