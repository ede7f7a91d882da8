"""Batched map_read: the hot per-read kernel, vectorized over a read batch.

Device reimplementation of the reference's two-pass k-mer vote/mask scan
(src/core/indexer.rs:252-538):

  - i64 `gplong` values (contig<<32 | pos-bits, indexer.rs:697-706) are
    represented as two int32 planes (hi=contig, lo=pos-bit-pattern), so
    the scan runs without jax_enable_x64. Ascending-i64 order == lexicographic (hi signed,
    lo unsigned); unsigned lo ordering is obtained by XOR 0x80000000.
  - vote counting = two-key lax.sort of the candidate list + run-length
    scan; top-2 = first-argmax over run counts, which reproduces the
    BTreeMap iteration tie-break (count desc, then smallest gplong).
  - the ±1 tolerance (indexer.rs:443,454,486,497) — including its wrap
    across contig boundaries for positions -1/0 — is done by exact equality
    against {gp-1, gp, gp+1} computed with carry-aware int32 inc/dec.
  - pass-2 masking = per-candidate flag select + windowed max over the 16
    covered bases. NONE(1) marks are skipped: NONE and UNKNOWN(0) are
    provably equivalent downstream (both count as mismatches; both neither
    block nor extend segments) — see core/indexer.py docstring.
  - segment_mask (indexer.rs:616-679) becomes a parallel chain-labeling
    scan: consecutive run positions link iff gap<=10 with no blocking
    position between; runs = chains from head to last member; first-longest
    wins, spans >20 kept. A target at the last in-bounds position cannot
    start a chain (faithful to the scalar loop bound).

All shapes are static: (B, L) code batches, NK = L-KMER+1 k-mer starts,
D = max dupe-list width (1 for dupe-free panels).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ALLOWED_GAP, KMER, PASS1_STEP, THRESHOLD_LEN
from .hashtable import DUPE, EMPTY, HIGH, SLOTS

INT32_MAX = 2147483647
SIGN32 = -2147483648  # 0x80000000 as int32


class MapReadResult(NamedTuple):
    """Per-read outputs; segment 0 is the TOP target, 1 the SECOND."""

    seg_valid: jnp.ndarray  # (B, 2) bool
    seg_start: jnp.ndarray  # (B, 2) int32
    seg_end: jnp.ndarray  # (B, 2) int32
    seg_contig: jnp.ndarray  # (B, 2) int32
    seg_pos: jnp.ndarray  # (B, 2) int32


def compute_kmers(codes: jnp.ndarray, lengths: jnp.ndarray):
    """(B, L) uint8 codes -> (B, NK) uint32 kmers + validity."""
    B, L = codes.shape
    NK = L - KMER + 1
    ok = codes != 255
    c = jnp.where(ok, codes, 0).astype(jnp.uint32)
    km = jnp.zeros((B, NK), jnp.uint32)
    for j in range(KMER):
        km = km | (c[:, j : j + NK] << (2 * (KMER - 1 - j)))
    bad = (~ok).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=1)
    zeros = jnp.zeros((B, 1), jnp.int32)
    cse = jnp.concatenate([zeros, cs], axis=1)
    clean = (cse[:, KMER:] - cse[:, :-KMER]) == 0
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (B, NK), 1)
    in_range = i_idx <= (lengths[:, None] - KMER)
    return km, clean & in_range


def hash_lookup(table: jnp.ndarray, shift: int, kmers: jnp.ndarray, valid: jnp.ndarray):
    """-> (contig, pos) int32, contig==EMPTY for miss/invalid.

    Two-step gather to minimize HBM elements moved: (1) key-only rows from
    both candidate buckets, (2) the single matched slot's (contig, pos)
    pair via a flat-indexed gather. `table` here is the pair
    (keys (nb, S) int32, vals (nb*S, 2) int32)."""
    keys_tbl, vals_tbl = table
    S = keys_tbl.shape[1]
    ki = kmers.astype(jnp.int32)
    k = kmers
    b1 = ((k * jnp.uint32(0x9E3779B1)) >> shift).astype(jnp.int32)
    b2 = (
        ((k ^ (k >> 15)) * jnp.uint32(0x85EBCA6B) + jnp.uint32(0xC2B2AE35)) >> shift
    ).astype(jnp.int32)
    b1 = jnp.where(valid, b1, 0)  # see kv_lookup: invalid -> row 0
    b2 = jnp.where(valid, b2, 0)
    k1 = jnp.take(keys_tbl, b1, axis=0)  # (..., S)
    k2 = jnp.take(keys_tbl, b2, axis=0)
    m1 = k1 == ki[..., None]
    m2 = k2 == ki[..., None]
    f1 = jnp.any(m1, axis=-1)
    f2 = jnp.any(m2, axis=-1)
    s1 = jnp.argmax(m1, axis=-1)
    s2 = jnp.argmax(m2, axis=-1)
    bucket = jnp.where(f1, b1, b2)
    slot = jnp.where(f1, s1, s2).astype(jnp.int32)
    found = (f1 | f2) & valid
    flat = bucket * S + slot
    sel = jnp.take(vals_tbl, jnp.where(found, flat, 0), axis=0)  # (..., 2)
    out_c = jnp.where(found, sel[..., 0], EMPTY)
    out_p = jnp.where(found, sel[..., 1], 0)
    return out_c, out_p


def kv_lookup(kv_tbl: jnp.ndarray, shift: int, cbits: int, pos_bias: int,
              kmers: jnp.ndarray, valid: jnp.ndarray):
    """Combined-row lookup (ops/hashtable.PackedIndexKV layout): TWO row
    gathers per query — each (2S)xint32 row holds S [key | payload] slots
    for both candidate buckets (S=4 for the default 8-wide rows, S=2 for
    the narrow kv4 A/B layout; derived from the table shape). Returns
    (contig, pos) with hash_lookup's conventions (EMPTY miss, DUPE with
    pos=dupe row, HIGH, or regular)."""
    S = kv_tbl.shape[1] // 2
    pbits = 32 - cbits
    ki = kmers.astype(jnp.int32)
    k = kmers
    b1 = ((k * jnp.uint32(0x9E3779B1)) >> shift).astype(jnp.int32)
    b2 = (
        ((k ^ (k >> 15)) * jnp.uint32(0x85EBCA6B) + jnp.uint32(0xC2B2AE35)) >> shift
    ).astype(jnp.int32)
    # invalid queries (masked out below) all gather row 0 instead of a
    # random garbage row — repeated-row fetches are far cheaper in HBM,
    # and ~20% of merged-lane samples sit past the read length
    b1 = jnp.where(valid, b1, 0)
    b2 = jnp.where(valid, b2, 0)
    r1 = jnp.take(kv_tbl, b1, axis=0)  # (..., 2S)
    r2 = jnp.take(kv_tbl, b2, axis=0)
    m1 = r1[..., :S] == ki[..., None]
    m2 = r2[..., :S] == ki[..., None]
    # keys are unique across both buckets' slots, so at most one slot
    # matches; empty slots carry an absent-key sentinel and payload 0
    pay = jnp.where(m1, r1[..., S:], 0).sum(-1) | jnp.where(
        m2, r2[..., S:], 0
    ).sum(-1)
    tag = (pay.astype(jnp.uint32) >> cbits_shift(pbits)).astype(jnp.int32)
    val = pay & ((1 << pbits) - 1)
    contig = jnp.where(
        tag == 0,
        EMPTY,
        jnp.where(tag == 1, HIGH, jnp.where(tag == 2, DUPE, tag - 3)),
    )
    pos = jnp.where(tag >= 3, val + pos_bias, jnp.where(tag == 2, val, 0))
    contig = jnp.where(valid, contig, EMPTY)
    return contig, pos


def cbits_shift(pbits: int):
    return jnp.uint32(pbits)


def kv16_lookup(kv_tbl: jnp.ndarray, shift: int, cbits: int, pos_bias: int,
                kmers: jnp.ndarray, valid: jnp.ndarray):
    """Single-gather lookup over 16-wide rows (PackedIndexKV16); an A/B
    layout, not the default."""
    from .hashtable import KV16_SLOTS

    return _single_probe_lookup(
        kv_tbl, KV16_SLOTS, shift, cbits, pos_bias, kmers, valid
    )


def kvs_lookup(kv_tbl: jnp.ndarray, shift: int, cbits: int, pos_bias: int,
               kmers: jnp.ndarray, valid: jnp.ndarray):
    """Single-probe lookup over the kv_lookup row width (PackedIndexKVS):
    8xint32 rows of 4 [key | payload] slots, single-hash placement —
    ~1.004 random row gathers per query instead of kv_lookup's 2."""
    from .hashtable import KV_SLOTS

    return _single_probe_lookup(
        kv_tbl, KV_SLOTS, shift, cbits, pos_bias, kmers, valid
    )


def _single_probe_lookup(kv_tbl: jnp.ndarray, S: int, shift: int, cbits: int,
                         pos_bias: int, kmers: jnp.ndarray, valid: jnp.ndarray):
    """Shared single-probe lookup: each (2S)xint32 row holds S
    [key | payload] slots and every key lives in its h1 bucket, so the hot
    path is ONE random row gather per query. Rows whose h1 population
    overflowed at pack time carry a marker payload in the last slot; only
    queries that MISS such a row probe their h2 bucket — all other
    queries' second-gather index is clamped to row 0 (mostly-constant
    indices gather near-free; key equality implies hash equality, so the
    clamp can never produce a false match — see hashtable.PackedIndexKVS)."""
    from .hashtable import OVF_PAYLOAD

    pbits = 32 - cbits
    ki = kmers.astype(jnp.int32)
    k = kmers
    b1 = ((k * jnp.uint32(0x9E3779B1)) >> shift).astype(jnp.int32)
    b1 = jnp.where(valid, b1, 0)  # invalid -> row 0 (see kv_lookup)
    r1 = jnp.take(kv_tbl, b1, axis=0)  # (..., 16)
    m1 = r1[..., :S] == ki[..., None]
    # at most one NONZERO payload can match (keys unique; empty slots carry
    # the absent-key sentinel with payload 0, the overflow marker payload
    # OVF_PAYLOAD decodes to tag 0 = miss)
    pay = jnp.where(m1, r1[..., S:], 0).sum(-1)
    flagged = r1[..., 2 * S - 1] == OVF_PAYLOAD
    need2 = valid & flagged & (pay == 0)
    b2 = (
        ((k ^ (k >> 15)) * jnp.uint32(0x85EBCA6B) + jnp.uint32(0xC2B2AE35)) >> shift
    ).astype(jnp.int32)
    b2 = jnp.where(need2, b2, 0)
    r2 = jnp.take(kv_tbl, b2, axis=0)
    m2 = r2[..., :S] == ki[..., None]
    pay2 = jnp.where(m2, r2[..., S:], 0).sum(-1)
    pay = pay | jnp.where(need2, pay2, 0)
    tag = (pay.astype(jnp.uint32) >> cbits_shift(pbits)).astype(jnp.int32)
    val = pay & ((1 << pbits) - 1)
    contig = jnp.where(
        tag == 0,
        EMPTY,
        jnp.where(tag == 1, HIGH, jnp.where(tag == 2, DUPE, tag - 3)),
    )
    pos = jnp.where(tag >= 3, val + pos_bias, jnp.where(tag == 2, val, 0))
    contig = jnp.where(valid, contig, EMPTY)
    return contig, pos


def expand_candidates_kv(contig, pos, dupes_packed: jnp.ndarray,
                         max_dupe: int, cbits: int, pos_bias: int):
    """KV-layout candidate expansion: dupe rows are 8 packed payloads
    (regular-coded); one row gather serves the whole dupe list."""
    pbits = 32 - cbits
    is_reg = contig >= 0
    is_dupe = contig == DUPE
    if max_dupe <= 1 or dupes_packed.shape[0] == 0:
        cc = jnp.where(is_reg, contig, 0)[..., None]
        cp = jnp.where(is_reg, pos, 0)[..., None]
        cv = is_reg[..., None]
        return cc, cp, cv
    drow = jnp.take(dupes_packed, jnp.where(is_dupe, pos, 0), axis=0)
    drow = drow[..., :max_dupe]  # (..., D) packed payloads
    dtag = (drow.astype(jnp.uint32) >> cbits_shift(pbits)).astype(jnp.int32)
    dval = drow & ((1 << pbits) - 1)
    dv = is_dupe[..., None] & (dtag >= 3)
    cc = jnp.where(dv, dtag - 3, 0)
    cp = jnp.where(dv, dval + pos_bias, 0)
    cc = cc.at[..., 0].set(jnp.where(is_reg, contig, cc[..., 0]))
    cp = cp.at[..., 0].set(jnp.where(is_reg, pos, cp[..., 0]))
    cv = dv.at[..., 0].set(jnp.where(is_reg, True, dv[..., 0]))
    return cc, cp, cv


def lookup_expand(keys_tbl, vals_tbl, dupes, shift: int, max_dupe: int,
                  kv, cbits: int, pos_bias: int, kmers, valid):
    """Layout dispatch (static): kv=False -> split layout (keys_tbl +
    vals_tbl + dupe pair rows); kv=True/1 -> PackedIndexKV combined rows
    (two gathers); kv=2 -> PackedIndexKV16 single-gather rows. For the KV
    layouts keys_tbl holds the combined rows, vals_tbl is a dummy, and
    dupes holds packed payload rows. kv=3 -> PackedIndexKVS single-probe
    8-wide rows."""
    if kv == 3:
        contig, pos = kvs_lookup(keys_tbl, shift, cbits, pos_bias, kmers, valid)
        return expand_candidates_kv(contig, pos, dupes, max_dupe, cbits, pos_bias)
    if kv == 2:
        contig, pos = kv16_lookup(keys_tbl, shift, cbits, pos_bias, kmers, valid)
        return expand_candidates_kv(contig, pos, dupes, max_dupe, cbits, pos_bias)
    if kv:
        contig, pos = kv_lookup(keys_tbl, shift, cbits, pos_bias, kmers, valid)
        return expand_candidates_kv(contig, pos, dupes, max_dupe, cbits, pos_bias)
    contig, pos = hash_lookup((keys_tbl, vals_tbl), shift, kmers, valid)
    return expand_candidates(contig, pos, dupes, max_dupe)


def expand_candidates(contig, pos, dupes: jnp.ndarray, max_dupe: int):
    """(B, NK) lookup results -> (B, NK, D) candidate (contig, pos, valid).

    Regular entries fill slot 0; dupe entries gather their dupe row; high
    dupes and misses yield no candidates."""
    is_reg = contig >= 0
    is_dupe = contig == DUPE
    if max_dupe <= 1 or dupes.shape[0] == 0:
        cc = jnp.where(is_reg, contig, 0)[..., None]
        cp = jnp.where(is_reg, pos, 0)[..., None]
        cv = is_reg[..., None]
        return cc, cp, cv
    drow = jnp.take(dupes, jnp.where(is_dupe, pos, 0), axis=0)  # (B, NK, D, 2)
    cc = jnp.where(is_dupe[..., None], drow[..., 0], 0)
    cp = jnp.where(is_dupe[..., None], drow[..., 1], 0)
    cv = is_dupe[..., None] & (drow[..., 0] != EMPTY)
    # regular entry -> slot 0
    cc = cc.at[..., 0].set(jnp.where(is_reg, contig, cc[..., 0]))
    cp = cp.at[..., 0].set(jnp.where(is_reg, pos, cp[..., 0]))
    cv = cv.at[..., 0].set(jnp.where(is_reg, True, cv[..., 0]))
    return cc, cp, cv


def _i64_dec(hi, lo):
    return hi - (lo == 0).astype(hi.dtype), lo - 1


def _i64_inc(hi, lo):
    return hi + (lo == -1).astype(hi.dtype), lo + 1


def _eq_pm1(hi, lo, ghi, glo):
    """|(hi,lo) - (ghi,glo)| <= 1 in exact i64 arithmetic."""
    dhi, dlo = _i64_dec(ghi, glo)
    ihi, ilo = _i64_inc(ghi, glo)
    return (
        ((hi == ghi) & (lo == glo))
        | ((hi == dhi) & (lo == dlo))
        | ((hi == ihi) & (lo == ilo))
    )


def top2_votes(hi, lo, valid):
    """Candidate lists (B, P) -> top-2 (gp, count) by the reference's
    (count desc, ascending-i64 first-seen) rule. Returns
    (hi1, lo1, c1, hi2, lo2, c2)."""
    B, P = hi.shape
    s_hi = jnp.where(valid, hi, INT32_MAX)
    s_lo = jnp.where(valid, lo, INT32_MAX)
    lo_u = s_lo ^ SIGN32  # unsigned-order transform
    sh, sl = jax.lax.sort((s_hi, lo_u), dimension=1, num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), (sh[:, 1:] != sh[:, :-1]) | (sl[:, 1:] != sl[:, :-1])],
        axis=1,
    )
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    # next run start after j (exclusive)
    nxt = jnp.where(first, idx, P)
    nxt = jnp.concatenate([nxt[:, 1:], jnp.full((B, 1), P, jnp.int32)], axis=1)
    nxt = jax.lax.cummin(nxt, axis=1, reverse=True)
    run_count = nxt - idx
    svalid = sh != INT32_MAX
    zero_key = (sh == 0) & (sl == SIGN32)  # gplong == 0 excluded from top-2
    cand_count = jnp.where(first & svalid & ~zero_key, run_count, -1)
    i1 = jnp.argmax(cand_count, axis=1)
    c1 = jnp.take_along_axis(cand_count, i1[:, None], axis=1)[:, 0]
    h1 = jnp.take_along_axis(sh, i1[:, None], axis=1)[:, 0]
    l1 = jnp.take_along_axis(sl, i1[:, None], axis=1)[:, 0] ^ SIGN32
    cand2 = jnp.where(idx == i1[:, None], -1, cand_count)
    i2 = jnp.argmax(cand2, axis=1)
    c2 = jnp.take_along_axis(cand2, i2[:, None], axis=1)[:, 0]
    h2 = jnp.take_along_axis(sh, i2[:, None], axis=1)[:, 0]
    l2 = jnp.take_along_axis(sl, i2[:, None], axis=1)[:, 0] ^ SIGN32
    c1 = jnp.maximum(c1, 0)
    c2 = jnp.maximum(c2, 0)
    return h1, l1, c1, h2, l2, c2


def extract_segments(mask: jnp.ndarray, lengths: jnp.ndarray, target: int):
    """Parallel segment_mask for one target flag.

    -> (valid, start, end) per read; see module docstring for the chain
    formulation proof sketch."""
    B, L = mask.shape
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    within = t_idx < lengths[:, None]
    ok = (mask == target) & within
    blocked = (mask > target) & within
    # previous ok position strictly before t
    ok_pos = jnp.where(ok, t_idx, -1)
    prev_inc = jax.lax.cummax(ok_pos, axis=1)
    prev = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), prev_inc[:, :-1]], axis=1)
    # "no blocked position in (prev, t)" == last blocked index <= prev
    # (blocked[t] is false when ok[t]); avoids a per-element gather
    last_blocked = jax.lax.cummax(jnp.where(blocked, t_idx, -1), axis=1)
    no_block_between = last_blocked <= prev
    linked = ok & (prev >= 0) & ((t_idx - prev) <= ALLOWED_GAP) & no_block_between
    head = ok & ~linked & (t_idx < lengths[:, None] - 1)
    member = ok & (linked | head)
    hid = jax.lax.cummax(jnp.where(head, t_idx, -1), axis=1)
    # chain end: hid is non-decreasing, so t is its chain's last member iff
    # the next member's hid differs (or no next member); gather-free via a
    # reverse cummin of member-masked hid
    BIG = jnp.int32(0x3FFFFFFF)
    nm_hid_inc = jax.lax.cummin(
        jnp.where(member, hid, BIG), axis=1, reverse=True
    )
    nm_hid = jnp.concatenate(
        [nm_hid_inc[:, 1:], jnp.full((B, 1), BIG, jnp.int32)], axis=1
    )
    chain_end = member & (nm_hid != hid)
    run_len = jnp.where(chain_end & (hid >= 0), t_idx - hid, -1)
    best = jnp.argmax(run_len, axis=1)
    best_len = jnp.take_along_axis(run_len, best[:, None], axis=1)[:, 0]
    seg_end = best.astype(jnp.int32)
    seg_start = jnp.take_along_axis(hid, best[:, None], axis=1)[:, 0]
    valid = best_len > THRESHOLD_LEN
    return valid, seg_start, seg_end


@functools.partial(
    jax.jit,
    static_argnames=(
        "shift", "max_dupe", "major_req", "minor_req", "kv", "cbits",
        "pos_bias",
    ),
)
def map_read_pass1(
    codes: jnp.ndarray,  # (B, L) uint8
    lengths: jnp.ndarray,  # (B,) int32
    keys_tbl: jnp.ndarray,
    vals_tbl: jnp.ndarray,
    dupes: jnp.ndarray,
    shift: int,
    max_dupe: int,
    major_req: int = 40,
    minor_req: int = 20,
    kv: bool = False,
    cbits: int = 0,
    pos_bias: int = 0,
):
    """Vote phase only: stride-2 k-mer lookups, top-2 selection, threshold
    gate. Returns (pass1_ok, h1, l1, h2, l2). The engine compacts the small
    surviving subset and runs map_read_pass2 on it — identical results to
    the fused kernel, ~2x fewer lookups and ~20x less pass-2 work."""
    B, L = codes.shape
    NK = L - KMER + 1
    km, kvalid = compute_kmers(codes, lengths)
    skm = km[:, ::PASS1_STEP]
    skv = kvalid[:, ::PASS1_STEP]
    cc, cp, cv = lookup_expand(
        keys_tbl, vals_tbl, dupes, shift, max_dupe, kv, cbits, pos_bias,
        skm, skv,
    )
    D = cc.shape[-1]
    NS = skm.shape[1]
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (B, NS), 1) * PASS1_STEP
    v_hi = cc
    v_lo = cp - i_idx[:, :, None]
    h1, l1, c1, h2, l2, c2 = top2_votes(
        v_hi.reshape(B, NS * D), v_lo.reshape(B, NS * D), cv.reshape(B, NS * D)
    )
    pass1_ok = (c1 * PASS1_STEP >= major_req) & (c2 * PASS1_STEP >= minor_req)
    return pass1_ok, h1, l1, h2, l2


@functools.partial(
    jax.jit,
    static_argnames=("shift", "max_dupe", "mismatch_thr", "kv", "cbits", "pos_bias"),
)
def map_read_pass2(
    codes: jnp.ndarray,  # (Bc, L) uint8 — compacted survivors
    lengths: jnp.ndarray,
    h1: jnp.ndarray,
    l1: jnp.ndarray,
    h2: jnp.ndarray,
    l2: jnp.ndarray,
    keys_tbl: jnp.ndarray,
    vals_tbl: jnp.ndarray,
    dupes: jnp.ndarray,
    shift: int,
    max_dupe: int,
    mismatch_thr: int = 10,
    kv: bool = False,
    cbits: int = 0,
    pos_bias: int = 0,
) -> MapReadResult:
    """Mask + segment phase for reads that passed the vote gate."""
    B, L = codes.shape
    km, kvalid = compute_kmers(codes, lengths)
    cc, cp, cv = lookup_expand(
        keys_tbl, vals_tbl, dupes, shift, max_dupe, kv, cbits, pos_bias,
        km, kvalid,
    )
    NK = km.shape[1]
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (B, NK), 1)
    a_lo = cp - i_idx[:, :, None]
    m1 = _eq_pm1(cc, a_lo, h1[:, None, None], l1[:, None, None])
    m2 = _eq_pm1(cc, a_lo, h2[:, None, None], l2[:, None, None])
    flag = jnp.where(cv & m1, 3, jnp.where(cv & m2, 2, 0)).astype(jnp.int32)
    flagpos = jnp.max(flag, axis=2)
    pad = jnp.zeros((B, KMER - 1), jnp.int32)
    padded = jnp.concatenate([pad, flagpos, pad], axis=1)
    mask = jnp.zeros((B, L), jnp.int32)
    for j in range(KMER):
        mask = jnp.maximum(mask, padded[:, KMER - 1 - j : KMER - 1 - j + L])
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    within = t_idx < lengths[:, None]
    mismatches = jnp.sum(((mask < 2) & within).astype(jnp.int32), axis=1)
    read_ok = mismatches <= mismatch_thr
    v_top, s_top, e_top = extract_segments(mask, lengths, 3)
    v_sec, s_sec, e_sec = extract_segments(mask, lengths, 2)
    seg_valid = jnp.stack([v_top & read_ok, v_sec & read_ok], axis=1)
    seg_start = jnp.stack([s_top, s_sec], axis=1)
    seg_end = jnp.stack([e_top, e_sec], axis=1)
    seg_contig = jnp.stack([h1, h2], axis=1)
    seg_pos = jnp.stack([l1, l2], axis=1)
    return MapReadResult(seg_valid, seg_start, seg_end, seg_contig, seg_pos)


@functools.partial(
    jax.jit,
    static_argnames=(
        "shift", "max_dupe", "major_req", "minor_req", "mismatch_thr",
        "kv", "cbits", "pos_bias",
    ),
)
def map_read_batch(
    codes: jnp.ndarray,  # (B, L) uint8
    lengths: jnp.ndarray,  # (B,) int32
    keys_tbl: jnp.ndarray,  # (nb, SLOTS) int32
    vals_tbl: jnp.ndarray,  # (nb*SLOTS, 2) int32
    dupes: jnp.ndarray,  # (nd, D, 2) int32
    shift: int,
    max_dupe: int,
    major_req: int = 40,
    minor_req: int = 20,
    mismatch_thr: int = 10,
    kv: bool = False,
    cbits: int = 0,
    pos_bias: int = 0,
) -> MapReadResult:
    B, L = codes.shape
    NK = L - KMER + 1
    km, kvalid = compute_kmers(codes, lengths)
    cc, cp, cv = lookup_expand(
        keys_tbl, vals_tbl, dupes, shift, max_dupe, kv, cbits, pos_bias,
        km, kvalid,
    )
    D = cc.shape[-1]
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (B, NK), 1)

    # ---- pass 1: stride-2 votes ----
    sc = cc[:, ::PASS1_STEP, :]
    sp = cp[:, ::PASS1_STEP, :]
    sv = cv[:, ::PASS1_STEP, :]
    si = i_idx[:, ::PASS1_STEP, None]
    v_hi = sc
    v_lo = sp - si
    NS = sc.shape[1]
    h1, l1, c1, h2, l2, c2 = top2_votes(
        v_hi.reshape(B, NS * D), v_lo.reshape(B, NS * D), sv.reshape(B, NS * D)
    )
    pass1_ok = (c1 * PASS1_STEP >= major_req) & (c2 * PASS1_STEP >= minor_req)

    # ---- pass 2: mask ----
    a_hi = cc
    a_lo = cp - i_idx[:, :, None]
    m1 = _eq_pm1(a_hi, a_lo, h1[:, None, None], l1[:, None, None])
    m2 = _eq_pm1(a_hi, a_lo, h2[:, None, None], l2[:, None, None])
    flag = jnp.where(cv & m1, 3, jnp.where(cv & m2, 2, 0)).astype(jnp.int32)
    flagpos = jnp.max(flag, axis=2)  # (B, NK)
    pad = jnp.zeros((B, KMER - 1), jnp.int32)
    padded = jnp.concatenate([pad, flagpos, pad], axis=1)  # (B, L + KMER - 1)
    mask = jnp.zeros((B, L), jnp.int32)
    for j in range(KMER):
        mask = jnp.maximum(mask, padded[:, KMER - 1 - j : KMER - 1 - j + L])
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    within = t_idx < lengths[:, None]
    mismatches = jnp.sum(((mask < 2) & within).astype(jnp.int32), axis=1)
    pass2_ok = mismatches <= mismatch_thr

    read_ok = pass1_ok & pass2_ok

    v_top, s_top, e_top = extract_segments(mask, lengths, 3)
    v_sec, s_sec, e_sec = extract_segments(mask, lengths, 2)

    seg_valid = jnp.stack([v_top & read_ok, v_sec & read_ok], axis=1)
    seg_start = jnp.stack([s_top, s_sec], axis=1)
    seg_end = jnp.stack([e_top, e_sec], axis=1)
    seg_contig = jnp.stack([h1, h2], axis=1)
    seg_pos = jnp.stack([l1, l2], axis=1)
    return MapReadResult(seg_valid, seg_start, seg_end, seg_contig, seg_pos)
