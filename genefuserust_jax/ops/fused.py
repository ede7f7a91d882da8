"""Fused device pipeline: unpack -> RC -> merge-on-codes -> 3-lane pass1.

One jit call per read batch with only scalar-sized fetches; the merged-read
code matrix stays device-resident for the pass-2 gather. Upload format is
the packed 4-bit-seq/2-bit-qual-class encoding from ops/pack.py.

The reverse complement of R2 is computed full-width (so the logical read is
RIGHT-aligned at column L-l2); all merge index arithmetic carries that
shift instead of doing per-row alignment gathers.

Equivalence to the scalar fast_merge (read.rs:313-440) is inherited from
ops/merge.py's totals argument; the qual-class reduction is exact because
the merge logic only tests q>=Q30 and q<=Q15 (see ops/pack.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MIN_OVERLAP
from .map_read import map_read_pass1
from .pack import (
    COMP4, MAP_FROM_SEQ4, unpack_q2_jnp, unpack_seq2_jnp, unpack_seq4_jnp,
)


class FusedPass1Result(NamedTuple):
    merged: jnp.ndarray  # (B,) bool
    diff: jnp.ndarray  # (B,) int32
    m_len: jnp.ndarray  # (B,) int32
    merged_codes: jnp.ndarray  # (B, 2L) uint8 4-bit codes — device resident
    ok_m: jnp.ndarray  # (B,) bool       pass1 gate, merged lane
    gp_m: jnp.ndarray  # (B, 4) int32    h1,l1,h2,l2
    ok_1: jnp.ndarray
    gp_1: jnp.ndarray
    ok_2: jnp.ndarray
    gp_2: jnp.ndarray


# summary layout (single host fetch): columns of the (B, 18) int32 array
# [0]=merged [1]=diff [2]=m_len [3]=ok_m [4:8]=gp_m [8]=ok_1 [9:13]=gp_1
# [13]=ok_2 [14:18]=gp_2
SUMMARY_COLS = 18


def _merge_codes(s1, qc1, l1, rc2f, qc2f, l2, L):
    """Merge on 4-bit codes + qual classes; rc2f/qc2f are full-flip arrays
    (logical read right-aligned at L-l2).

    Gather-free overlap scan: with s1/qc1 RIGHT-aligned (s1r[L-l1+j] =
    s1[j]) and RC(R2) LEFT-aligned (t2l[i] = rc2f[L-l2+i]), the overlap
    comparison at length o is s1r[L-o+i] vs t2l[i] — a STATIC slice per o,
    so the O-loop is pure vector compares. The re-alignments and the
    merged-read construction are per-row SHIFTS, composed from log2(L)
    static-slice shifts (row_shift_*) — zero gathers anywhere."""
    from .gather import row_shift_left, row_shift_right

    B = s1.shape[0]
    O = L - MIN_OVERLAP + 1
    # right-align R1: s1r[c] = s1[c - (L - l1)]
    d1 = L - l1
    s1r = row_shift_right(s1, d1, 15)
    q1r = row_shift_right(qc1, d1, 0)
    # left-align RC(R2): t2l[i] = rc2f[(L - l2) + i]
    d2 = L - l2
    t2l = row_shift_left(rc2f, d2, 15)
    q2l = row_shift_left(qc2f, d2, 0)

    diffs = []
    lqs = []
    for o in range(MIN_OVERLAP, L + 1):
        a1 = s1r[:, L - o :]
        aq1 = q1r[:, L - o :]
        a2 = t2l[:, :o]
        aq2 = q2l[:, :o]
        mism = a1 != a2
        lq = mism & (((aq1 == 2) & (aq2 == 0)) | ((aq1 == 0) & (aq2 == 2)))
        diffs.append(jnp.sum(mism.astype(jnp.int32), axis=1))
        lqs.append(jnp.sum(lq.astype(jnp.int32), axis=1))
    diff_tot = jnp.stack(diffs, axis=1)  # (B, O)
    lq_tot = jnp.stack(lqs, axis=1)
    olens = MIN_OVERLAP + jax.lax.broadcasted_iota(jnp.int32, (B, O), 1)
    o_valid = olens <= jnp.minimum(l1, l2)[:, None]
    ok = o_valid & (diff_tot == lq_tot) & (lq_tot <= 2)
    any_ok = jnp.any(ok, axis=1)
    first = jnp.argmax(ok, axis=1)
    olen = MIN_OVERLAP + first.astype(jnp.int32)
    diff = jnp.take_along_axis(diff_tot, first[:, None], axis=1)[:, 0]

    offset = l1 - olen
    out_len = offset + l2
    Lm = 2 * L
    jm = jax.lax.broadcasted_iota(jnp.int32, (B, Lm), 1)
    # left parts read s1/qc1 directly (left-aligned, static columns);
    # RC(R2) parts are t2l shifted right by the merge offset (rows without
    # a merge get a clipped garbage shift and are overwritten below)
    g1 = jnp.concatenate([s1, jnp.full((B, Lm - L), 15, s1.dtype)], axis=1)
    gq1 = jnp.concatenate([qc1, jnp.zeros((B, Lm - L), qc1.dtype)], axis=1)
    off_c = jnp.clip(offset, 0, Lm)
    t2x = jnp.concatenate([t2l, jnp.full((B, Lm - L), 15, t2l.dtype)], axis=1)
    q2x = jnp.concatenate([q2l, jnp.zeros((B, Lm - L), q2l.dtype)], axis=1)
    g2 = row_shift_right(t2x, off_c, 15)
    gq2 = row_shift_right(q2x, off_c, 0)
    in_left = jm < offset[:, None]
    in_overlap = (jm >= offset[:, None]) & (jm < l1[:, None])
    in_right = (jm >= l1[:, None]) & (jm < out_len[:, None])
    take1 = (gq1 == 2) & (gq2 == 0)
    ov_seq = jnp.where(g1 == g2, g2, jnp.where(take1, g1, g2))
    out_seq = jnp.where(
        in_left, g1, jnp.where(in_overlap, ov_seq, jnp.where(in_right, g2, 15))
    ).astype(jnp.uint8)
    out_seq = jnp.where(any_ok[:, None], out_seq, 15)
    return (
        any_ok,
        jnp.where(any_ok, diff, 0),
        jnp.where(any_ok, out_len, 0),
        out_seq,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "shift", "max_dupe", "major_req", "minor_req", "kv", "cbits",
        "pos_bias",
    ),
)
def fused_pass1(
    s1p: jnp.ndarray,  # (B, ceil(L/2)) packed 4-bit R1 codes
    q1p: jnp.ndarray,  # (B, ceil(L/4)) packed qual classes
    l1: jnp.ndarray,
    s2p: jnp.ndarray,
    q2p: jnp.ndarray,
    l2: jnp.ndarray,
    keys_tbl: jnp.ndarray,
    vals_tbl: jnp.ndarray,
    dupes: jnp.ndarray,
    L: int,
    shift: int,
    max_dupe: int,
    major_req: int = 40,
    minor_req: int = 20,
    kv: bool = False,
    cbits: int = 0,
    pos_bias: int = 0,
) -> FusedPass1Result:
    B = s1p.shape[0]
    comp4 = jnp.asarray(COMP4)
    map4 = jnp.asarray(MAP_FROM_SEQ4)
    s1 = unpack_seq4_jnp(s1p, L)
    s2 = unpack_seq4_jnp(s2p, L)
    qc1 = unpack_q2_jnp(q1p, L)
    qc2 = unpack_q2_jnp(q2p, L)
    rc2f = jnp.take(comp4, s2[:, ::-1].astype(jnp.int32), axis=0)
    qc2f = qc2[:, ::-1]

    merged, diff, m_len, m_codes = _merge_codes(s1, qc1, l1, rc2f, qc2f, l2, L)

    m_map = jnp.take(map4, m_codes.astype(jnp.int32), axis=0)
    r1_map = jnp.take(map4, s1.astype(jnp.int32), axis=0)
    r2_map = jnp.take(map4, s2.astype(jnp.int32), axis=0)

    ok_m, h1m, l1m, h2m, l2m = map_read_pass1(
        m_map, jnp.where(merged, m_len, 0), keys_tbl, vals_tbl, dupes,
        shift, max_dupe, major_req, minor_req, kv, cbits, pos_bias,
    )
    ok_1, h11, l11, h21, l21 = map_read_pass1(
        r1_map, jnp.where(merged, 0, l1), keys_tbl, vals_tbl, dupes,
        shift, max_dupe, major_req, minor_req, kv, cbits, pos_bias,
    )
    ok_2, h12, l12, h22, l22 = map_read_pass1(
        r2_map, jnp.where(merged, 0, l2), keys_tbl, vals_tbl, dupes,
        shift, max_dupe, major_req, minor_req, kv, cbits, pos_bias,
    )
    return FusedPass1Result(
        merged,
        diff,
        m_len,
        m_codes,
        ok_m,
        jnp.stack([h1m, l1m, h2m, l2m], axis=1),
        ok_1,
        jnp.stack([h11, l11, h21, l21], axis=1),
        ok_2,
        jnp.stack([h12, l12, h22, l22], axis=1),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "chunk", "shift", "max_dupe", "major_req", "minor_req", "kv",
        "cbits", "pos_bias",
    ),
)
def fused_pass1_chunked(
    buf: jnp.ndarray,  # (B, 2*ceil(L/2)+2*ceil(L/4)) single packed upload:
    #                      [s1p | q1p | s2p | q2p]
    lens2: jnp.ndarray,  # (B, 2) int32 [l1, l2]
    keys_tbl: jnp.ndarray,
    vals_tbl: jnp.ndarray,
    dupes: jnp.ndarray,
    L: int,
    chunk: int,
    shift: int,
    max_dupe: int,
    major_req: int = 40,
    minor_req: int = 20,
    kv: bool = False,
    cbits: int = 0,
    pos_bias: int = 0,
):
    """Large-batch fused pass1: lax.map over `chunk`-row slices bounds the
    merge working set; ONE upload buffer in, ONE (B, 18) summary fetch out
    (+ merged_codes (B, 2L) device-resident)."""
    B = buf.shape[0]
    assert B % chunk == 0, "engine pads batches to a chunk multiple"
    n = B // chunk
    w2 = (L + 1) // 2
    w4 = (L + 3) // 4

    def one(args):
        a_buf, a_lens2 = args
        a_s1p = a_buf[:, :w2]
        a_q1p = a_buf[:, w2 : w2 + w4]
        a_s2p = a_buf[:, w2 + w4 : 2 * w2 + w4]
        a_q2p = a_buf[:, 2 * w2 + w4 :]
        a_l1 = a_lens2[:, 0]
        a_l2 = a_lens2[:, 1]
        r = fused_pass1(
            a_s1p, a_q1p, a_l1, a_s2p, a_q2p, a_l2,
            keys_tbl, vals_tbl, dupes, L, shift, max_dupe, major_req,
            minor_req, kv, cbits, pos_bias,
        )
        summary = jnp.concatenate(
            [
                r.merged.astype(jnp.int32)[:, None],
                r.diff[:, None],
                r.m_len[:, None],
                r.ok_m.astype(jnp.int32)[:, None],
                r.gp_m,
                r.ok_1.astype(jnp.int32)[:, None],
                r.gp_1,
                r.ok_2.astype(jnp.int32)[:, None],
                r.gp_2,
            ],
            axis=1,
        )
        return summary, r.merged_codes

    reshape = lambda x: x.reshape((n, chunk) + x.shape[1:])
    summary, m_codes = jax.lax.map(one, (reshape(buf), reshape(lens2)))
    return summary.reshape(B, SUMMARY_COLS), m_codes.reshape(B, -1)


@functools.partial(jax.jit, static_argnames=("L", "chunk"))
def fused_merge_chunked(
    buf: jnp.ndarray,  # (B, 2*ceil(L/2)+2*ceil(L/4)) packed upload
    lens2: jnp.ndarray,  # (B, 2) int32
    L: int,
    chunk: int,
):
    """Merge-only stage: -> (msum (B, 3) int32 [merged, diff, m_len] — one
    fetch — and m_codes (B, 2L) device-resident)."""
    B = buf.shape[0]
    assert B % chunk == 0
    n = B // chunk
    w2 = (L + 1) // 2
    w4 = (L + 3) // 4
    comp4 = jnp.asarray(COMP4)

    def one(args):
        a_buf, a_lens2 = args
        s1 = unpack_seq4_jnp(a_buf[:, :w2], L)
        qc1 = unpack_q2_jnp(a_buf[:, w2 : w2 + w4], L)
        s2 = unpack_seq4_jnp(a_buf[:, w2 + w4 : 2 * w2 + w4], L)
        qc2 = unpack_q2_jnp(a_buf[:, 2 * w2 + w4 :], L)
        l1 = a_lens2[:, 0]
        l2 = a_lens2[:, 1]
        rc2f = jnp.take(comp4, s2[:, ::-1].astype(jnp.int32), axis=0)
        qc2f = qc2[:, ::-1]
        merged, diff, m_len, m_codes = _merge_codes(
            s1, qc1, l1, rc2f, qc2f, l2, L
        )
        msum = jnp.stack([merged.astype(jnp.int32), diff, m_len], axis=1)
        return msum, m_codes

    reshape = lambda x: x.reshape((n, chunk) + x.shape[1:])
    msum, m_codes = jax.lax.map(one, (reshape(buf), reshape(lens2)))
    return msum.reshape(B, 3), m_codes.reshape(B, -1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "L2", "shift", "max_dupe", "major_req", "minor_req", "kv", "cbits",
        "pos_bias", "width",
    ),
)
def pass1_rows_merged(
    m_codes: jnp.ndarray,  # (B, 2L) device-resident merged codes
    idx: jnp.ndarray,  # (PB,) int32 pair rows (merged lanes only)
    lens: jnp.ndarray,  # (PB,)
    keys_tbl, vals_tbl, dupes, L2: int, shift: int, max_dupe: int,
    major_req: int = 40, minor_req: int = 20,
    kv: bool = False, cbits: int = 0, pos_bias: int = 0,
    width: int = 0,
):
    """Vote pass over compacted merged-lane rows. -> (PB, 5) int32
    [ok, h1, l1, h2, l2]. Merged length is at most L2 - MIN_OVERLAP, so the
    trailing columns can never hold valid k-mers — trimmed. `width` trims
    further to the batch's actual max merged length (length bucketing:
    callers round it up so the number of compiled variants stays small)."""
    map4 = jnp.asarray(MAP_FROM_SEQ4)
    w = L2 - MIN_OVERLAP if width <= 0 else min(width, L2 - MIN_OVERLAP)
    rows = jnp.take(m_codes, idx, axis=0)[:, :w]
    codes = jnp.take(map4, rows.astype(jnp.int32), axis=0)
    ok, h1, l1, h2, l2 = map_read_pass1(
        codes, lens, keys_tbl, vals_tbl, dupes, shift, max_dupe,
        major_req, minor_req, kv, cbits, pos_bias,
    )
    return jnp.stack([ok.astype(jnp.int32), h1, l1, h2, l2], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "shift", "max_dupe", "major_req", "minor_req", "kv", "cbits",
        "pos_bias",
    ),
)
def pass1_rows_packed(
    buf: jnp.ndarray,  # the pass1 upload buffer (R1/R2 packed codes)
    work: jnp.ndarray,  # (PB, 3) int32 [pair_idx, lane(1|2), len]
    keys_tbl, vals_tbl, dupes, L: int, shift: int, max_dupe: int,
    major_req: int = 40, minor_req: int = 20,
    kv: bool = False, cbits: int = 0, pos_bias: int = 0,
):
    """Vote pass over compacted R1/R2 lanes (unmerged pairs)."""
    w2 = (L + 1) // 2
    w4 = (L + 3) // 4
    idx = work[:, 0]
    lane = work[:, 1]
    lens = work[:, 2]
    s1rows = jnp.take(buf[:, :w2], idx, axis=0)
    s2rows = jnp.take(buf[:, w2 + w4 : 2 * w2 + w4], idx, axis=0)
    rows = jnp.where((lane == 1)[:, None], s1rows, s2rows)
    s = unpack_seq4_jnp(rows, L)
    map4 = jnp.asarray(MAP_FROM_SEQ4)
    codes = jnp.take(map4, s.astype(jnp.int32), axis=0)
    ok, h1, l1, h2, l2 = map_read_pass1(
        codes, lens, keys_tbl, vals_tbl, dupes, shift, max_dupe,
        major_req, minor_req, kv, cbits, pos_bias,
    )
    return jnp.stack([ok.astype(jnp.int32), h1, l1, h2, l2], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "shift", "max_dupe", "mismatch_thr", "kv", "cbits", "pos_bias",
    ),
)
def fused_pass2_combined(
    m_codes: jnp.ndarray,  # (B, 2L) 4-bit merged codes (device resident)
    buf: jnp.ndarray,  # the pass1 upload buffer (for R1/R2 packed codes)
    work: jnp.ndarray,  # (PB, 7) int32 [idx, lane, len, gp0..gp3]
    keys_tbl, vals_tbl, dupes, L: int, shift: int, max_dupe: int,
    mismatch_thr: int = 10,
    kv: bool = False, cbits: int = 0, pos_bias: int = 0,
):
    """One pass2 call for all three lane groups; r-lane rows are unpacked
    and right-padded into the merged width (2L). `work` is the single
    small upload with all survivor descriptors."""
    from .map_read import map_read_pass2

    w2 = (L + 1) // 2
    w4 = (L + 3) // 4
    s1p = buf[:, :w2]
    s2p = buf[:, w2 + w4 : 2 * w2 + w4]
    idx = work[:, 0]
    lane = work[:, 1]
    lens = work[:, 2]
    gps = work[:, 3:7]
    map4 = jnp.asarray(MAP_FROM_SEQ4)
    # merged length <= 2L - MIN_OVERLAP: trim the working width
    L2 = m_codes.shape[1] - MIN_OVERLAP
    mrows = jnp.take(m_codes, idx, axis=0)[:, :L2]
    r1rows = unpack_seq4_jnp(jnp.take(s1p, idx, axis=0), L)
    r2rows = unpack_seq4_jnp(jnp.take(s2p, idx, axis=0), L)
    pad = jnp.full((idx.shape[0], L2 - L), 15, jnp.uint8)
    r1full = jnp.concatenate([r1rows, pad], axis=1)
    r2full = jnp.concatenate([r2rows, pad], axis=1)
    rows4 = jnp.where(
        (lane == 0)[:, None],
        mrows,
        jnp.where((lane == 1)[:, None], r1full, r2full),
    )
    codes = jnp.take(map4, rows4.astype(jnp.int32), axis=0)
    res = map_read_pass2(
        codes, lens, gps[:, 0], gps[:, 1], gps[:, 2], gps[:, 3],
        keys_tbl, vals_tbl, dupes, shift, max_dupe, mismatch_thr,
        kv, cbits, pos_bias,
    )
    # single fetchable output (PB, 10): [0:2]=valid [2:4]=start [4:6]=end
    # [6:8]=contig [8:10]=pos
    out_full = jnp.concatenate(
        [
            res.seg_valid.astype(jnp.int32),
            res.seg_start,
            res.seg_end,
            res.seg_contig,
            res.seg_pos,
        ],
        axis=1,
    )
    return out_full


def fused_scan_codes(
    mbuf, mlens, ubuf, ulens, exc, keys_tbl, vals_tbl, dupes,
    Wm: int, L: int, cap: int, shift: int,
    max_dupe: int, major_req: int = 40, minor_req: int = 20,
    mismatch_thr: int = 10,
    kv: bool = False, cbits: int = 0, pos_bias: int = 0,
):
    """Two-lane convenience wrapper over fused_scan_lanes (merged lane at
    width Wm, unmerged read lane at width L)."""
    return fused_scan_lanes(
        (mbuf, ubuf), (mlens, ulens), exc, keys_tbl, vals_tbl, dupes,
        widths=(Wm, L), cap=cap, shift=shift, max_dupe=max_dupe,
        major_req=major_req, minor_req=minor_req,
        mismatch_thr=mismatch_thr, kv=kv, cbits=cbits, pos_bias=pos_bias,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "widths", "cap", "shift", "max_dupe", "major_req", "minor_req",
        "mismatch_thr", "kv", "cbits", "pos_bias",
    ),
)
def fused_scan_lanes(
    bufs,  # tuple of (P_i, (widths[i]+3)//4) uint8 — 2-bit code rows
    lens_t,  # tuple of (P_i,) int32
    exc: jnp.ndarray,  # (E, 2) int32 — non-ACGT [row, col] in the CONCAT
    #                     row space (lane i rows at offset sum(P_<i));
    #                     pad entries point out of bounds and are dropped
    keys_tbl=None, vals_tbl=None, dupes=None, *, widths, cap: int,
    shift: int, max_dupe: int, major_req: int = 40, minor_req: int = 20,
    mismatch_thr: int = 10,
    kv: bool = False, cbits: int = 0, pos_bias: int = 0,
):
    """Whole scan in ONE dispatch over any number of width-bucketed code
    lanes: stride-2 vote pass per lane, on-device survivor compaction
    (stable by concat row index), and the mask/segment pass over the first
    `cap` survivors. Under dispatch-latency-bound and bandwidth-bound
    links this reduces each batch to one execute plus one ~cap-row fetch;
    it is also the fewest-kernel-launches form for production hosts.
    Codes arrive 2-bit packed (the minimal upload); non-ACGT positions are
    scattered to the invalid marker from `exc`. Width bucketing matters
    because each lane's vote pass costs P_i x samples(widths[i]) row
    probes regardless of true row lengths — the host routes rows to the
    narrowest lane that fits.

    Returns (out, okwords):
      out      (cap + 1, 13) int32 — per survivor [sidx, svalid,
               seg_valid0, seg_valid1, start0, start1, end0, end1,
               contig0, contig1, pos0, pos1, 0]; the LAST row is
               [n_survivors, 0, ...]. sidx indexes the concatenated lane
               row space.
      okwords  (ceil(sum(P_i)/32),) int32 — the full vote-gate bitmap,
               for the (rare) host fallback when n_survivors > cap.
    """
    from .map_read import map_read_pass2

    erow = exc[:, 0]
    ecol = exc[:, 1]
    inv = jnp.full(erow.shape, 255, jnp.uint8)
    codes_l, ok_l, gp_l = [], [], []
    off = 0
    for buf, ln, Wi in zip(bufs, lens_t, widths):
        Pi = buf.shape[0]
        ci = unpack_seq2_jnp(buf, Wi).astype(jnp.uint8)
        # entries outside this lane's row range -> out of bounds -> dropped
        ri = jnp.where((erow >= off) & (erow < off + Pi), erow - off, Pi)
        ci = ci.at[ri, ecol].set(inv, mode="drop")
        oki, h1i, l1i, h2i, l2i = map_read_pass1(
            ci, ln, keys_tbl, vals_tbl, dupes, shift, max_dupe,
            major_req, minor_req, kv, cbits, pos_bias,
        )
        codes_l.append(ci)
        ok_l.append(oki)
        gp_l.append((h1i, l1i, h2i, l2i))
        off += Pi
    N = off
    ok = jnp.concatenate(ok_l)
    h1 = jnp.concatenate([g[0] for g in gp_l])
    l1 = jnp.concatenate([g[1] for g in gp_l])
    h2 = jnp.concatenate([g[2] for g in gp_l])
    l2 = jnp.concatenate([g[3] for g in gp_l])
    lens = jnp.concatenate(lens_t)
    # stable survivor compaction: survivors first, in row order
    iota = jax.lax.iota(jnp.int32, N)
    order = jnp.argsort(jnp.where(ok, iota, N + iota))
    c = min(cap, N)
    sidx = order[:c]
    svalid = jnp.take(ok, sidx)
    slens = jnp.where(svalid, jnp.take(lens, sidx), 0)
    sh1 = jnp.take(h1, sidx)
    sl1 = jnp.take(l1, sidx)
    sh2 = jnp.take(h2, sidx)
    sl2 = jnp.take(l2, sidx)
    # survivor code rows: gather from the UNPACKED, exception-applied
    # lane matrices (so the invalid markers carry through), unified to
    # the widest lane
    W = max(widths)

    def padc(a, w):
        if a.shape[1] == w:
            return a
        fill = jnp.full((a.shape[0], w - a.shape[1]), 255, jnp.uint8)
        return jnp.concatenate([a, fill], axis=1)

    allcodes = jnp.concatenate([padc(ci, W) for ci in codes_l], axis=0)
    codes = jnp.take(allcodes, sidx, axis=0)
    res = map_read_pass2(
        codes, slens, sh1, sl1, sh2, sl2,
        keys_tbl, vals_tbl, dupes, shift, max_dupe, mismatch_thr,
        kv, cbits, pos_bias,
    )
    body = jnp.concatenate(
        [
            sidx[:, None],
            svalid.astype(jnp.int32)[:, None],
            res.seg_valid.astype(jnp.int32),
            res.seg_start,
            res.seg_end,
            res.seg_contig,
            res.seg_pos,
            jnp.zeros((c, 1), jnp.int32),
        ],
        axis=1,
    )
    if c < cap:  # tiny batches: pad to the static cap
        body = jnp.concatenate(
            [body, jnp.zeros((cap - c, 13), jnp.int32)], axis=0
        )
    count_row = jnp.zeros((1, 13), jnp.int32).at[0, 0].set(
        ok.astype(jnp.int32).sum()
    )
    out = jnp.concatenate([body, count_row], axis=0)
    # packed vote-gate bitmap (N is a multiple of 32: row pads are pow2-ish)
    nw = (N + 31) // 32
    okp = jnp.zeros(nw * 32, jnp.uint32).at[:N].set(ok.astype(jnp.uint32))
    weights = jnp.uint32(1) << jax.lax.iota(jnp.int32, 32).astype(jnp.uint32)
    # distinct powers of two, each present at most once -> the wrapping
    # uint32 sum is exactly the bitwise OR (bit k of word w = row w*32+k)
    okwords = (
        (okp.reshape(nw, 32) * weights[None, :]).sum(axis=1).astype(jnp.int32)
    )
    return out, okwords
