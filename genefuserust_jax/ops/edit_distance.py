"""Batched Myers bit-parallel edit distance on device.

Device counterpart of core/edit_distance.py (reference:
src/core/edit_distance.rs:12-92). Patterns are carried as W little-endian
int32 bit-plane words (the reference uses u64 words; 32-bit words keep
the kernel free of jax_enable_x64). Sequences are 3-bit alphabet codes
(A,C,G,T,N + spare); the engine routes reads containing other bytes to the
host implementation, keeping results exact.

Per item: pattern (length mp <= 32*W) vs text (length mt <= T); returns the
Levenshtein distance (orientation-independent, so no pattern/text swapping
is needed for value equality with the reference).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# alphabet for Eq tables: A,C,G,T,N,a,c,g,t,n + "other" bucket. Two distinct
# "other" characters would falsely compare equal — the engine must host-route
# such items (they do not occur in ACGTN FASTQ/panels).
ED_ALPHA = 11
_ED_LUT = np.full(256, ED_ALPHA - 1, np.uint8)
for _i, _ch in enumerate(b"ACGTNacgtn"):
    _ED_LUT[_ch] = _i
ED_CODE_LUT = _ED_LUT


def encode_ed(seq_bytes: np.ndarray) -> np.ndarray:
    return ED_CODE_LUT[seq_bytes]


def _u(x):
    return x.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("W",))
def edit_distance_batch(
    pat_codes: jnp.ndarray,  # (B, Lp) uint8 ED codes, padded
    pat_lens: jnp.ndarray,  # (B,)
    txt_codes: jnp.ndarray,  # (B, Lt) uint8
    txt_lens: jnp.ndarray,  # (B,)
    W: int,
) -> jnp.ndarray:
    """-> (B,) int32 distances. Items with pat_len==0 return txt_len and
    vice versa (reference edit_distance.rs:165-169)."""
    B, Lp = pat_codes.shape
    _, Lt = txt_codes.shape

    # Eq tables: (B, ED_ALPHA, W) uint32 — bit i%32 of word i//32 set where
    # pattern[i] == symbol
    pi = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1)
    pvalid = pi < pat_lens[:, None]
    word = pi // 32
    bit = _u(jnp.int32(1) << (pi % 32))
    eq = jnp.zeros((B, ED_ALPHA, W), jnp.uint32)
    for w in range(W):
        in_w = pvalid & (word == w)
        contrib = jnp.where(in_w, bit, 0)
        # scatter-by-symbol via one-hot over the small alphabet; bits are
        # distinct so sum == bitwise-or
        for s in range(ED_ALPHA):
            sel = jnp.where(pat_codes == s, contrib, 0)
            eq = eq.at[:, s, w].add(jnp.sum(sel, axis=1, dtype=jnp.uint32))

    m = pat_lens
    # Pv init: m ones; per word w: ones in bits [0, clamp(m-32w, 0, 32))
    widx = jnp.arange(W)[None, :]
    nbits = jnp.clip(m[:, None] - 32 * widx, 0, 32)
    ones32 = jnp.uint32(0xFFFFFFFF)
    pv0 = jnp.where(
        nbits >= 32,
        ones32,
        (_u(jnp.int32(1) << nbits) - 1),
    ).astype(jnp.uint32)
    pv0 = jnp.where(nbits > 0, pv0, 0)
    mv0 = jnp.zeros((B, W), jnp.uint32)

    top_word = jnp.maximum(m - 1, 0) // 32
    top_bit = _u(jnp.int32(1) << ((jnp.maximum(m - 1, 0)) % 32))  # (B,)

    def step(carry, t):
        pv, mv, score = carry
        tc = txt_codes[:, t]
        active = (t < txt_lens) & (m > 0)
        eq_t = jnp.take_along_axis(
            eq, tc[:, None, None].astype(jnp.int32), axis=1
        )[:, 0, :]  # (B, W)

        # --- Myers step (Hyyrö formulation, as core/edit_distance.py) with
        # the two legitimate cross-word carry chains: the (Eq&Pv)+Pv
        # addition carry and the Ph/Mh left-shift carries. Information only
        # flows toward higher bits, so no masking of bits >= m is needed.
        new_pv = []
        new_mv = []
        ph_list = []
        mh_list = []
        hin_p = jnp.ones((B,), jnp.uint32)  # shifted-Ph bit0 (| 1)
        hin_m = jnp.zeros((B,), jnp.uint32)
        add_carry = jnp.zeros((B,), jnp.uint32)
        for w in range(W):
            eqw = eq_t[:, w]
            pvw = pv[:, w]
            mvw = mv[:, w]
            xv = eqw | mvw
            x = eqw & pvw
            s1 = x + pvw
            c1 = (s1 < x).astype(jnp.uint32)
            s2 = s1 + add_carry
            c2 = (s2 < s1).astype(jnp.uint32)
            add_carry = c1 | c2
            xh = (s2 ^ pvw) | eqw
            ph = mvw | ~(xh | pvw)
            mh = pvw & xh
            ph_list.append(ph)
            mh_list.append(mh)
            ph_sh = (ph << 1) | hin_p
            mh_sh = (mh << 1) | hin_m
            hin_p = ph >> 31
            hin_m = mh >> 31
            new_pv.append(mh_sh | ~(xv | ph_sh))
            new_mv.append(ph_sh & xv)

        pv2 = jnp.stack(new_pv, axis=1)
        mv2 = jnp.stack(new_mv, axis=1)
        hp_all = jnp.stack(ph_list, axis=1)
        hn_all = jnp.stack(mh_list, axis=1)
        hp_top = jnp.take_along_axis(hp_all, top_word[:, None], axis=1)[:, 0]
        hn_top = jnp.take_along_axis(hn_all, top_word[:, None], axis=1)[:, 0]
        delta = jnp.where(
            (hp_top & top_bit) != 0,
            1,
            jnp.where((hn_top & top_bit) != 0, -1, 0),
        ).astype(jnp.int32)
        score2 = score + jnp.where(active, delta, 0)
        pv2 = jnp.where(active[:, None], pv2, pv)
        mv2 = jnp.where(active[:, None], mv2, mv)
        return (pv2, mv2, score2), None

    (pv, mv, score), _ = jax.lax.scan(
        step, (pv0, mv0, m.astype(jnp.int32)), jnp.arange(Lt)
    )
    # empty-side rules
    score = jnp.where(m == 0, txt_lens.astype(jnp.int32), score)
    score = jnp.where(txt_lens == 0, m.astype(jnp.int32), score)
    return score
