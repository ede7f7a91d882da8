"""Direct equality of the fused merge-on-codes against scalar fast_merge:
merged flag, diff, length, and the merged sequence's 2-bit mapping codes
(which is what downstream mapping consumes)."""

import numpy as np

from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
from genefuserust_jax.core.sequence import reverse_complement


def test_fused_merge_matches_scalar():
    import jax.numpy as jnp

    from genefuserust_jax.ops.fused import fused_pass1_chunked
    from genefuserust_jax.ops.pack import (
        MAP_FROM_SEQ4,
        SEQ4_LUT,
        pack_q2,
        pack_seq4,
        qual_class,
    )
    from genefuserust_jax.ops.hashtable import EMPTY

    rng = np.random.default_rng(7)
    bases = "ACGTN"
    pairs = []
    for k in range(256):
        n1 = int(rng.integers(35, 160))
        n2 = int(rng.integers(35, 160))
        base = "".join(bases[i] for i in rng.integers(0, 5, 420) % 5)
        off = int(rng.integers(0, 80))
        r1 = base[off : off + n1]
        start2 = off + int(rng.integers(-20, max(1, n1 - 20)))
        r2span = base[max(0, start2) : max(0, start2) + n2]
        if len(r2span) < 16:
            r2span = base[:n2]
        q1 = "".join(chr(int(c)) for c in rng.integers(33, 75, len(r1)))
        q2 = "".join(chr(int(c)) for c in rng.integers(33, 75, len(r2span)))
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@p{k}", r1, "+", q1),
                SequenceRead(f"@p{k}", reverse_complement(r2span), "+", q2),
            )
        )
    L = 160
    B = len(pairs)
    b1 = np.zeros((B, L), np.uint8)
    q1a = np.zeros((B, L), np.uint8)
    b2 = np.zeros((B, L), np.uint8)
    q2a = np.zeros((B, L), np.uint8)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for i, p in enumerate(pairs):
        s = p.left.seq.encode()
        b1[i, : len(s)] = np.frombuffer(s, np.uint8)
        q1a[i, : len(s)] = np.frombuffer(p.left.quality.encode(), np.uint8)
        l1[i] = len(s)
        s = p.right.seq.encode()
        b2[i, : len(s)] = np.frombuffer(s, np.uint8)
        q2a[i, : len(s)] = np.frombuffer(p.right.quality.encode(), np.uint8)
        l2[i] = len(s)
    buf = np.concatenate(
        [
            pack_seq4(SEQ4_LUT[b1]),
            pack_q2(qual_class(q1a)),
            pack_seq4(SEQ4_LUT[b2]),
            pack_q2(qual_class(q2a)),
        ],
        axis=1,
    )
    lens2 = np.stack([l1, l2], axis=1).astype(np.int32)
    # trivial empty index (we only exercise the merge part)
    keys = np.zeros((16, 8), np.int32)
    keys[:] = 7  # arbitrary sentinel absent from queries' perspective is fine
    vals = np.full((16 * 8, 2), EMPTY, np.int32)
    dupes = np.full((1, 1, 2), EMPTY, np.int32)
    summary, m_codes = fused_pass1_chunked(
        jnp.asarray(buf),
        jnp.asarray(lens2),
        jnp.asarray(keys),
        jnp.asarray(vals),
        jnp.asarray(dupes),
        L,
        B,
        28,  # shift for nb=16
        1,
    )
    S = np.asarray(summary)
    mc = np.asarray(m_codes)
    map4 = MAP_FROM_SEQ4
    n_merged = 0
    for i, p in enumerate(pairs):
        ref = p.fast_merge()
        if ref is None:
            assert S[i, 0] == 0, f"pair {i}: device merged, scalar did not"
            continue
        n_merged += 1
        assert S[i, 0] == 1, f"pair {i}: scalar merged, device did not"
        assert S[i, 2] == len(ref.seq), f"pair {i}: length mismatch"
        assert f"merged_diff_{S[i, 1]}" in f"merged_diff_{S[i, 1]}"
        assert ref.name.endswith(f"merged_diff_{int(S[i, 1])}")
        # merged mapping codes equal the scalar merged read's codes
        from genefuserust_jax.core.sequence import encode_bases

        exp_codes = encode_bases(ref.seq)
        got = map4[mc[i, : len(ref.seq)]]
        assert (got == exp_codes).all(), f"pair {i}: merged codes differ"
    assert n_merged > 60
