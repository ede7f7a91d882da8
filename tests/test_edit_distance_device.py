"""Device Myers edit distance must equal the host implementation."""

import numpy as np

from genefuserust_jax.core.edit_distance import edit_distance
from genefuserust_jax.ops.edit_distance import (
    ED_CODE_LUT,
    edit_distance_batch,
)


def _batch(pairs):
    import jax.numpy as jnp

    Lp = max(max(len(a) for a, _ in pairs), 1)
    Lt = max(max(len(b) for _, b in pairs), 1)
    B = len(pairs)
    pc = np.zeros((B, Lp), np.uint8)
    tc = np.zeros((B, Lt), np.uint8)
    pl = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(pairs):
        pc[i, : len(a)] = ED_CODE_LUT[np.frombuffer(a.encode(), np.uint8)]
        tc[i, : len(b)] = ED_CODE_LUT[np.frombuffer(b.encode(), np.uint8)]
        pl[i] = len(a)
        tl[i] = len(b)
    W = max(1, (Lp + 31) // 32)
    out = edit_distance_batch(
        jnp.asarray(pc), jnp.asarray(pl), jnp.asarray(tc), jnp.asarray(tl), W
    )
    return np.asarray(out)


def test_device_ed_matches_host():
    rng = np.random.default_rng(0)
    pairs = []
    bases = "ACGTN"
    for _ in range(300):
        la = int(rng.integers(1, 180))
        lb = int(rng.integers(1, 180))
        a = "".join(bases[i] for i in rng.integers(0, 5, la))
        # half the time: b = mutated a
        if rng.random() < 0.5:
            b = list(a)
            for _ in range(int(rng.integers(0, 10))):
                p = int(rng.integers(0, len(b)))
                op = rng.random()
                if op < 0.4:
                    b[p] = bases[int(rng.integers(0, 4))]
                elif op < 0.7 and len(b) > 1:
                    del b[p]
                else:
                    b.insert(p, bases[int(rng.integers(0, 4))])
            b = "".join(b)[:lb] or "A"
        else:
            b = "".join(bases[i] for i in rng.integers(0, 5, lb))
        pairs.append((a, b))
    pairs += [("", "ACGT"), ("ACGT", ""), ("A", "A"), ("A", "T")]
    # word-boundary lengths
    for L in (31, 32, 33, 63, 64, 65, 127, 128):
        a = "".join(bases[i] for i in rng.integers(0, 4, L))
        b = "".join(bases[i] for i in rng.integers(0, 4, L))
        pairs.append((a, b))
        pairs.append((a, a))
    got = _batch(pairs)
    exp = np.array([edit_distance(a, b) for a, b in pairs])
    assert (got == exp).all(), np.nonzero(got != exp)


def test_device_ed_goldens():
    # reference edit_distance.rs:221-261 goldens
    s1 = "CCTATCAGGGAGCTGTGGGCCAGCCAGGAGGCAGCACATGCCCAATCCCAGGCCCCTCCCGTTGTAAGTTCCCGTTCTACCCGACAGGGACCTGCTGACAAAAGACAGGGCTGGAGAGCCAGCCTGAAGGCCCTGGGACCCTTCTATCCAC"
    s2 = "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTATAAAGTACCCATCTAGTACTTCAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACACAGTAAGATCGGA"
    s2b = "ACTTATGTTTTTAAATGAGGATTATTGATAGTACTCTTGGTTTTTATACCATTCAGATCACTGAATTTATAAAGTACCCATCTAGTACTTGAAAAAGTAAAGTGTTCTGCCAGATCTTAGGTATAGAGGACCCTAACACAGTAAGATCGGA"
    got = _batch([(s1, s1), (s2, s2b)])
    assert list(got) == [0, 1]
