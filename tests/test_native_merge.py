"""The native C++ merge+pack (gf_merge_pack_pe2) must be bit-exact with
the scalar fast_merge oracle (core/read.py:52-119; reference
read.rs:313-440), including 2-bit packing and non-ACGT exception capture."""

import numpy as np
import pytest

from genefuserust_jax import native
from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
from genefuserust_jax.core.sequence import BASE_CODE_LUT

RC = {65: 84, 84: 65, 67: 71, 71: 67}


def _gen_batch(rng, B, Lin):
    bases = np.frombuffer(b"ACGT", np.uint8)
    b1 = np.zeros((B, Lin), np.uint8)
    q1 = np.zeros((B, Lin), np.uint8)
    b2 = np.zeros((B, Lin), np.uint8)
    q2 = np.zeros((B, Lin), np.uint8)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for r in range(B):
        kind = r % 8
        n1 = int(rng.integers(100, Lin - 8))
        n2 = int(rng.integers(100, Lin - 8))
        if kind == 7:  # short/empty reads (below MIN_OVERLAP)
            n1 = int(rng.integers(0, 40))
            n2 = int(rng.integers(0, 40))
        lo = max(n1, n2, 1)
        hi = max(n1 + n2 - 25, lo + 1)
        ins = int(rng.integers(lo, hi))
        frag = rng.choice(bases, max(ins, n1, n2, 1))
        r1 = frag[:n1].copy()
        r2c = frag[max(0, ins - n2) : ins].copy()
        r2 = (
            np.array([RC.get(int(x), 78) for x in r2c[::-1]], np.uint8)
            if len(r2c)
            else np.zeros(0, np.uint8)
        )
        n2 = len(r2)
        if kind == 1:  # unrelated pair
            r2 = rng.choice(bases, n2)
        if kind == 2 and n1 > 5:  # substitution errors in the overlap
            for _ in range(3):
                p = int(rng.integers(0, n1))
                r1[p] = rng.choice(bases)
        if kind == 3 and n1 > 5:  # N bases (exception path)
            r1[int(rng.integers(0, n1))] = ord("N")
        if kind == 4 and n1 > 5:  # lowercase (exception path)
            r1[int(rng.integers(0, n1))] = ord("a")
        if kind == 5 and n1 > 5:  # exotic byte (oracle routing)
            r1[int(rng.integers(0, n1))] = ord("X")
        b1[r, : len(r1)] = r1
        l1[r] = len(r1)
        b2[r, : len(r2)] = r2
        l2[r] = len(r2)
        q1[r, : l1[r]] = rng.integers(33, 74, l1[r])
        q2[r, : l2[r]] = rng.integers(33, 74, l2[r])
    return b1, q1, b2, q2, l1, l2


def _unpack2(row, n, exc_cols):
    c = np.stack(
        [row & 3, (row >> 2) & 3, (row >> 4) & 3, (row >> 6) & 3], -1
    ).reshape(-1)[:n].astype(np.uint8)
    c[exc_cols] = 255
    return c


@pytest.mark.parametrize("impl", ["native", "fallback"])
def test_merge_pack_matches_oracle(impl):
    rng = np.random.default_rng(7)
    B, Lin, L = 2000, 160, 160
    b1, q1, b2, q2, l1, l2 = _gen_batch(rng, B, Lin)
    if impl == "native":
        if not native.available():
            pytest.skip("native library unavailable")
        res = native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, L)
    else:
        res = native.merge_pack_pe_fallback(b1, q1, b2, q2, l1, l2, L)
    mrow = 0
    urow = 0
    rw = res["rwork"]
    m_exc = res["m_exc"]
    u_exc = res["u_exc"]
    n_merged = 0
    for r in range(B):
        s1 = b1[r, : l1[r]].tobytes().decode("latin-1")
        s2 = b2[r, : l2[r]].tobytes().decode("latin-1")
        ex = any(c not in "ACGTNacgtn" for c in s1 + s2)
        assert res["exotic"][r] == ex
        if ex or (l1[r] == 0 and l2[r] == 0):
            assert not res["m_flag"][r]
            continue
        pair = SequenceReadPair(
            SequenceRead("x", s1, "+", q1[r, : l1[r]].tobytes().decode("latin-1")),
            SequenceRead("x", s2, "+", q2[r, : l2[r]].tobytes().decode("latin-1")),
        )
        m = pair.fast_merge()
        assert res["m_flag"][r] == (m is not None)
        if m is not None:
            n_merged += 1
            assert res["m_len"][r] == len(m.seq)
            want = BASE_CODE_LUT[np.frombuffer(m.seq.encode("latin-1"), np.uint8)]
            cols = m_exc[m_exc[:, 0] == mrow, 1]
            got = _unpack2(res["mbuf"][mrow], len(m.seq), cols)
            assert np.array_equal(got, want), (r, "merged codes")
            mrow += 1
        else:
            for lane, n in ((1, int(l1[r])), (2, int(l2[r]))):
                if n > 0:
                    assert tuple(rw[urow]) == (r, lane, n)
                    src = b1[r] if lane == 1 else b2[r]
                    want = BASE_CODE_LUT[src][:n]
                    cols = u_exc[u_exc[:, 0] == urow, 1]
                    got = _unpack2(res["ubuf"][urow], n, cols)
                    assert np.array_equal(got, want), (r, lane, "lane codes")
                    urow += 1
    assert urow == len(rw)
    assert n_merged > 300  # the generator must actually exercise merging


def test_native_and_fallback_agree():
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(23)
    b1, q1, b2, q2, l1, l2 = _gen_batch(rng, 600, 128)
    a = native.merge_pack_pe_batch(b1, q1, b2, q2, l1, l2, 128)
    b = native.merge_pack_pe_fallback(b1, q1, b2, q2, l1, l2, 128)
    for k in ("m_flag", "m_len", "exotic", "mbuf", "rwork", "ubuf", "m_exc", "u_exc"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
