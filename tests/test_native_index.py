"""Equality tests for the native host index helpers (native/gfnative.cpp).

The native paths are pure accelerations; each must be element-identical to
its numpy/scalar fallback (which the rest of the suite validates against
the reference's semantics).
"""

import numpy as np
import pytest

from genefuserust_jax import native
from genefuserust_jax.core.matcher import Matcher

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def test_sort_entries_matches_stable_argsort():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 4096, 1_000_000):
        k = rng.integers(0, 1 << 32, n).astype(np.uint32)
        if n >= 4096:  # heavy duplicate blocks to exercise stability
            k[: n // 3] = k[0]
            k[n // 3 : n // 2] = np.uint32(0)
        c = rng.integers(-3, 3, n).astype(np.int32)
        p = np.arange(n, dtype=np.int32)
        ks, cs, ps = native.sort_entries_by_kmer(k, c, p)
        order = np.argsort(k, kind="stable")
        assert np.array_equal(ks, k[order])
        assert np.array_equal(cs, c[order])
        assert np.array_equal(ps, p[order])


def test_group_starts_matches_numpy():
    rng = np.random.default_rng(6)
    for n in (0, 1, 2, 1000, 500_000):
        k = np.sort(rng.integers(0, max(1, n // 3) + 1, n).astype(np.uint32))
        starts = native.group_starts(k)
        if n == 0:
            assert len(starts) == 0
            continue
        first = np.concatenate([[True], k[1:] != k[:-1]])
        assert np.array_equal(starts, np.nonzero(first)[0])


def _random_genome(rng, n, polya_runs=20):
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    for _ in range(polya_runs):
        off = int(rng.integers(0, n - 40))
        ln = int(rng.integers(10, 40))
        seq[off : off + ln] = ord("A")
    # sprinkle invalid bases (N and lowercase are invalid to the scan; the
    # contig is uppercased by Matcher so only N survives as invalid)
    for _ in range(30):
        seq[int(rng.integers(0, n))] = ord("N")
    return seq.tobytes().decode("latin-1")


def test_matcher_scan_matches_numpy_fallback(monkeypatch):
    rng = np.random.default_rng(7)
    contigs = {
        "chr1": _random_genome(rng, 20_000),
        "chr2": "A" * 100 + _random_genome(rng, 5_000),
        "tiny": "ACGT",  # below KMER: skipped entirely
    }
    # candidate seqs seed the (quirky) bloom: cover a subset of base codes
    seqs = ["ACGT" * 10, "TTTT" * 10]
    m_native = Matcher(contigs, seqs)

    monkeypatch.setattr(native, "matcher_scan", lambda codes, bits: None)
    m_numpy = Matcher(contigs, seqs)

    assert m_native.contig_names == m_numpy.contig_names
    assert set(m_native.kmer_positions) == set(m_numpy.kmer_positions)
    for k in m_numpy.kmer_positions:
        assert m_native.kmer_positions[k] == m_numpy.kmer_positions[k], k


def test_matcher_scan_empty_bloom():
    out = native.matcher_scan(
        np.zeros(100, np.uint8), bloom_bits=set()
    )
    assert out is not None and len(out[0]) == 0
