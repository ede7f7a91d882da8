"""PackedIndexKV16 (single-gather table): pack + lookup correctness.

The layout's exactness argument (genefuserust_jax/ops/hashtable.py
PackedIndexKV16 docstring) has two load-bearing pieces this file pins:

  1. every key — including keys spilled out of an overflowed h1 bucket —
     resolves to the same (contig, pos) as the split-layout oracle;
  2. the overflow marker / clamped second probe can never produce a false
     match (misses stay misses, even for queries equal to the absent-key
     sentinel or hashing into marked rows).

Covers the natural panel path (device map_read equality lives in
test_device_map_read.py) and an adversarial same-h1 panel that forces the
flag + spill machinery.
"""

import numpy as np
from types import SimpleNamespace

from genefuserust_jax.config import Settings
from genefuserust_jax.models.fusion import Fusion
from genefuserust_jax.core.indexer import Indexer
from genefuserust_jax.ops.hashtable import (
    DUPE,
    EMPTY,
    KV16_SLOTS,
    OVF_PAYLOAD,
    h1_np,
    h2_np,
    lookup_np,
    lookup_np_kv16,
    pack_index,
    pack_index_kv16,
)
from genefuserust_jax.utils.synthetic import make_panel, write_panel_files


def _fake_indexer(keys, contigs, poss, dup_threshold=5):
    """Minimal stand-in exposing the grouped-array surface that
    _entries_from_indexer consumes (all keys unique here)."""
    n = len(keys)
    return SimpleNamespace(
        settings=SimpleNamespace(skip_key_dup_threshold=dup_threshold),
        uniq_keys=np.asarray(keys, np.uint32),
        group_count=np.ones(n, np.int64),
        group_start=np.arange(n, dtype=np.int64),
        se_contig=np.asarray(contigs, np.int32),
        se_pos=np.asarray(poss, np.int32),
    )


def _build_panel_indexer(tmp_path):
    panel = make_panel()
    _, csv_path = write_panel_files(panel, str(tmp_path))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    return ix


def test_kv16_roundtrip_vs_split(tmp_path):
    ix = _build_panel_indexer(tmp_path)
    split = pack_index(ix)
    p16 = pack_index_kv16(ix)
    assert p16 is not None
    assert p16.kv_tbl.shape[1] == 2 * KV16_SLOTS
    rng = np.random.default_rng(0)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    cs, ps = lookup_np(split, probe)
    ck, pk = lookup_np_kv16(p16, probe)
    assert (cs == ck).all()
    reg = cs >= 0
    assert (ps[reg] == pk[reg]).all()
    # the absent-key sentinel itself must miss (it matches empty key slots
    # whose payload is 0 -> tag 0 -> EMPTY)
    c_s, _ = lookup_np_kv16(p16, np.array([p16.empty_key], np.uint32))
    assert c_s[0] == EMPTY


def test_kv16_overflow_flag_and_spill():
    # force >8 keys into ONE h1 bucket at the nb the packer will choose
    # (n<=64 keys -> nb=16, shift=28), so the pack must flag the bucket and
    # spill keys into their h2 buckets
    rng = np.random.default_rng(7)
    target_bucket, colliders, others = 5, [], []
    seen = set()
    while len(colliders) < 12 or len(others) < 30:
        k = np.uint32(rng.integers(0, 2**32))
        if int(k) in seen:
            continue
        seen.add(int(k))
        ka = np.array([k], np.uint32)
        if int(h1_np(ka, 28)[0]) == target_bucket:
            # keep spill targets off the flagged bucket so placement
            # succeeds at the first nb (h2 == h1 would force a doubling)
            if len(colliders) < 12 and int(h2_np(ka, 28)[0]) != target_bucket:
                colliders.append(int(k))
        elif len(others) < 30:
            others.append(int(k))
    keys = np.array(colliders + others, np.uint32)
    n = len(keys)
    contigs = (np.arange(n, dtype=np.int32) % 7).astype(np.int32)
    poss = (np.arange(n, dtype=np.int32) * 13 + 100).astype(np.int32)
    ix = _fake_indexer(keys, contigs, poss)
    p16 = pack_index_kv16(ix)
    assert p16 is not None
    assert p16.n_buckets == 16
    # the collider bucket must carry the overflow marker
    row = p16.kv_tbl[target_bucket]
    assert row[2 * KV16_SLOTS - 1] == OVF_PAYLOAD
    # sentinel key in the marker slot so no real query can match it
    assert row[KV16_SLOTS - 1] == np.int32(
        p16.empty_key - (1 << 32) if p16.empty_key >= 1 << 31 else p16.empty_key
    )
    # every key (inline AND spilled) resolves exactly
    c, p = lookup_np_kv16(p16, keys)
    assert (c == contigs).all()
    assert (p == poss).all()
    # misses stay misses — including queries that hash INTO the flagged
    # bucket (they take the second probe and still miss)
    probes, hit_flagged = [], 0
    while len(probes) < 3000:
        k = int(rng.integers(0, 2**32))
        if k in seen or k == p16.empty_key:
            continue
        probes.append(k)
        if int(h1_np(np.array([k], np.uint32), 28)[0]) == target_bucket:
            hit_flagged += 1
    assert hit_flagged > 0, "probe set must exercise the flagged bucket"
    c, _ = lookup_np_kv16(p16, np.array(probes, np.uint32))
    assert (c == EMPTY).all()


def test_kv16_pack_deterministic(tmp_path):
    ix = _build_panel_indexer(tmp_path)
    a = pack_index_kv16(ix)
    b = pack_index_kv16(ix)
    assert (a.kv_tbl == b.kv_tbl).all()
    assert (a.dupes == b.dupes).all()
    assert (a.n_buckets, a.shift, a.cbits, a.pos_bias, a.empty_key) == (
        b.n_buckets, b.shift, b.cbits, b.pos_bias, b.empty_key
    )


def test_kv16_device_kernel_matches_oracle(tmp_path):
    import jax.numpy as jnp

    from genefuserust_jax.ops.map_read import kv16_lookup

    ix = _build_panel_indexer(tmp_path)
    p16 = pack_index_kv16(ix)
    rng = np.random.default_rng(3)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    valid = rng.random(probe.shape) < 0.9  # exercise the invalid clamp
    co, po = lookup_np_kv16(p16, probe)
    cd, pd = kv16_lookup(
        jnp.asarray(p16.kv_tbl), p16.shift, p16.cbits, p16.pos_bias,
        jnp.asarray(probe), jnp.asarray(valid),
    )
    cd, pd = np.asarray(cd), np.asarray(pd)
    exp_c = np.where(valid, co, EMPTY)
    assert (cd == exp_c).all()
    live = valid & (co >= 0)
    assert (pd[live] == po[live]).all()
    dup = valid & (co == DUPE)
    assert (pd[dup] == po[dup]).all()
