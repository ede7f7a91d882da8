"""PackedIndexKVS (single-probe, 8-wide rows): pack + lookup + engine
equality.

Same exactness argument as the kv16 layout (tests/test_kv16.py) at the
32B row width: one random gather per query, an overflow
marker in payload slot 3, spilled keys found via a clamped second probe.
Adds coverage for the eviction rescue in _place_single_hash (a spill whose
h2 bucket is full displaces an inline key of its flagged h1 bucket) via a
high-load randomized pack, and an engine-level full-scan equality run with
GENEFUSE_TABLE_LAYOUT=kvs.
"""

import numpy as np
from types import SimpleNamespace

from genefuserust_jax.config import Settings
from genefuserust_jax.core.indexer import Indexer
from genefuserust_jax.core.scanner import HostEngine
from genefuserust_jax.models.fusion import Fusion
from genefuserust_jax.ops.hashtable import (
    DUPE,
    EMPTY,
    KV_SLOTS,
    OVF_PAYLOAD,
    h1_np,
    h2_np,
    lookup_np,
    lookup_np_kvs,
    pack_index,
    pack_index_kvs,
)
from genefuserust_jax.utils.synthetic import make_panel, write_panel_files


def _fake_indexer(keys, contigs, poss, dup_threshold=5):
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


def test_kvs_roundtrip_vs_split(tmp_path):
    ix = _build_panel_indexer(tmp_path)
    split = pack_index(ix)
    pkvs = pack_index_kvs(ix)
    assert pkvs is not None
    assert pkvs.kv_tbl.shape[1] == 2 * KV_SLOTS
    rng = np.random.default_rng(0)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    cs, ps = lookup_np(split, probe)
    ck, pk = lookup_np_kvs(pkvs, probe)
    assert (cs == ck).all()
    reg = cs >= 0
    assert (ps[reg] == pk[reg]).all()
    c_s, _ = lookup_np_kvs(pkvs, np.array([pkvs.empty_key], np.uint32))
    assert c_s[0] == EMPTY


def test_kvs_overflow_flag_and_spill():
    # 12 keys sharing one h1 bucket at the nb the packer will choose
    # (n=42 keys, target_load=1.0 -> nb=64, shift=26) force the flag +
    # spill machinery (4-slot buckets overflow at >4 keys)
    rng = np.random.default_rng(11)
    target_bucket, colliders, others = 5, [], []
    seen = set()
    while len(colliders) < 12 or len(others) < 30:
        k = np.uint32(rng.integers(0, 2**32))
        if int(k) in seen:
            continue
        seen.add(int(k))
        ka = np.array([k], np.uint32)
        if int(h1_np(ka, 26)[0]) == target_bucket:
            if len(colliders) < 12 and int(h2_np(ka, 26)[0]) != target_bucket:
                colliders.append(int(k))
        elif len(others) < 30:
            others.append(int(k))
    keys = np.array(colliders + others, np.uint32)
    n = len(keys)
    contigs = (np.arange(n, dtype=np.int32) % 7).astype(np.int32)
    poss = (np.arange(n, dtype=np.int32) * 13 + 100).astype(np.int32)
    pkvs = pack_index_kvs(_fake_indexer(keys, contigs, poss))
    assert pkvs is not None
    if pkvs.n_buckets == 64:  # placement succeeded without doubling
        row = pkvs.kv_tbl[target_bucket]
        assert row[2 * KV_SLOTS - 1] == OVF_PAYLOAD
    c, p = lookup_np_kvs(pkvs, keys)
    assert (c == contigs).all()
    assert (p == poss).all()
    probes = []
    while len(probes) < 3000:
        k = int(rng.integers(0, 2**32))
        if k in seen or k == pkvs.empty_key:
            continue
        probes.append(k)
    c, _ = lookup_np_kvs(pkvs, np.array(probes, np.uint32))
    assert (c == EMPTY).all()


def test_kvs_high_load_pack_exercises_eviction():
    # target_load=4.0 over 4-slot buckets: most buckets overflow, spills
    # are plentiful, and spill targets fill up — the eviction rescue (or a
    # doubling) must still yield an exact table for every key
    rng = np.random.default_rng(3)
    keys = np.unique(
        rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    )
    n = len(keys)
    contigs = (np.arange(n, dtype=np.int32) % 5).astype(np.int32)
    poss = (np.arange(n, dtype=np.int32) * 7 + 50).astype(np.int32)
    pkvs = pack_index_kvs(_fake_indexer(keys, contigs, poss), target_load=4.0)
    assert pkvs is not None
    c, p = lookup_np_kvs(pkvs, keys)
    assert (c == contigs).all()
    assert (p == poss).all()
    # misses stay misses under heavy flagging
    seen = set(keys.tolist())
    probes = [
        k
        for k in rng.integers(0, 2**32, size=5000, dtype=np.uint64).astype(np.uint32).tolist()
        if k not in seen and k != pkvs.empty_key
    ]
    c, _ = lookup_np_kvs(pkvs, np.array(probes, np.uint32))
    assert (c == EMPTY).all()


def test_kvs_pack_deterministic(tmp_path):
    ix = _build_panel_indexer(tmp_path)
    a = pack_index_kvs(ix)
    b = pack_index_kvs(ix)
    assert (a.kv_tbl == b.kv_tbl).all()
    assert (a.dupes == b.dupes).all()
    assert (a.n_buckets, a.shift, a.cbits, a.pos_bias, a.empty_key) == (
        b.n_buckets, b.shift, b.cbits, b.pos_bias, b.empty_key
    )


def test_kvs_device_kernel_matches_oracle(tmp_path):
    import jax.numpy as jnp

    from genefuserust_jax.ops.map_read import kvs_lookup

    ix = _build_panel_indexer(tmp_path)
    pkvs = pack_index_kvs(ix)
    rng = np.random.default_rng(5)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    valid = rng.random(probe.shape) < 0.9
    co, po = lookup_np_kvs(pkvs, probe)
    cd, pd = kvs_lookup(
        jnp.asarray(pkvs.kv_tbl), pkvs.shift, pkvs.cbits, pkvs.pos_bias,
        jnp.asarray(probe), jnp.asarray(valid),
    )
    cd, pd = np.asarray(cd), np.asarray(pd)
    exp_c = np.where(valid, co, EMPTY)
    assert (cd == exp_c).all()
    live = valid & (co >= 0)
    assert (pd[live] == po[live]).all()
    dup = valid & (co == DUPE)
    assert (pd[dup] == po[dup]).all()


def test_kv4_narrow_rows_roundtrip_and_device(tmp_path):
    # kv4 = pack_index_kv with 2 slots/bucket: 4xint32 rows, same 2-gather
    # kernel (kv_lookup derives the slot count from the table shape)
    import jax.numpy as jnp

    from genefuserust_jax.ops.hashtable import lookup_np_kv, pack_index_kv
    from genefuserust_jax.ops.map_read import kv_lookup

    ix = _build_panel_indexer(tmp_path)
    split = pack_index(ix)
    p4 = pack_index_kv(ix, slots=2)
    assert p4 is not None
    assert p4.kv_tbl.shape[1] == 4
    rng = np.random.default_rng(9)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    cs, ps = lookup_np(split, probe)
    c4, p4v = lookup_np_kv(p4, probe)
    assert (cs == c4).all()
    reg = cs >= 0
    assert (ps[reg] == p4v[reg]).all()
    valid = rng.random(probe.shape) < 0.9
    cd, pd = kv_lookup(
        jnp.asarray(p4.kv_tbl), p4.shift, p4.cbits, p4.pos_bias,
        jnp.asarray(probe), jnp.asarray(valid),
    )
    cd, pd = np.asarray(cd), np.asarray(pd)
    assert (cd == np.where(valid, c4, EMPTY)).all()
    live = valid & (c4 >= 0)
    assert (pd[live] == p4v[live]).all()


def test_kv2_single_slot_roundtrip_and_device(tmp_path):
    # kv2 = pack_index_kv with 1 slot/bucket (classic 2-choice cuckoo):
    # 2xint32 rows, same shape-generic 2-gather kernel
    import jax.numpy as jnp

    from genefuserust_jax.ops.hashtable import lookup_np_kv, pack_index_kv
    from genefuserust_jax.ops.map_read import kv_lookup

    ix = _build_panel_indexer(tmp_path)
    split = pack_index(ix)
    p2 = pack_index_kv(ix, target_load=0.5, slots=1)
    assert p2 is not None
    assert p2.kv_tbl.shape[1] == 2
    rng = np.random.default_rng(13)
    keys = np.fromiter(ix.kmer_gp.keys(), np.uint32)
    probe = np.concatenate(
        [keys, rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)]
    )
    cs, ps = lookup_np(split, probe)
    c2, p2v = lookup_np_kv(p2, probe)
    assert (cs == c2).all()
    reg = cs >= 0
    assert (ps[reg] == p2v[reg]).all()
    valid = rng.random(probe.shape) < 0.9
    cd, pd = kv_lookup(
        jnp.asarray(p2.kv_tbl), p2.shift, p2.cbits, p2.pos_bias,
        jnp.asarray(probe), jnp.asarray(valid),
    )
    cd, pd = np.asarray(cd), np.asarray(pd)
    assert (cd == np.where(valid, c2, EMPTY)).all()
    live = valid & (c2 >= 0)
    assert (pd[live] == p2v[live]).all()


def test_kvs_half_size_pack_via_walk():
    # target_load=2.0 (keys/bucket) over 4-slot buckets: ~5% of buckets
    # flag, ~6% of keys spill, and enough spill targets fill up that the
    # constrained cuckoo walk must run — the packed table must stay exact
    rng = np.random.default_rng(17)
    keys = np.unique(
        rng.integers(0, 2**32, size=300_000, dtype=np.uint64).astype(np.uint32)
    )
    n = len(keys)
    contigs = (np.arange(n, dtype=np.int32) % 5).astype(np.int32)
    poss = (np.arange(n, dtype=np.int32) * 3 + 10).astype(np.int32)
    pkvs = pack_index_kvs(_fake_indexer(keys, contigs, poss), target_load=2.0)
    assert pkvs is not None
    # placement should succeed without doubling past the initial nb
    assert pkvs.n_buckets <= max(16, 1 << int(np.ceil(np.log2(n / 2.0))))
    c, p = lookup_np_kvs(pkvs, keys)
    assert (c == contigs).all()
    assert (p == poss).all()


import pytest


@pytest.mark.parametrize("layout", ["kvs", "kv2"])
def test_engine_full_scan_equality_alt_layouts(tmp_path, monkeypatch, layout):
    # the production engine with GENEFUSE_TABLE_LAYOUT pinned to an
    # alternate table layout must match the host oracle (results + JSON)
    # on a planted-fusion panel (kv4, the default, is covered by the main
    # engine equality suite)
    from genefuserust_jax.core.scanner import Scanner
    from genefuserust_jax.parallel.engine import DeviceEngine
    from genefuserust_jax.utils.synthetic import plant_fusion_pairs

    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=100)
    _, csv_path = write_panel_files(panel, str(tmp_path))

    def scan(engine, name):
        scanner = Scanner(
            csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
            engine=engine, command="layout-equality-test",
        )
        mapper = scanner.scan_pairs(pairs)
        return mapper, (tmp_path / name).read_text()

    m_host, json_host = scan(HostEngine(), "host.json")
    monkeypatch.setenv("GENEFUSE_TABLE_LAYOUT", layout)
    m_alt, json_alt = scan(DeviceEngine(Settings(), batch_size=64), "alt.json")
    assert len(m_host.fusion_results) == len(m_alt.fusion_results)
    for a, b in zip(m_host.fusion_results, m_alt.fusion_results):
        assert a.title == b.title
        assert a.unique == b.unique
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(json_host) == strip(json_alt)
