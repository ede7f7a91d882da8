"""The device batch engine must produce results identical to the host oracle:
same merges, same matches, same fusions, byte-identical JSON."""

import numpy as np
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
from genefuserust_jax.core.scanner import Scanner, HostEngine
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)


def rand_read(rng, n):
    return "".join("ACGTN"[i] for i in rng.integers(0, 5, size=n) % 5)


def test_merge_batch_matches_scalar():
    import jax.numpy as jnp

    from genefuserust_jax.core.sequence import COMPLEMENT_LUT
    from genefuserust_jax.ops.merge import merge_batch
    from genefuserust_jax.parallel.engine import _tokenize_bytes, _round_up

    rng = np.random.default_rng(42)
    pairs = []
    # random pairs with engineered overlaps of varying quality
    for k in range(200):
        n1 = int(rng.integers(40, 152))
        n2 = int(rng.integers(40, 152))
        base = rand_read(rng, 400)
        off = int(rng.integers(0, 100))
        r1 = base[off : off + n1]
        start2 = off + int(rng.integers(-10, n1))
        r2span = base[max(0, start2) : max(0, start2) + n2]
        if len(r2span) < 16:
            r2span = base[:n2]
        q1 = "".join(chr(int(c)) for c in rng.integers(33, 74, len(r1)))
        q2 = "".join(chr(int(c)) for c in rng.integers(33, 74, len(r2span)))
        from genefuserust_jax.core.sequence import reverse_complement

        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@r{k}", r1, "+", q1),
                SequenceRead(f"@r{k}", reverse_complement(r2span), "+", q2),
            )
        )
    Lr = _round_up(max(max(len(p.left.seq), len(p.right.seq)) for p in pairs), 32)
    b1, l1 = _tokenize_bytes([p.left.seq.encode() for p in pairs], Lr)
    q1a, _ = _tokenize_bytes([p.left.quality.encode() for p in pairs], Lr)
    b2r, l2 = _tokenize_bytes(
        [
            COMPLEMENT_LUT[np.frombuffer(p.right.seq.encode(), np.uint8)][::-1].tobytes()
            for p in pairs
        ],
        Lr,
    )
    q2r, _ = _tokenize_bytes([p.right.quality.encode()[::-1] for p in pairs], Lr)
    res = merge_batch(
        jnp.asarray(b1),
        jnp.asarray(q1a),
        jnp.asarray(l1),
        jnp.asarray(b2r),
        jnp.asarray(q2r),
        jnp.asarray(l2),
    )
    merged = np.asarray(res.merged)
    out_seq = np.asarray(res.out_seq)
    out_qual = np.asarray(res.out_qual)
    out_len = np.asarray(res.out_len)
    diff = np.asarray(res.diff)
    n_merged = 0
    for i, p in enumerate(pairs):
        ref = p.fast_merge()
        if ref is None:
            assert not merged[i], f"pair {i}: device merged but scalar did not"
        else:
            n_merged += 1
            assert merged[i], f"pair {i}: scalar merged but device did not"
            n = int(out_len[i])
            assert out_seq[i, :n].tobytes().decode() == ref.seq
            assert out_qual[i, :n].tobytes().decode() == ref.quality
            assert ref.name.endswith(f"merged_diff_{int(diff[i])}")
    assert n_merged > 20  # engineered overlaps must actually exercise merging


def _scan_results(panel, pairs, tmp_path, engine, json_name):
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner = Scanner(
        csv_path,
        panel.contigs,
        "",
        str(tmp_path / json_name),
        Settings(),
        engine=engine,
        command="equality-test",
    )
    mapper = scanner.scan_pairs(pairs)
    return mapper, (tmp_path / json_name).read_text()


def test_full_scan_equality(tmp_path):
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=120)
    # add unmergeable pairs (far-apart reads -> R1/R2 independent mapping)
    g1 = panel.genes[0]
    g2 = panel.genes[1]
    jp1 = g1[2] + 5000
    jp2 = g2[2] + 6000
    fused = (
        panel.contigs[g1[1]][jp1 - 400 : jp1 + 1]
        + panel.contigs[g2[1]][jp2 : jp2 + 400]
    )
    from genefuserust_jax.core.sequence import reverse_complement

    for k in range(4):
        off = 250 + 9 * k
        r1 = fused[off : off + 150]  # spans junction
        r2 = fused[off + 260 : off + 260 + 140]  # disjoint -> no merge
        q = "I" * len(r1)
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@SYNTH:nomerge:{k}", r1, "+", q),
                SequenceRead(
                    f"@SYNTH:nomerge:{k}", reverse_complement(r2), "+", "I" * len(r2)
                ),
            )
        )
    # RC-oriented junction pairs (exercise the retry path): reads sampled
    # from the opposite strand of the fused transcript
    for k in range(3):
        off = 255 + 8 * k
        span = fused[off : off + 150]
        r1 = reverse_complement(span)  # maps with negative positions
        r2span = fused[off + 40 : off + 190]
        q = "I" * 150
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@SYNTH:rc:{k}", r1, "+", q),
                SequenceRead(f"@SYNTH:rc:{k}", r2span, "+", q),
            )
        )

    m_host, json_host = _scan_results(panel, pairs, tmp_path, HostEngine(), "host.json")
    m_dev, json_dev = _scan_results(
        panel, pairs, tmp_path, DeviceEngine(Settings(), batch_size=64), "dev.json"
    )
    assert len(m_host.fusion_results) == len(m_dev.fusion_results)
    for a, b in zip(m_host.fusion_results, m_dev.fusion_results):
        assert a.title == b.title
        assert a.unique == b.unique
        assert [(m.read.name, m.read_break, m.reversed) for m in a.matches] == [
            (m.read.name, m.read_break, m.reversed) for m in b.matches
        ]
    # JSON equality modulo the time line
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(json_host) == strip(json_dev)


def test_single_end_equality(tmp_path):
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=60)
    reads = [p.left for p in pairs] + [
        p.left.reverse_complement() for p in pairs[:5]
    ]
    _, csv_path = write_panel_files(panel, str(tmp_path))

    def run(engine, name):
        sc = Scanner(
            csv_path,
            panel.contigs,
            "",
            str(tmp_path / name),
            Settings(),
            engine=engine,
            command="se-test",
        )
        return sc.scan_singles(list(reads)), (tmp_path / name).read_text()

    mh, jh = run(HostEngine(), "h.json")
    mt, jt = run(DeviceEngine(Settings(), batch_size=32), "t.json")
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(jh) == strip(jt)
    assert [f.title for f in mh.fusion_results] == [f.title for f in mt.fusion_results]


def test_survivor_cap_overflow_equality(tmp_path):
    """Force the fused scan's fixed survivor capacity to overflow so the
    _p2_overflow fallback (ok-bitmap fetch + tail re-scan) runs; results
    must stay byte-identical to the host oracle."""
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=10, n_background=40)
    m_host, json_host = _scan_results(panel, pairs, tmp_path, HostEngine(), "h2.json")
    eng = DeviceEngine(Settings(), batch_size=64)
    eng._surv_cap = 2  # well below the planted-support survivor count
    m_dev, json_dev = _scan_results(panel, pairs, tmp_path, eng, "t2.json")
    assert len(m_host.fusion_results) == len(m_dev.fusion_results)
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(json_host) == strip(json_dev)


def test_n_bases_equality(tmp_path):
    """Reads containing N (and lowercase) bases flow through the 2-bit +
    exception-scatter upload; results must match the host oracle."""
    rng = np.random.default_rng(11)
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=40)
    # lace half the reads with Ns / lowercase at random positions
    laced = []
    for k, p in enumerate(pairs):
        if k % 2 == 0:
            laced.append(p)
            continue
        s = bytearray(p.left.seq.encode())
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(s)))
            s[pos] = ord("N") if rng.random() < 0.7 else ord("a")
        laced.append(
            SequenceReadPair(
                SequenceRead(p.left.name, s.decode(), "+", p.left.quality),
                p.right,
            )
        )
    m_host, json_host = _scan_results(panel, laced, tmp_path, HostEngine(), "hn.json")
    m_dev, json_dev = _scan_results(
        panel, laced, tmp_path, DeviceEngine(Settings(), batch_size=32), "tn.json"
    )
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(json_host) == strip(json_dev)
