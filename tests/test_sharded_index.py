"""Sharded-index map_read on a virtual mesh must equal the oracle."""

import numpy as np
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.indexer import Indexer
from genefuserust_jax.core.sequence import encode_bases, reverse_complement
from genefuserust_jax.models.fusion import Fusion
from genefuserust_jax.utils.synthetic import make_panel, write_panel_files


def test_sharded_matches_oracle(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from genefuserust_jax.parallel.sharded_index import (
        build_sharded_map_read,
        pack_index_sharded,
        stack_packs,
    )

    n_sh = 4
    if len(jax.devices()) < n_sh:
        pytest.skip("needs 4 devices")
    panel = make_panel(n_genes=6, chrom_len=20000, gene_len=8000)
    _, csv_path = write_panel_files(panel, str(tmp_path))
    fusions = Fusion.parse_csv(csv_path)
    ix = Indexer(panel.contigs, fusions, Settings())
    ix.make_index()

    owner, packs = pack_index_sharded(ix, n_sh)
    keys, vals, dupes, shift, D = stack_packs(packs)

    # reads: junctions between genes owned by DIFFERENT shards + in-gene
    rng = np.random.default_rng(0)
    reads = []
    for a in range(3):
        for b in range(3, 6):
            ja = panel.genes[a][2] + 4000
            jb = panel.genes[b][2] + 3000
            fused = (
                panel.contigs[panel.genes[a][1]][ja - 150 : ja + 1]
                + panel.contigs[panel.genes[b][1]][jb : jb + 150]
            )
            off = 40 + int(rng.integers(0, 30))  # junction near read center
            reads.append(fused[off : off + 160])
    for g in range(6):
        s = panel.contigs[panel.genes[g][1]]
        off = panel.genes[g][2] + int(rng.integers(0, 2000))
        reads.append(s[off : off + 160])
    reads.append(reverse_complement(reads[0]))
    L = 160
    B = len(reads)
    codes = np.full((B, L), 255, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c = encode_bases(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)

    mesh = Mesh(np.array(jax.devices()[:n_sh]), ("shard",))
    fn = build_sharded_map_read(mesh, shift, D, L)
    sv, ss, se, sc, sp = fn(
        jnp.asarray(codes),
        jnp.asarray(lens),
        jnp.asarray(keys),
        jnp.asarray(vals),
        jnp.asarray(dupes),
    )
    got = [
        [
            (int(ss[i, t]), int(se[i, t]), int(sc[i, t]), int(sp[i, t]))
            for t in range(2)
            if bool(sv[i, t])
        ]
        for i in range(B)
    ]
    exp = []
    for r in reads:
        segs = ix.map_read(r)
        exp.append(
            [
                (s.seq_start, s.seq_end, s.start_gp.contig, s.start_gp.position)
                for s in segs
            ]
        )
    assert got == exp
    # sanity: the junction reads actually produced cross-shard mappings
    assert sum(1 for g in got if len(g) == 2) >= 6
