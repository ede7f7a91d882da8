"""Edge-path coverage: exotic bytes route to the scalar oracle; deletion and
untranslated gates; multi-CSV driver with the device engine."""

import json as jsonlib

import numpy as np

from genefuserust_jax.config import Settings
from genefuserust_jax.core.read import SequenceRead, SequenceReadPair
from genefuserust_jax.core.scanner import Scanner, HostEngine
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)


def test_exotic_bytes_route_to_oracle(tmp_path):
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=5, n_background=10)
    # corrupt two junction reads with IUPAC codes (R, Y) — outside ACGTNacgtn
    for k in (0, 2):
        p = pairs[k]
        s = list(p.left.seq)
        s[5] = "R"
        s[40] = "Y"
        pairs[k] = SequenceReadPair(
            SequenceRead(p.left.name, "".join(s), "+", p.left.quality), p.right
        )
    _, csv_path = write_panel_files(panel, str(tmp_path))

    def run(engine, name):
        sc = Scanner(
            csv_path, panel.contigs, "", str(tmp_path / name), Settings(),
            engine=engine, command="x",
        )
        return sc.scan_pairs(pairs), (tmp_path / name).read_text()

    mh, jh = run(HostEngine(), "h.json")
    mt, jt = run(DeviceEngine(Settings(), batch_size=16), "t.json")
    strip = lambda s: "\n".join(
        l for l in s.splitlines() if not l.startswith('\t"time"')
    )
    assert strip(jh) == strip(jt)
    assert len(mh.fusion_results) >= 1


def test_deletion_and_untranslated_gates(tmp_path):
    # same-gene "fusion" (intra-gene deletion): junction between two
    # positions of GENE1, >50bp apart -> is_deletion -> suppressed unless -D
    panel = make_panel()
    g1 = panel.genes[0]
    s = panel.contigs[g1[1]]
    jp1 = g1[2] + 3000
    jp2 = g1[2] + 7000
    fused = s[jp1 - 300 : jp1 + 1] + s[jp2 : jp2 + 300]
    pairs = []
    for k in range(6):
        off = 300 - 150 + 20 + 9 * k
        r1 = fused[off : off + 150]
        r2 = fused[off + 40 : off + 190]
        from genefuserust_jax.core.sequence import reverse_complement

        q = "I" * 150
        pairs.append(
            SequenceReadPair(
                SequenceRead(f"@del:{k}", r1, "+", q),
                SequenceRead(f"@del:{k}", reverse_complement(r2), "+", q),
            )
        )
    _, csv_path = write_panel_files(panel, str(tmp_path))
    m_off = Scanner(
        csv_path, panel.contigs, "", "", Settings(), command="d"
    ).scan_pairs(pairs)
    assert m_off.fusion_results == []  # deletion suppressed by default
    m_on = Scanner(
        csv_path, panel.contigs, "", str(tmp_path / "d.json"),
        Settings(output_deletions=True), command="d",
    ).scan_pairs(pairs)
    assert len(m_on.fusion_results) == 1
    assert m_on.fusion_results[0].title.startswith("Deletion: ")
    parsed = jsonlib.loads((tmp_path / "d.json").read_text())
    assert list(parsed["fusions"])[0].startswith("Deletion: ")


def test_multi_csv_driver_device_engine(tmp_path, monkeypatch, capsys):
    import sys

    from genefuserust_jax.driver import RunConfig, genefuse

    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=10)
    r1, r2 = write_fastq_files(pairs, str(tmp_path))
    fa, csv_path = write_panel_files(panel, str(tmp_path))
    csv2 = tmp_path / "panel2.csv"
    csv2.write_text((tmp_path / "panel.csv").read_text())
    lst = tmp_path / "list.txt"
    lst.write_text(f"{csv_path}\n{csv2}\n")
    cfg = RunConfig(
        r1_file=r1,
        r2_file=r2,
        fusion_file=str(lst),
        html="",
        json=str(tmp_path / "out.json"),
        ref_file=fa,
        engine="device",
    )
    genefuse(cfg)
    j1 = jsonlib.loads((tmp_path / "out_panel.json").read_text())
    j2 = jsonlib.loads((tmp_path / "out_panel2.json").read_text())
    assert len(j1["fusions"]) == 1 and len(j2["fusions"]) == 1
    out = capsys.readouterr().out
    assert "#Fusion:" not in out  # multi-CSV suppresses stdout blocks
    # the shared-batch multi-CSV path must equal per-CSV single scans
    cfg_single = RunConfig(
        r1_file=r1,
        r2_file=r2,
        fusion_file=str(csv_path),
        html="",
        json=str(tmp_path / "single.json"),
        ref_file=fa,
        engine="device",
    )
    genefuse(cfg_single)
    js = jsonlib.loads((tmp_path / "single.json").read_text())
    assert js["fusions"] == j1["fusions"] == j2["fusions"]
