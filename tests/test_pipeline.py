"""End-to-end pipeline tests: planted fusions must be detected; tinyref
testdata must produce a clean zero-fusion report; JSON layout sanity."""

import json as jsonlib

import numpy as np
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.io import fasta
from genefuserust_jax.io.fastq import FastqReaderPair
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)


@pytest.fixture(scope="module")
def panel():
    return make_panel()


def test_planted_fusion_detected(panel, tmp_path):
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=40)
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner = Scanner(
        csv_path,
        panel.contigs,
        str(tmp_path / "out.html"),
        str(tmp_path / "out.json"),
        Settings(),
        command="test-run",
    )
    mapper = scanner.scan_pairs(pairs)
    assert len(mapper.fusion_results) == 1
    fr = mapper.fusion_results[0]
    assert "GENE1" in fr.title and "GENE2" in fr.title
    assert fr.title.startswith("Fusion: ")
    assert fr.unique >= 2
    assert len(fr.matches) == 6
    # fusion point at gene-relative 5000 / 6000 (+-3 adjust window)
    assert abs(fr.left_gp.position - 5000) <= 3
    assert abs(fr.right_gp.position - 6000) <= 3
    # reports exist and html contains the title
    html = (tmp_path / "out.html").read_text()
    assert fr.title in html
    assert "Supporting reads:" in html
    txt = (tmp_path / "out.json").read_text()
    assert f'"{fr.title}"' in txt
    # json parses after stripping the unescaped-command line? our command has
    # no quotes, so the hand-rolled json must parse as real JSON here
    parsed = jsonlib.loads(txt)
    assert parsed["version"] == "0.1.2"
    fusion = parsed["fusions"][fr.title]
    assert fusion["unique"] == fr.unique
    assert len(fusion["reads"]) == 6
    assert fusion["left"]["gene_name"] == "GENE1"
    assert fusion["right"]["gene_name"] == "GENE2"


def test_background_only_no_fusions(panel, tmp_path):
    pairs = plant_fusion_pairs(panel, n_support=0, n_background=30)
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner = Scanner(csv_path, panel.contigs, "", "", Settings(), command="t")
    mapper = scanner.scan_pairs(pairs)
    assert mapper.fusion_results == []


def test_tinyref_zero_fusions(refdata, tmp_path):
    # The panel chromosomes are absent from tinyref -> empty index -> no
    # fusions, but the full pipeline (incl. reports) must run cleanly.
    contigs = fasta.read_all(str(refdata / "tinyref.fa"))
    scanner = Scanner(
        str(refdata / "fusions.csv"),
        contigs,
        str(tmp_path / "g.html"),
        str(tmp_path / "g.json"),
        Settings(),
        command="tiny",
    )
    pairs = FastqReaderPair(str(refdata / "R1.fq"), str(refdata / "R2.fq"))
    mapper = scanner.scan_pairs(pairs)
    assert mapper.fusion_results == []
    assert "Found 0 fusion" in (tmp_path / "g.html").read_text()
    parsed = jsonlib.loads((tmp_path / "g.json").read_text())
    assert parsed["fusions"] == {}


def test_zero_fusions_seeded(panel, tmp_path):
    # as with tinyref: the panel's chromosomes are absent from the FASTA,
    # so the index is empty and no fusion is found, but the whole pipeline
    # (FASTQ pair reader, reports) must run cleanly
    from genefuserust_jax.utils.synthetic import random_seq, write_fastq_files

    rng = np.random.default_rng(8)
    fa = tmp_path / "other.fa"
    fa.write_text("".join(f">contig{i}\n{random_seq(rng, 500)}\n" for i in (1, 2)))
    _, csv_path = write_panel_files(panel, str(tmp_path))
    r1, r2 = write_fastq_files(
        plant_fusion_pairs(panel, n_support=3, n_background=10), str(tmp_path)
    )
    scanner = Scanner(
        csv_path,
        fasta.read_all(str(fa)),
        str(tmp_path / "g.html"),
        str(tmp_path / "g.json"),
        Settings(),
        command="tiny",
    )
    mapper = scanner.scan_pairs(FastqReaderPair(r1, r2))
    assert mapper.fusion_results == []
    assert "Found 0 fusion" in (tmp_path / "g.html").read_text()
    parsed = jsonlib.loads((tmp_path / "g.json").read_text())
    assert parsed["fusions"] == {}


def test_unique_requirement_gate(panel, tmp_path):
    # all support reads identical -> unique==1 < 2 -> rejected
    pairs = plant_fusion_pairs(panel, n_support=1, n_background=0)
    pairs = pairs * 5
    _, csv_path = write_panel_files(panel, str(tmp_path))
    scanner = Scanner(csv_path, panel.contigs, "", "", Settings(), command="t")
    mapper = scanner.scan_pairs(pairs)
    assert mapper.fusion_results == []
    # with unique_requirement=1 it must pass
    scanner = Scanner(
        csv_path, panel.contigs, "", "", Settings(unique_requirement=1), command="t"
    )
    mapper = scanner.scan_pairs(pairs)
    assert len(mapper.fusion_results) == 1
    assert mapper.fusion_results[0].unique == 1
