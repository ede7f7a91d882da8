"""Reporter byte-layout regression tests: exact fragments the reference's
writers emit (derived from html_reporter.rs / json_reporter.rs write!
calls), plus stdout block format."""

import io
import json as jsonlib

import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rep")
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=5, n_background=20)
    _, csv_path = write_panel_files(panel, str(tmp))
    scanner = Scanner(
        csv_path,
        panel.contigs,
        str(tmp / "r.html"),
        str(tmp / "r.json"),
        Settings(),
        command="cmd -1 a -2 b",
    )
    mapper = scanner.scan_pairs(pairs)
    return mapper, (tmp / "r.html").read_text(), (tmp / "r.json").read_text()


def test_json_layout(reports):
    mapper, html, js = reports
    # exact reference layout fragments (json_reporter.rs:37-109)
    assert js.startswith('{\n\t"command":"cmd -1 a -2 b",\n\t"version":"0.1.2",\n')
    assert '\t"fusions":{\n' in js
    assert '\t\t\t"left":{\n' in js
    assert '\t\t\t}, \n' in js  # trailing ", " after side blocks — faithful
    assert '\t\t\t"unique":' in js
    assert '\t\t\t"reads":[\n' in js
    assert js.endswith("\n\t}\n}\n\n")
    parsed = jsonlib.loads(js)
    fr = mapper.fusion_results[0]
    j = parsed["fusions"][fr.title]
    assert j["left"]["exon_or_intron"] in ("exon", "intron")
    assert j["left"]["strand"] in ("forward", "reversed")
    assert isinstance(j["left"]["position"], int)
    assert len(j["reads"]) == len(fr.matches)
    assert j["reads"][0]["break"] == fr.matches[0].read_break


def test_html_layout(reports):
    mapper, html, js = reports
    fr = mapper.fusion_results[0]
    # header/footer and section fragments (html_reporter.rs)
    assert html.startswith(
        '<html><head><meta http-equiv="content-type" content="text/html;charset=utf-8" />'
    )
    assert "<title>GeneFuse 0.1.2, at " in html
    assert "function toggle(targetid)" in html
    assert ".protein_table{text-align:center;font-size:8px;}" in html
    assert "<div id='helper'><p>Helpful tips:</p><ul>" in html
    assert f"Found {len(mapper.fusion_results)} fusion" in html
    assert f"<a href='#fusion_id_1'> 1, {fr.title}</a>" in html
    assert "<div class='tips'>Supporting reads:</div>" in html
    assert "<td class='alignright' colspan='3'>" in html
    # per-read rows: zero-padded index, quality-colored bases, hidden row
    assert "<tr onclick='toggle(100000);'>" in html
    assert "0001" in html
    assert "<font color='" in html
    assert "<tr id='100000' style='display:none;'>" in html
    assert "<td colspan='6'><xmp>" in html
    assert html.endswith("</div></body></html>")
    # protein diagram exon cells
    assert "class='exon_left'" in html and "class='exon_right'" in html


def test_stdout_block_format(capsys):
    panel = make_panel()
    pairs = plant_fusion_pairs(panel, n_support=4, n_background=5)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, csv_path = write_panel_files(panel, tmp)
        scanner = Scanner(csv_path, panel.contigs, "", "", Settings(), command="c")
        mapper = scanner.scan_pairs(pairs)
    out = capsys.readouterr().out
    fr = mapper.fusion_results[0]
    assert f"\n#{fr.title}\n" in out
    # reference: ">{i}, break:{b}, diff:(l r), read direction: ..., name: ..."
    m = fr.matches[0]
    assert (
        f">1, break:{m.read_break + 1}, diff:({m.left_distance} {m.right_distance})"
        ", read direction: original direction, name: " in out
    )
    # split sequence line
    rb = m.read_break + 1
    assert f"{m.read.seq[:rb]} {m.read.seq[rb:]}" in out
