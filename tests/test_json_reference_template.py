"""JSON report + stdout fusion blocks byte-verified against templates
parsed from the REFERENCE SOURCE at test time.

Same technique as test_html_reference_template.py (round-3 VERDICT item
6): the write!/writeln!/print! string literals of
/root/reference/src/core/json_reporter.rs:34-112,
/root/reference/src/core/read_match.rs:121-167 and
/root/reference/src/core/fusion_result.rs:761-767 are extracted in
emission order, the loops/conditionals of the emitters are replayed for
our concrete scenario (fusion count, per-fusion read counts, reversed
flags), and our emitted bytes must match the reconstructed template
exactly — with gaps only where the reference interpolates runtime
values ({} placeholders). No reference code is vendored.
"""

import io
import pathlib
from contextlib import redirect_stdout

import pytest

from ref_template_util import (
    fmt_literals,
    fn_body,
    match_template,
    split_placeholders,
)

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

REF_JSON = pathlib.Path("/root/reference/src/core/json_reporter.rs")
REF_MATCH = pathlib.Path("/root/reference/src/core/read_match.rs")
REF_RESULT = pathlib.Path("/root/reference/src/core/fusion_result.rs")

pytestmark = pytest.mark.skipif(
    not REF_JSON.exists(), reason="reference checkout unavailable"
)


@pytest.fixture(scope="module")
def scan_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jsontmpl")
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
    stdout = io.StringIO()
    with redirect_stdout(stdout):
        for fr in mapper.fusion_results:
            fr.print_stdout()
    return (tmp / "r.json").read_text(), mapper, stdout.getvalue()


def test_json_file_matches_reference_template(scan_out):
    json_text, mapper, _ = scan_out
    results = mapper.fusion_results
    assert results, "scenario must detect at least one fusion"
    assert any(len(f.matches) >= 2 for f in results), (
        "need >=2 reads to exercise the comma separator"
    )

    lits = fmt_literals(fn_body(REF_JSON.read_text(), "run"),
                        ("write", "writeln"))
    assert len(lits) == 41, len(lits)  # emission map below
    # 0..4 preamble; 5 first-fusion sep; 6 later-fusion sep; 7 title;
    # 8..18 left block; 19..29 right block; 30 unique; 31 reads-open;
    # 32..34 read open/break/strand; 35 read close; 36 comma; 37 newline;
    # 38 reads-close; 39 fusion-close; 40 file close.
    assert lits[7] == '\t\t"{}":{{\n' and lits[36] == ","

    # print_read_to_json (read_match.rs:121-130), pad = 5 tabs per the
    # call site json_reporter.rs ("\t\t\t\t\t")
    rj = fmt_literals(fn_body(REF_MATCH.read_text(), "print_read_to_json"),
                      ("write", "writeln"))
    assert len(rj) == 2 and rj[0].startswith('{}"seq"')
    rj = [l.replace("{}", "\t" * 5, 1) for l in rj]

    # replay run()'s loops for our scenario (deletion/untranslated gates
    # pass for the synthetic cross-contig forward-forward fusion)
    t = "".join(lits[0:5])
    for fi, fr in enumerate(results):
        t += lits[5] if fi == 0 else lits[6]
        t += "".join(lits[7:32])
        n = len(fr.matches)
        for r in range(n):
            t += lits[32] + lits[33] + lits[34] + rj[0] + rj[1] + lits[35]
            if r != n - 1:
                t += lits[36]
            t += lits[37]
        t += lits[38] + lits[39]
    t += lits[40]

    match_template(json_text, split_placeholders(t))


def test_stdout_fusion_blocks_match_reference_template(scan_out):
    _, mapper, stdout_text = scan_out
    results = mapper.fusion_results
    assert results

    # FusionResult::print (fusion_result.rs:761-767)
    fr_lits = fmt_literals(fn_body(REF_RESULT.read_text(), "print"),
                           ("print", "println"))
    assert fr_lits == ["\n#{}\n", ">{}, "]
    # ReadMatch::print (read_match.rs:133-167): break, diff, one of the
    # two direction literals, name, newline, left-seq, space, right-seq,
    # newline
    rm_lits = fmt_literals(fn_body(REF_MATCH.read_text(), "print"),
                           ("print", "println"))
    assert len(rm_lits) == 10, rm_lits
    assert rm_lits[2] == ", read direction: reversed complement"
    assert rm_lits[3] == ", read direction: original direction"

    t = ""
    for fr in results:
        t += fr_lits[0]
        for m in fr.matches:
            t += fr_lits[1]
            t += rm_lits[0] + rm_lits[1]
            t += rm_lits[2] if m.reversed else rm_lits[3]
            t += rm_lits[4] + rm_lits[5] + rm_lits[6] + rm_lits[7]
            t += rm_lits[8] + rm_lits[9]

    match_template(stdout_text, split_placeholders(t))
