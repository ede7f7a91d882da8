"""Per-fusion DYNAMIC HTML sections byte-verified against the reference
source (VERDICT r4 item 6).

test_html_reference_template.py pins the static skeleton (header/css/js/
helper/footer) and wildcards the fusion region; this test closes that gap:
it parses the `write!` literals of `print_fusions` / `print_fusion`
(/root/reference/src/core/html_reporter.rs:231-368), `ReadMatch::
print_html_td` (/root/reference/src/core/read_match.rs:92-113) and
`SequenceRead::print_html_td_with_breaks` (/root/reference/src/core/
read.rs:127-166) out of the reference at test time and requires our
fusion region — menu, per-fusion blocks, per-supporting-read rows and the
hidden original-read rows — to follow the reconstructed templates
byte-for-byte (wildcard gaps only where the reference interpolates
runtime values).
"""

import pathlib

import pytest

from ref_template_util import (
    fn_body,
    match_template,
    split_placeholders,
    write_literals,
)

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

REF = pathlib.Path("/root/reference/src/core/html_reporter.rs")
REF_RM = pathlib.Path("/root/reference/src/core/read_match.rs")
REF_RD = pathlib.Path("/root/reference/src/core/read.rs")

pytestmark = pytest.mark.skipif(
    not REF.exists(), reason="reference checkout unavailable"
)

GAP = "{}"  # explicit wildcard between literals (runtime interpolation)


@pytest.fixture(scope="module")
def html_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dyntmpl")
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
    scanner.scan_pairs(pairs)
    return (tmp / "r.html").read_text()


def _pieces(literals):
    """Concatenate template literals and split into static pieces; every
    {} placeholder (inside a literal or a standalone GAP) is one gap."""
    out, cur = [], ""
    for lit in literals:
        segs = split_placeholders(lit)
        cur += segs[0]
        for s in segs[1:]:
            out.append(cur)
            cur = s
    out.append(cur)
    return out


def _fusion_region(html_out: str) -> str:
    i = html_out.index("<div id='menu'>")
    j = html_out.index("<div id='footer'>")
    return html_out[i:j]


def test_menu_matches_reference_template(html_out):
    src = REF.read_text()
    lits = write_literals(fn_body(src, "print_fusions"))
    # emission order (html_reporter.rs:231-262): menu head, optional "s"
    # (plural), ":</p><ul>", N x menu_item li, "</ul></div>"
    head, plural_s, ulopen, li, ulclose = lits
    region = _fusion_region(html_out)
    n_fusions = region.count("<li class='menu_item'>")
    assert n_fusions >= 1
    menu = _pieces([head] + ([plural_s] if n_fusions > 1 else [])
                   + [ulopen] + [li] * n_fusions + [ulclose])
    end = match_template(region, menu, anchor_start=True, anchor_end=False)
    # the menu is immediately followed by the first fusion block
    assert region[end:].startswith("<div class='fusion_block'>")


def test_fusion_blocks_match_reference_template(html_out):
    src = REF.read_text()
    lits = write_literals(fn_body(src, "print_fusion"))
    assert len(lits) == 30, len(lits)  # html_reporter.rs:277-362
    (blk, head_a, head_id, head_close, tips_protein, conflict, tips_colon,
     tips_reads, table, tr_h1, td_leftpos, td_rightpos, tr_close1, tr_h2,
     td_leftref, td_rightref, tr_close2, tr_onclick, td, a_title, pad0_a,
     pad0_b, pad0_c, rownum, tr_close3, tr_hidden, td_xmp, xmp_close,
     tr_close4, table_close) = lits
    assert conflict.startswith(" (transcription direction conflicts")
    # planted fusion is co-directional: the conflict text must NOT appear
    assert conflict not in html_out
    assert table_close == "</table></div>"

    rm = write_literals(fn_body(REF_RM.read_text(), "print_html_td"))
    # read_match.rs:92-113: arrow (one of two, data-dependent -> GAP),
    # "</a></span>", "</td><td>{}|{}</td>"
    span_close = next(l for l in rm if l == "</a></span>")
    ed_td = next(l for l in rm if "|" in l)
    rd = write_literals(fn_body(REF_RD.read_text(), "print_html_td_with_breaks"))
    # read.rs:127-166 with breaks=[read_break+1]: first td (alignright),
    # then final alignleft td (the middle loop body does not run)
    td_alignright = rd[0]
    td_alignleft = next(l for l in rd if "alignleft" in l)

    # one supporting-read row + its hidden original-reads row, in emission
    # order; GAPs: row id, read name, zero-padded row number + arrow,
    # ed values, colored seq tds, hidden row id, original reads dump
    row_lits = [
        tr_onclick, td, a_title, GAP, span_close, ed_td,
        td_alignright, td_alignleft, tr_close3, tr_hidden, td_xmp,
        GAP, xmp_close, tr_close4,
    ]

    region = _fusion_region(html_out)
    blocks = region.split(blk)[1:]
    assert blocks, "no fusion block emitted"
    for b in blocks:
        n_rows = b.count(split_placeholders(tr_onclick)[0])
        assert n_rows >= 1
        block_lits = (
            [head_a, head_id, head_close, tips_protein, tips_colon,
             GAP,  # print_fusion_protein_html
             tips_reads, table, tr_h1, td_leftpos, td_rightpos, tr_close1,
             tr_h2, td_leftref, td_rightref, tr_close2]
            + row_lits * n_rows
            + [table_close]
        )
        match_template(
            b, _pieces(block_lits), anchor_start=True, anchor_end=False
        )
