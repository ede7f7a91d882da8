"""Full-file HTML template check derived FROM THE REFERENCE SOURCE.

VERDICT r2 item 8: the prior suite checked hand-picked fragments; this test
instead parses the reference reporter's template string literals out of
/root/reference/src/core/html_reporter.rs (write! macro calls, in emission
order) at test time, unescapes them, and requires our generated HTML to
match the reconstructed full-file template byte-for-byte — with wildcards
only where the reference interpolates runtime values ({} placeholders,
the fusion blocks, scan targets).

No reference code is vendored: the reference file is the oracle, read at
test time (the same way other tests read /root/reference/testdata).
"""

import pathlib
import re

import pytest

from ref_template_util import fn_body as _fn_body
from ref_template_util import write_literals as _write_literals

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

REF = pathlib.Path("/root/reference/src/core/html_reporter.rs")

pytestmark = pytest.mark.skipif(
    not REF.exists(), reason="reference checkout unavailable"
)

WILDCARD = object()  # spans the reference fills at runtime


@pytest.fixture(scope="module")
def html_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reftmpl")
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


def test_full_file_matches_reference_template(html_out):
    src = REF.read_text()
    header = _write_literals(_fn_body(src, "print_header"))
    css = _write_literals(_fn_body(src, "print_css"))
    js = _write_literals(_fn_body(src, "print_js"))
    helper = _write_literals(_fn_body(src, "print_helper"))
    footer = _write_literals(_fn_body(src, "print_footer"))
    assert len(header) == 5 and len(footer) == 4  # emission order below

    # run() order: print_header (which nests print_js then print_css between
    # its 2nd and 3rd literals, html_reporter.rs:52-82) -> print_helper ->
    # print_fusions (dynamic) -> print_footer (nests print_scan_targets).
    ordered = (
        header[:2]
        + js
        + css
        + header[2:]
        + helper
        + [WILDCARD]  # print_fusions
        + footer[:2]
        + [WILDCARD]  # print_scan_targets
        + footer[2:]
    )

    # flatten to alternating [static, gap, static, ...]: a {} placeholder is
    # a gap inside one literal; WILDCARD is a gap between literals
    pieces = []  # static strings; gaps between consecutive pieces
    cur = ""
    for item in ordered:
        if item is WILDCARD:
            pieces.append(cur)
            cur = ""
            continue
        # split on {} placeholders ({{/}} are literal braces)
        segs = re.split(r"(?<!\{)\{\}(?!\})", item)
        segs = [s.replace("{{", "{").replace("}}", "}") for s in segs]
        cur += segs[0]
        for s in segs[1:]:
            pieces.append(cur)
            cur = s
    pieces.append(cur)
    # 6 {} placeholders (title x2, software ver, command, footer ver+time)
    # + 2 wildcards (fusions, scan targets) = 8 gaps -> 9 static pieces
    assert len(pieces) == 9, len(pieces)

    # byte-exact skeleton: in-order scan; first piece anchors at 0, last
    # piece must end the file
    pos = 0
    for idx, piece in enumerate(pieces):
        found = html_out.find(piece, pos)
        assert found >= 0, f"template piece {idx} missing: {piece[:80]!r}"
        if idx == 0:
            assert found == 0, "header must start the file"
        pos = found + len(piece)
    assert html_out.endswith(pieces[-1])

    # template coverage: the static skeleton accounts for the whole file
    # minus interpolations (title time, software version, fusion blocks,
    # command, scan targets, footer time)
    static_bytes = sum(len(p) for p in pieces)
    assert static_bytes > 3000, "template suspiciously small"
