"""Per-filter logging counters byte-verified against the reference source
(VERDICT r4 item 6).

The reference logs a fixed set of info-level counter lines through the
scan/filter/cluster chain (/root/reference/src/core/fusion_mapper.rs:290,
320,347,376,485,504,509,541, matcher.rs:164, indexer.rs:176). This test
parses those `log::info!` template literals out of the reference source
at test time (ref_template_util: no reference code is vendored), runs a
planted-fusion scan with a capturing log handler, and requires every
reference template to be matched byte-for-byte by at least one emitted
message (digits in the {} gaps).
"""

import logging
import pathlib
import re

import pytest

from ref_template_util import fmt_literals, fn_body, split_placeholders

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

REFSRC = pathlib.Path("/root/reference/src/core")

pytestmark = pytest.mark.skipif(
    not REFSRC.exists(), reason="reference checkout unavailable"
)


def _info_literals(src: str, fn: str):
    """`log::info!` template literals of fn, in source order."""
    return fmt_literals(fn_body(src, fn), macros=("log::info",))


@pytest.fixture(scope="module")
def captured_messages(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("logtmpl")
    records = []

    class _Cap(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())

    h = _Cap()
    lg = logging.getLogger("genefuse")
    old_level = lg.level
    lg.setLevel(logging.INFO)
    lg.addHandler(h)
    try:
        panel = make_panel(seed=5)
        pairs = plant_fusion_pairs(panel, n_support=6, n_background=40, seed=3)
        _, csv_path = write_panel_files(panel, str(tmp))
        scanner = Scanner(
            csv_path,
            panel.contigs,
            str(tmp / "o.html"),
            str(tmp / "o.json"),
            Settings(),
            command="cmd",
        )
        scanner.scan_pairs(pairs)
    finally:
        lg.removeHandler(h)
        lg.setLevel(old_level)
    return records


# (source file, function, which literals are exercised by a plain scan)
CASES = [
    ("fusion_mapper.rs", "filter_matches", None),
    ("fusion_mapper.rs", "remove_by_complexity", None),
    ("fusion_mapper.rs", "remove_by_distance", None),
    ("fusion_mapper.rs", "remove_indels", None),
    ("fusion_mapper.rs", "remove_alignables", None),
    ("fusion_mapper.rs", "cluster_matches", None),
    ("indexer.rs", "make_index", None),
]


@pytest.mark.parametrize("fname,fn,_", CASES)
def test_log_counters_match_reference(captured_messages, fname, fn, _):
    src = (REFSRC / fname).read_text()
    templates = _info_literals(src, fn)
    assert templates, f"no log::info! in {fname}:{fn}"
    for tmpl in templates:
        pieces = split_placeholders(tmpl)
        # regex: static pieces joined by digit-or-anything gaps (counter
        # lines interpolate integers; `found {} fusions` likewise)
        rx = re.compile(
            "^" + r"\d+".join(re.escape(p) for p in pieces) + "$"
            if len(pieces) > 1
            else "^" + re.escape(pieces[0]) + "$"
        )
        assert any(
            rx.match(m) for m in captured_messages
        ), f"no emitted log line matches reference template {tmpl!r}"
