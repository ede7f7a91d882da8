"""Determinism as a checked invariant, not a claim.

The reference's determinism fix is the read-name tiebreak in the ReadMatch
sort (read_match.rs:227, README.md:22): the report must not depend on the
order work happened to be done in. Here the same input is scanned at
several engine batch sizes AND in shuffled read order; every run must
produce byte-identical JSON/HTML reports (modulo the timestamp line).
"""

import re

import numpy as np
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def _strip_ts(text: str) -> str:
    return _TS.sub("<ts>", text)


def _scan(panel, csv_path, pairs, tmp_path, tag, batch_size, depth=6):
    html = tmp_path / f"{tag}.html"
    json = tmp_path / f"{tag}.json"
    scanner = Scanner(
        csv_path,
        panel.contigs,
        str(html),
        str(json),
        Settings(),
        engine=DeviceEngine(Settings(), batch_size=batch_size, pipeline_depth=depth),
        command="determinism-test",
    )
    scanner.scan_pairs(pairs)
    return _strip_ts(html.read_text()), _strip_ts(json.read_text())


@pytest.fixture(scope="module")
def workload():
    panel = make_panel(seed=21)
    pairs = plant_fusion_pairs(panel, n_support=9, n_background=120, seed=5)
    return panel, pairs


def test_batch_size_invariance(workload, tmp_path):
    panel, pairs = workload
    _, csv_path = write_panel_files(panel, str(tmp_path))
    ref_html, ref_json = _scan(panel, csv_path, pairs, tmp_path, "b4096", 4096)
    assert '"reads":[' in ref_json or '"fusions":' in ref_json
    for bs in (17, 64):
        h, j = _scan(panel, csv_path, pairs, tmp_path, f"b{bs}", bs)
        assert j == ref_json, f"JSON differs at batch_size={bs}"
        assert h == ref_html, f"HTML differs at batch_size={bs}"


def test_read_order_invariance(workload, tmp_path):
    panel, pairs = workload
    _, csv_path = write_panel_files(panel, str(tmp_path))
    _, ref_json = _scan(panel, csv_path, pairs, tmp_path, "orig", 64)
    rng = np.random.default_rng(7)
    for trial in range(2):
        shuffled = list(pairs)
        rng.shuffle(shuffled)
        _, j = _scan(panel, csv_path, shuffled, tmp_path, f"shuf{trial}", 64)
        assert j == ref_json, f"JSON differs after shuffle #{trial}"


def test_pipeline_depth_invariance(workload, tmp_path):
    """The readiness-gated scheduler's in-flight bound must not affect
    results: depth 1 (near-synchronous) == depth 6 (deep pipeline)."""
    panel, pairs = workload
    _, csv_path = write_panel_files(panel, str(tmp_path))
    _, ref_json = _scan(panel, csv_path, pairs, tmp_path, "d6", 64, depth=6)
    for d in (1, 2):
        _, j = _scan(panel, csv_path, pairs, tmp_path, f"d{d}", 64, depth=d)
        assert j == ref_json, f"JSON differs at pipeline_depth={d}"
