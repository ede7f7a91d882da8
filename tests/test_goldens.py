"""Golden snapshot regression: frozen JSON/HTML artifacts.

Kernel/engine changes must diff against a FIXED artifact, not a
co-evolving oracle. The goldens under tests/goldens/ were produced by the
verified round-2 pipeline (host-oracle-equal, see test_engine_equality)
on fully seeded inputs; regenerate deliberately with:

    python -m tests.test_goldens   # rewrites tests/goldens/

Timestamps are normalized; everything else must match byte-for-byte.
"""

import os
import re

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import Scanner
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def _strip_ts(text: str) -> str:
    return _TS.sub("<ts>", text)


def _produce(tmp_dir: str):
    """Deterministic planted-fusion scan -> (html_text, json_text)."""
    panel = make_panel(seed=33)
    pairs = plant_fusion_pairs(panel, n_support=7, n_background=80, seed=9)
    _, csv_path = write_panel_files(panel, tmp_dir)
    html = os.path.join(tmp_dir, "golden.html")
    json = os.path.join(tmp_dir, "golden.json")
    scanner = Scanner(
        csv_path,
        panel.contigs,
        html,
        json,
        Settings(),
        engine=DeviceEngine(Settings(), batch_size=64),
        command="golden-run",
    )
    scanner.scan_pairs(pairs)
    return _strip_ts(open(html).read()), _strip_ts(open(json).read())


def test_golden_snapshot(tmp_path):
    h, j = _produce(str(tmp_path))
    gh = open(os.path.join(GOLDEN_DIR, "planted.html")).read()
    gj = open(os.path.join(GOLDEN_DIR, "planted.json")).read()
    assert j == gj, "JSON report drifted from the frozen golden"
    assert h == gh, "HTML report drifted from the frozen golden"


if __name__ == "__main__":
    import tempfile

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        h, j = _produce(td)
    open(os.path.join(GOLDEN_DIR, "planted.html"), "w").write(h)
    open(os.path.join(GOLDEN_DIR, "planted.json"), "w").write(j)
    print(f"goldens written to {GOLDEN_DIR}")
