"""Product sharded-index engine == host oracle, byte-identical reports."""

import re

import jax
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import HostEngine, Scanner
from genefuserust_jax.parallel.mesh import make_mesh
from genefuserust_jax.parallel.sharded_engine import ShardedIndexEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def _scan(panel, csv_path, pairs, tmp_path, tag, engine):
    html = tmp_path / f"{tag}.html"
    json = tmp_path / f"{tag}.json"
    Scanner(
        csv_path,
        panel.contigs,
        str(html),
        str(json),
        Settings(),
        engine=engine,
        command="sharded-test",
    ).scan_pairs(pairs)
    return _TS.sub("<ts>", html.read_text()), _TS.sub("<ts>", json.read_text())


def test_sharded_engine_equals_oracle(tmp_path):
    devices = jax.devices()
    assert len(devices) >= 4
    mesh = make_mesh(devices[:4], axis="shard")

    panel = make_panel(seed=17)
    pairs = plant_fusion_pairs(panel, n_support=7, n_background=60, seed=3)
    _, csv_path = write_panel_files(panel, str(tmp_path))

    h_sh, j_sh = _scan(
        panel, csv_path, pairs, tmp_path, "sh",
        ShardedIndexEngine(Settings(), mesh=mesh, batch_size=32),
    )
    h_host, j_host = _scan(panel, csv_path, pairs, tmp_path, "host", HostEngine())
    assert '"unique"' in j_sh
    assert j_sh == j_host
    assert h_sh == h_host
