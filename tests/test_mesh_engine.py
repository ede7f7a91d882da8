"""Production multi-chip path: the SAME DeviceEngine, sharded over a mesh.

Runs the full product scan (Scanner -> DeviceEngine -> reports) on the
8-device virtual CPU mesh and asserts byte-identical JSON/HTML against the
single-device engine and the host-oracle engine. This is the equality the
dryrun checks at the driver level (__graft_entry__.dryrun_multichip)."""

import re

import jax
import pytest

from genefuserust_jax.config import Settings
from genefuserust_jax.core.scanner import HostEngine, Scanner
from genefuserust_jax.parallel.engine import DeviceEngine
from genefuserust_jax.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_panel_files,
)

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def _scan(panel, csv_path, pairs, tmp_path, tag, engine):
    html = tmp_path / f"{tag}.html"
    json = tmp_path / f"{tag}.json"
    scanner = Scanner(
        csv_path,
        panel.contigs,
        str(html),
        str(json),
        Settings(),
        engine=engine,
        command="mesh-test",
    )
    scanner.scan_pairs(pairs)
    return (
        _TS.sub("<ts>", html.read_text()),
        _TS.sub("<ts>", json.read_text()),
    )


def test_mesh_engine_equals_single_and_oracle(tmp_path):
    devices = jax.devices()
    assert len(devices) >= 8, "conftest must provide the 8-device CPU mesh"
    from genefuserust_jax.parallel.mesh import make_mesh

    mesh = make_mesh(devices[:8])

    panel = make_panel(seed=42)
    pairs = plant_fusion_pairs(panel, n_support=8, n_background=90, seed=13)
    _, csv_path = write_panel_files(panel, str(tmp_path))

    h_mesh, j_mesh = _scan(
        panel, csv_path, pairs, tmp_path, "mesh",
        DeviceEngine(Settings(), batch_size=64, mesh=mesh),
    )
    h_one, j_one = _scan(
        panel, csv_path, pairs, tmp_path, "one",
        DeviceEngine(Settings(), batch_size=64),
    )
    h_host, j_host = _scan(
        panel, csv_path, pairs, tmp_path, "host", HostEngine()
    )
    assert '"unique"' in j_mesh  # a fusion was actually found
    assert j_mesh == j_one == j_host
    assert h_mesh == h_one == h_host
