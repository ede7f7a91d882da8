"""chip_smoke.py without a GPU: its phases rehearse on CPU at a tiny size,
and its entry point refuses to report a result."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_REHEARSAL = """
import sys
sys.argv = ["rehearsal"]
import chip_smoke as cs
out = {out!r}
w = cs.prepare(out + "/data", panel_mbp=1.0, n_full=2048, n_sub=4096,
               sub_junction=0.3, n_planted=2)
cs.phase_device()
cs.phase_full(w, out)
cs.phase_parity(w, out)
cs.phase_multi_csv(w, out)
cs.phase_edit_distance(n=64)
"""


def _cpu_env(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    # one CPU device, as on a one-GPU machine
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    return env


def test_phases_rehearse_on_cpu(tmp_path):
    # a fresh interpreter, so that the compile cache goes to tmp_path;
    # 30% junction pairs in 4096 pass more than the 1024-survivor cap
    env = _cpu_env(tmp_path)
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _REHEARSAL.format(out=str(tmp_path))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = r.stdout
    assert "b. all 2 planted fusions reported" in out
    assert "survivor-cap overflow ran 1x" in out
    for tag in ("device_pe", "sharded_pe_mesh1", "device_se"):
        assert f"c. {tag}: JSON and HTML byte-identical" in out
    assert out.count("JSON and HTML byte-identical") == 3 + 4
    assert "e. edit distance: 64 pairs" in out


def test_main_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_fails_without_the_program(tmp_path):
    # a directory with chip_smoke.py and nothing else of the repository
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _cpu_env(tmp_path)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
