"""bench.py measures the GPU: on any other device it exits non-zero and
prints no record."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_bench_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    r = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--pairs", "8"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 2, r.stderr
    assert r.stdout.strip() == ""
    assert "measures the GPU" in r.stderr
