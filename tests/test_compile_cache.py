"""utils/compile_cache.enable_compile_cache: where compiled programs go.

Each case runs in a fresh interpreter, since the cache directory is
process-wide JAX configuration.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import jax, jax.numpy as jnp
from genefuserust_jax.utils.compile_cache import enable_compile_cache
d = enable_compile_cache()
jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_extra, cwd):
    env = {
        k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"
    }
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=str(REPO),
        # cache even the probe's sub-second compile
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
    )
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_env_var_is_honoured(tmp_path):
    cache = tmp_path / "jaxcache"
    returned, configured = _probe(
        {"JAX_COMPILATION_CACHE_DIR": str(cache)}, cwd=tmp_path
    )
    assert returned == configured == str(cache)
    assert any(cache.iterdir()), "no compiled program was written to the cache"


def test_default_is_fixed_inside_checkout(tmp_path):
    other = tmp_path / "elsewhere"
    other.mkdir()
    # write nothing into the checkout's cache from a test
    no_write = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "1000"}
    a = _probe(no_write, tmp_path)
    b = _probe(no_write, other)
    want = str(REPO / ".jax_cache")
    assert a == b == [want, want]
