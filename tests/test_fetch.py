"""_Fetch (parallel/engine.py): the background device->host fetch."""

import numpy as np
import pytest

from genefuserust_jax.parallel.engine import _Fetch


class _FakeArr:
    """The jax.Array surface _Fetch touches; ready after `polls` polls."""

    def __init__(self, value, polls=0, fail=None):
        self._value = value
        self._polls = polls
        self._fail = fail

    def copy_to_host_async(self):
        pass

    def is_ready(self):
        self._polls -= 1
        return self._polls < 0

    def __array__(self, dtype=None, copy=None):
        if self._fail is not None:
            raise self._fail
        return self._value


def test_fetch_returns_the_array():
    import jax.numpy as jnp

    x = jnp.arange(12, dtype=jnp.int32).reshape(3, 4)
    f = _Fetch(x)
    out = f.get()
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(12).reshape(3, 4))
    assert f.inflight_s >= 0
    # a result that is not ready at once is waited for, not skipped
    v = np.arange(5)
    np.testing.assert_array_equal(_Fetch(_FakeArr(v, polls=3)).get(), v)


def test_fetch_thread_exception_surfaces_from_get():
    f = _Fetch(_FakeArr(None, fail=RuntimeError("transfer failed")))
    with pytest.raises(RuntimeError, match="transfer failed"):
        f.get()


def test_fetch_of_none_is_none():
    f = _Fetch(None)
    assert f.get() is None
    assert f.inflight_s == 0.0
