"""Per-row gather and shift helpers for the scan kernels.

`row_take` expresses per-row column indexing as one axis-0 `jnp.take` on
the flattened array, a single flat gather instead of a batched
`take_along_axis`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def row_take(arr2d: jnp.ndarray, col_idx: jnp.ndarray) -> jnp.ndarray:
    """(B, L) array, (B, K) int32 column indices -> (B, K) values
    arr2d[b, clip(col_idx[b, k], 0, L-1)]."""
    B, L = arr2d.shape
    K = col_idx.shape[1]
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, K), 0)
    flat = rows * L + jnp.clip(col_idx, 0, L - 1)
    return jnp.take(arr2d.reshape(-1), flat.reshape(-1), axis=0).reshape(B, K)


def row_shift_right(arr2d: jnp.ndarray, shift: jnp.ndarray, fill) -> jnp.ndarray:
    """Per-row right shift: out[b, j] = arr2d[b, j - shift[b]] for
    j >= shift[b], else `fill`. shift in [0, L].

    Implemented as log2(L) static-slice shifts composed by the shift's
    bits: pure vector selects, no gathers."""
    B, L = arr2d.shape
    x = arr2d
    for bit in range(max(1, L).bit_length()):
        s = 1 << bit
        if s >= L:
            shifted = jnp.full((B, L), fill, arr2d.dtype)
        else:
            shifted = jnp.concatenate(
                [jnp.full((B, s), fill, arr2d.dtype), x[:, : L - s]], axis=1
            )
        cond = ((shift >> bit) & 1) == 1
        x = jnp.where(cond[:, None], shifted, x)
    return x


def row_shift_left(arr2d: jnp.ndarray, shift: jnp.ndarray, fill) -> jnp.ndarray:
    """Per-row left shift: out[b, j] = arr2d[b, j + shift[b]] for
    j + shift[b] < L, else `fill`. shift in [0, L]."""
    B, L = arr2d.shape
    x = arr2d
    for bit in range(max(1, L).bit_length()):
        s = 1 << bit
        if s >= L:
            shifted = jnp.full((B, L), fill, arr2d.dtype)
        else:
            shifted = jnp.concatenate(
                [x[:, s:], jnp.full((B, s), fill, arr2d.dtype)], axis=1
            )
        cond = ((shift >> bit) & 1) == 1
        x = jnp.where(cond[:, None], shifted, x)
    return x
