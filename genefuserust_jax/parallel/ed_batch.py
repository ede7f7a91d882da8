"""Deferred, batched edit-distance evaluation on device.

The reference computes two edit distances per candidate match inline on the
consumer thread (fusion_mapper.rs:196-251). Fusion-rich samples make that a
host hotspot here (Python-bigint Myers per match). This batcher collects
(query, ref) jobs during a scan batch's assembly, then evaluates them all
in one `ops.edit_distance.edit_distance_batch` call (int32-word Myers,
equality-tested against the host implementation in
tests/test_edit_distance_device.py) and writes results back through per-job
setters. Jobs containing bytes outside ACGTNacgtn are host-routed (the
device Eq table buckets unknown bytes together, which would compare them
equal); empty-side jobs short-circuit without device work.

Shape discipline: rows are padded to power-of-two batches and widths to
64-byte buckets so the number of compiled kernel variants stays small.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from ..core.edit_distance import edit_distance


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class EdBatcher:
    """Collects edit-distance jobs; flush() evaluates them batched.

    Below `min_device_jobs` the host Myers runs instead: a device dispatch
    costs a host-device round trip plus a one-time shape compile, which
    only amortizes on fusion-rich batches (thousands of matches). Typical
    batches carry a few dozen jobs."""

    def __init__(self, min_device_jobs: int = 512):
        self.min_device_jobs = min_device_jobs
        self._jobs: List[Tuple[str, str, Callable[[int], None]]] = []

    def submit(self, query: str, ref: str, setter: Callable[[int], None]) -> None:
        self._jobs.append((query, ref, setter))

    def __len__(self) -> int:
        return len(self._jobs)

    def flush(self) -> None:
        if not self._jobs:
            return
        jobs, self._jobs = self._jobs, []
        if len(jobs) < self.min_device_jobs:
            for q, r, setter in jobs:
                setter(edit_distance(q, r))
            return
        device_jobs = []
        for q, r, setter in jobs:
            if not q or not r:
                setter(edit_distance(q, r))
            elif _has_exotic(q) or _has_exotic(r):
                setter(edit_distance(q, r))
            else:
                device_jobs.append((q, r, setter))
        if not device_jobs:
            return
        import jax.numpy as jnp

        from ..ops.edit_distance import ED_CODE_LUT, edit_distance_batch

        n = len(device_jobs)
        # pattern = shorter side (W scales with pattern length; the
        # distance is symmetric)
        pats = [min(q, r, key=len) for q, r, _ in device_jobs]
        txts = [max(r, q, key=len) for q, r, _ in device_jobs]
        Lp = _round_up(max(len(p) for p in pats), 64)
        Lt = _round_up(max(len(t) for t in txts), 64)
        W = Lp // 32
        B = 8
        while B < n:
            B *= 2
        pat = np.zeros((B, Lp), np.uint8)
        txt = np.zeros((B, Lt), np.uint8)
        pl = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i, (p, t) in enumerate(zip(pats, txts)):
            pb = np.frombuffer(p.encode("latin-1"), np.uint8)
            tb = np.frombuffer(t.encode("latin-1"), np.uint8)
            pat[i, : len(pb)] = ED_CODE_LUT[pb]
            txt[i, : len(tb)] = ED_CODE_LUT[tb]
            pl[i] = len(pb)
            tl[i] = len(tb)
        out = np.asarray(
            edit_distance_batch(
                jnp.asarray(pat), jnp.asarray(pl), jnp.asarray(txt),
                jnp.asarray(tl), W,
            )
        )
        for i, (_, _, setter) in enumerate(device_jobs):
            setter(int(out[i]))


def _has_exotic(s: str) -> bool:
    return any(ch not in "ACGTNacgtn" for ch in s)
