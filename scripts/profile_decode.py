#!/usr/bin/env python3
"""Isolation profile of the device entropy-decode pass.

Splits the pass into chain-only / chain+unpack+reassembly / full
(+transform) timings at a fixed slot budget.  Each timing runs the step
k times inside one jitted ``fori_loop`` whose iterations depend on each
other (so XLA cannot hoist the step out of the loop) and divides by k.
For the end-to-end decode rate (resume passes included) use
``chip_smoke.py``.

Usage: python scripts/profile_decode.py [k] [budget_mult] [stride]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from tinyimgcodec_tpu import container, corpus
    from tinyimgcodec_tpu.ops import transform
    from tinyimgcodec_tpu.ops import entropy_decode as ed
    from tinyimgcodec_tpu.xla_cache import ensure_cache

    ensure_cache()
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    mult = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    stride = int(sys.argv[3]) if len(sys.argv) > 3 else 64

    images = corpus.load_corpus()
    t0 = time.time()
    streams = [
        container.compress(im, 50, block_index=True, index_stride=stride)
        for im in images
    ]
    print(f"corpus compressed (host) in {time.time()-t0:.0f}s", flush=True)
    prep = ed.prepare_batch(streams)
    b = len(streams)
    h, w, quality = prep["shape"]
    nb = prep["nb_per_image"]
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    mp = b * h * w / 1e6
    consts = [
        jax.device_put(jnp.asarray(prep[key]))
        for key in ("chunk_start", "chunk_blocks", "chunk_block_base",
                    "chunk_end_lo", "chunk_end_hi")
    ]
    budget = stride * mult + 2

    def kloop(step):
        @jax.jit
        def f(words):
            def body(i, acc):
                eps = jnp.where(
                    acc == jnp.uint32(0xFFFFFFFF), jnp.uint32(1),
                    jnp.uint32(0),
                )
                return acc + step(words ^ eps)
            return jax.lax.fori_loop(0, k, body, jnp.uint32(0))
        return f

    def run(name, step):
        f = kloop(step)
        dev_words = jax.device_put(jnp.asarray(prep["words"]))
        jax.device_get(f(dev_words))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(f(dev_words))
            ts.append(time.perf_counter() - t0)
        dt = sorted(ts)[1] / k
        print(f"{name:28s} {dt*1e3:8.2f} ms  {mp/dt:9.1f} MP/s",
              flush=True)
        return dt

    def s_full(words):
        zz, ok, _ = ed.entropy_decode_chunks(
            words, *consts, nb_total=b * nb, stride=stride,
            max_symbols=budget, layout=(b, nb),
        )
        zzb = zz.reshape(b, nb, 64)
        zz_abs = transform.undo_dpcm(zzb[..., 0], zzb[..., 1:])
        blocks = transform.decode_blocks(zz_abs, quality, "fast")
        imgs = transform.unblockify(blocks, h8, w8)
        return (imgs[0, 0, 0].astype(jnp.uint32) + imgs[-1, -1, -1]
                + ok[0].astype(jnp.uint32))

    def s_entropy(words):
        zz, ok, _ = ed.entropy_decode_chunks(
            words, *consts, nb_total=b * nb, stride=stride,
            max_symbols=budget, layout=(b, nb),
        )
        return (zz[0, 0].astype(jnp.uint32)
                + zz[-1, -1].astype(jnp.uint32)
                + ok[0].astype(jnp.uint32))

    def s_chain(words):
        # chain phase only: consuming ONLY `exhausted` (= left_f of the
        # while_loop) lets XLA dead-code-eliminate the record unpack,
        # reassembly and validation phases
        _, _, exhausted = ed.entropy_decode_chunks(
            words, *consts, nb_total=b * nb, stride=stride,
            max_symbols=budget, layout=(b, nb),
        )
        return jnp.sum(exhausted.astype(jnp.uint32))

    run("full (entropy+transform)", s_full)
    run("entropy only", s_entropy)
    run("chain only (DCE rest)", s_chain)


if __name__ == "__main__":
    main()
