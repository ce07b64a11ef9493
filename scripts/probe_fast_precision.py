#!/usr/bin/env python3
"""How the fast transform's matmul precision moves its coefficients.

Fast mode computes quantized zig-zag coefficients with one float32 matmul
(``transform.encode_blocks(..., FAST)``), pinned to
``Precision.HIGHEST``.  This probe runs the same matmul at each of
``DEFAULT``, ``HIGH`` and ``HIGHEST`` on the seeded corpus and reports,
for each:

- how many quantized coefficients differ from the float64 oracle's, and
  how many of those are rounding ties (the oracle's unrounded value lies
  within 1e-6 of a half-integer, which any float32 path may round
  either way);
- the largest error of the unrounded product against float64 (TF32
  keeps 10 mantissa bits, so it would show errors near 2**-11 of a
  coefficient's magnitude; float32 near 2**-24);
- the operation XLA compiled the dot into, with its backend config.

For comparison it counts, on the host, the disagreements of the same
matmul with its matrix rounded to TF32 and float64 arithmetic.  It also
checks that the HIGHEST case reproduces the library's fast encode
exactly.  Runs on one NVIDIA GPU only (JAX pinned to CUDA).
Writes ``chiprun_out/probe_fast_precision.json``.

    python scripts/probe_fast_precision.py [--batch 49] [--size 512] [--quality 50]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=49)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--quality", type=int, default=50)
    args = p.parse_args()

    from chip_smoke import SmokeFailure, card_info, init_gpu

    try:
        devices = init_gpu(multi=False)
    except SmokeFailure as e:
        print(f"probe_fast_precision: {e}", file=sys.stderr)
        return 1
    import jax
    import jax.numpy as jnp

    from tinyimgcodec_tpu import corpus, golden
    from tinyimgcodec_tpu.constants import ZIGZAG_ORDER, quant_divisors
    from tinyimgcodec_tpu.ops import transform

    dev = devices[0]
    where = f"{dev.platform} {dev.device_kind} x{len(devices)}; {card_info()}"
    q = args.quality
    images = corpus.synthetic_corpus(args.batch, args.size)
    blocks = np.asarray(transform.blockify(images)).reshape(-1, 64)
    m, offset = transform._fast_encode_matrix(q)
    y64 = blocks.astype(np.float64) @ m.astype(np.float64)
    ref = np.concatenate([
        np.concatenate([np.cumsum(a.dc, dtype=np.int64)[:, None], a.ac], 1)
        for a in (golden.encode_arrays(im, q) for im in images)
    ])
    # the oracle's unrounded coefficients, and their distance to a
    # rounding boundary
    exact = golden.block_dct(blocks.reshape(-1, 8, 8) - 128.0)
    exact = (exact / quant_divisors(q)).reshape(-1, 64)[:, ZIGZAG_ORDER]
    to_half = np.abs(np.abs(exact) % 1.0 - 0.5)
    m_tf32 = (m.view(np.uint32) + 0x1000 & 0xFFFFE000).view(np.float32)
    tf32 = np.round(blocks @ m_tf32.astype(np.float64) - offset)
    library = np.asarray(jax.jit(lambda x: transform.encode_blocks(
        transform.blockify(x), q, transform.FAST))(images)).reshape(-1, 64)

    record = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(devices)},
              "where": where, "coefficients": int(ref.size),
              "ties": int(np.count_nonzero(to_half < 1e-6)),
              "tf32_emulated_differ": int(np.count_nonzero(tf32 != ref)),
              "cases": {}}
    print(f"oracle: {record['ties']} of {ref.size} coefficients are "
          f"rounding ties; TF32-rounded matrix in float64 (host): "
          f"{record['tf32_emulated_differ']} differ", flush=True)
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)

        def fast(x, prec=prec):
            y = jnp.matmul(x.astype(jnp.float32), jnp.asarray(m),
                           precision=prec)
            return y, jnp.round(y - jnp.asarray(offset)).astype(jnp.int32)

        fn = jax.jit(fast)
        y, zz = (np.asarray(a) for a in fn(blocks))
        hlo = fn.lower(blocks).compile().as_text()
        dots = [ln.strip()[:400] for ln in hlo.splitlines()
                if re.search(r"custom-call|\bdot\(|__triton", ln)]
        err = np.abs(y.astype(np.float64) - y64)
        rel = err / np.maximum(np.abs(y64), 1.0)
        differ = zz != ref
        case = {
            "differ_from_oracle": int(np.count_nonzero(differ)),
            "differ_at_ties": int(np.count_nonzero(to_half[differ] < 1e-6)),
            "max_boundary_distance_of_differing": float(
                to_half[differ].max()) if differ.any() else 0.0,
            "max_abs_error": float(err.max()),
            "max_rel_error": float(rel.max()),
            "compiled_dot": dots,
        }
        if name == "HIGHEST":
            case["equals_library_fast"] = bool(np.array_equal(zz, library))
        record["cases"][name] = case
        print(f"{name}: {case['differ_from_oracle']} of {ref.size} "
              f"coefficients differ from the oracle ({case['differ_at_ties']}"
              f" at rounding ties, the others within "
              f"{case['max_boundary_distance_of_differing']:.2e} of a "
              f"boundary); max |error| "
              f"{case['max_abs_error']:.3e} (relative "
              f"{case['max_rel_error']:.3e}) [{where}]", flush=True)
        for d in dots:
            print(f"  {d}", flush=True)
    if not record["cases"]["HIGHEST"]["equals_library_fast"]:
        print("HIGHEST does not reproduce the library's fast encode",
              file=sys.stderr)
        return 1
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "probe_fast_precision.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
