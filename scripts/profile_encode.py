#!/usr/bin/env python3
"""Per-layer device time of the batch encode path, from one profiler trace.

Encodes the seeded corpus (49 x 512^2 by default) through
``api.compress_batch`` in both precisions, traces one warm call of each
with ``jax.profiler``, and attributes device time to the layers of
``parallel.batch._batch_body`` by their ``jax.named_scope``:

    transform      blockify + DCT + quantize + zig-zag + DPCM
    block_symbols  Huffman symbolization
    pack_blocks    per-block bit packing
    host_stitch    host span: float64 fix-up of flagged blocks + C stitch
    transfer       host<->device copies

It also reports the call's wall time, the device busy share over that
window, and the card (nvidia-smi name and power limit).  Kernel events
are mapped to scopes through the ``op_name`` metadata of the compiled
HLO.

For ``block_symbols`` and ``pack_blocks`` it gives a memory roofline
share: the bytes each layer must read and write (its operands and
results, from their shapes) over its device time, against the card's
published HBM bandwidth and against a large copy timed in the same
process.  Both layers are elementwise integer work, so bytes bound them.

Runs on one NVIDIA GPU only: JAX is pinned to CUDA and one visible card
before it starts, and no GPU is an error.  Writes
``chiprun_out/profile_encode.json``.

    python scripts/profile_encode.py [--batch 49] [--size 512] [--quality 50]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCOPES = ("transform", "block_symbols", "pack_blocks", "stitch")

# published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet, at
# the full 700 W power limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def scope_of(op_name: str) -> str | None:
    parts = op_name.split("/")
    for s in SCOPES:
        if s in parts:
            return s
    return None


def hlo_scope_map(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> layer scope, from op_name metadata; a
    fusion without its own metadata takes the majority scope of the
    computation it calls."""
    own: dict[str, str | None] = {}
    calls: dict[str, str] = {}
    comp_scopes: dict[str, list[str]] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            comp_scopes.setdefault(comp, [])
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OPNAME.search(line)
        sc = scope_of(op.group(1)) if op else None
        own[name] = sc
        if sc and comp is not None:
            comp_scopes[comp].append(sc)
        c = _CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    out = {}
    for name, sc in own.items():
        if sc is None and name in calls:
            found = comp_scopes.get(calls[name]) or []
            if found:
                sc = max(set(found), key=found.count)
        if sc is not None:
            out[name] = sc
    return out


def reduce_trace(path: str, hlo_map: dict[str, str]) -> dict:
    """Device time per scope, device busy time (interval union), host
    stitch time, from one .xplane.pb."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    norm_map = {_norm(k): v for k, v in hlo_map.items()}
    per_scope: dict[str, float] = {}
    intervals = []
    host_stitch = 0.0
    samples = []
    for plane in pd.planes:
        is_device = "/device:" in plane.name
        for line in plane.lines:
            for ev in line.events:
                if not is_device:
                    if ev.name == "host_stitch":
                        host_stitch += ev.duration_ns
                    continue
                stats = {k: str(v) for k, v in ev.stats}
                # kernels replayed from a CUDA graph carry hlo_op
                # "command_buffer"; their event name is the fusion's
                # name with "." and "-" written "_"
                sc = hlo_map.get(stats.get("hlo_op", "")) or norm_map.get(
                    _norm(ev.name))
                if sc is None:
                    sc = scope_of(stats.get("name", ""))
                if sc is None and ev.name in ("MemcpyD2H", "MemcpyH2D"):
                    sc = "transfer"
                sc = sc or "other"
                per_scope[sc] = per_scope.get(sc, 0.0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if len(samples) < 40:
                    samples.append([plane.name, line.name, ev.name,
                                    ev.duration_ns, stats])
    intervals.sort()
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {
        "device_ms_by_scope": {k: v / 1e6 for k, v in per_scope.items()},
        "device_busy_ms": busy / 1e6,
        "host_stitch_ms": host_stitch / 1e6,
        "samples": samples,
    }


def layer_bytes(nb: int) -> dict[str, int]:
    """Bytes each entropy layer reads and writes for ``nb`` blocks: its
    operands plus its results, from their shapes (no re-reads counted)."""
    import jax
    import numpy as np

    from tinyimgcodec_tpu.ops import entropy

    def nbytes(tree):
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in jax.tree_util.tree_leaves(tree))

    dc = jax.ShapeDtypeStruct((nb,), np.int32)
    ac = jax.ShapeDtypeStruct((nb, 63), np.int32)
    sym = jax.eval_shape(entropy.block_symbols, dc, ac)
    packed = jax.eval_shape(entropy.pack_blocks, *sym[:3])
    return {
        "block_symbols": nbytes((dc, ac)) + nbytes(sym),
        "pack_blocks": nbytes(sym[:3]) + nbytes(packed),
        # both layers as one pass: coefficients in, word rows out
        "symbols+pack": nbytes((dc, ac)) + nbytes(packed),
    }


def copy_bytes_per_s(n_bytes: int = 2 << 30) -> float:
    """Bytes/s (read + write) of a large elementwise copy on the device."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros(n_bytes // 4, jnp.uint32)
    f = jax.jit(lambda a: a + jnp.uint32(1))
    f(x).block_until_ready()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return 2 * n_bytes / sorted(times)[2]


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
        print(f"profile_encode: {e}", file=sys.stderr)
        return 1
    import jax

    from tinyimgcodec_tpu import api, corpus
    from tinyimgcodec_tpu.parallel import make_mesh
    from tinyimgcodec_tpu.parallel.batch import _build
    from tinyimgcodec_tpu.parallel.tiled import _MeshKey

    card = card_info()
    dev = devices[0]
    where = f"{dev.platform} {dev.device_kind} x{len(devices)}; {card}"
    peak = HBM_BYTES_PER_S[dev.device_kind]
    copy = copy_bytes_per_s()
    print(f"copy {copy / 1e9:.1f} GB/s, published HBM {peak / 1e9:.0f} GB/s "
          f"[{where}]", flush=True)
    images = corpus.synthetic_corpus(args.batch, args.size)
    mp = images.size / 1e6
    floor = layer_bytes(images.size // 64)
    record = {"device": {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(devices)},
              "card": card, "images": list(images.shape),
              "quality": args.quality, "layer_bytes": floor,
              "copy_bytes_per_s": copy, "hbm_bytes_per_s": peak,
              "precisions": {}}
    # api.compress_batch shards over every visible device: exactly one
    key = _MeshKey(make_mesh(1))
    for precision in ("fast", "exact"):
        def call():
            return api.compress_batch(images, args.quality,
                                      precision=precision)

        call()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        wall = sorted(times)[1]
        hlo = _build(key, args.quality, precision, None).lower(
            images).compile().as_text()
        with tempfile.TemporaryDirectory() as td:
            jax.profiler.start_trace(td)
            t0 = time.perf_counter()
            call()
            traced_wall = time.perf_counter() - t0
            jax.profiler.stop_trace()
            path = glob.glob(os.path.join(td, "**", "*.xplane.pb"),
                             recursive=True)[0]
            red = reduce_trace(path, hlo_scope_map(hlo))
        red["wall_ms"] = wall * 1e3
        red["traced_wall_ms"] = traced_wall * 1e3
        red["device_busy_share"] = red["device_busy_ms"] / (
            traced_wall * 1e3)
        ms = red["device_ms_by_scope"]
        ms["symbols+pack"] = ms.get("block_symbols", 0.0) + ms.get(
            "pack_blocks", 0.0)
        red["roofline"] = {}
        for layer, nbytes in floor.items():
            if not ms.get(layer):
                print(f"no device time attributed to {layer}", flush=True)
                continue
            rate = nbytes / (ms[layer] / 1e3)
            red["roofline"][layer] = {
                "bytes": nbytes, "bytes_per_s": rate,
                "share_of_published": rate / peak,
                "share_of_copy": rate / copy,
            }
        record["precisions"][precision] = red
        by = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(ms.items()))
        roof = "; ".join(
            f"{k} {v['bytes'] / 1e6:.1f} MB at {v['bytes_per_s'] / 1e9:.1f}"
            f" GB/s = {v['share_of_published']:.4f} of published, "
            f"{v['share_of_copy']:.4f} of copy"
            for k, v in red["roofline"].items())
        print(f"{precision}: wall {wall * 1e3:.2f} ms "
              + (f"({mp / wall:.1f} MP/s) " if card else "")
              + f"[{where}]; traced call {traced_wall * 1e3:.2f} ms; "
              f"device {by}; busy {red['device_busy_ms']:.3f} ms "
              f"({red['device_busy_share']:.3f} of the traced call); "
              f"host_stitch span {red['host_stitch_ms']:.3f} ms; "
              f"memory roofline: {roof}", flush=True)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_encode.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
