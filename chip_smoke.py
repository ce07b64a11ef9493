#!/usr/bin/env python3
"""Smoke check of the codec on NVIDIA GPUs through the public API.

    python chip_smoke.py           # one card: every encode/decode phase
    python chip_smoke.py --multi   # four cards: the sharded paths only

Every phase compares the device path with the in-repo float64 oracle
(``container.compress`` / ``container.decompress``): exact-mode bytes
must be identical and decoded pixels must be identical.  Inputs are
generated from seeds (``corpus.synthetic_corpus``, ``corpus.golden_image``).

The script pins JAX to CUDA before any JAX call, so a machine without a
GPU is an error, never a CPU run.  Any failed check exits non-zero.  Rates
are printed only beside the card's name and power limit as nvidia-smi
reports them.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

QUALITY = 50
SWEEP_QUALITIES = (10, 25, 50, 75, 90)
ADVERSARIAL_QUALITIES = (1, 99)
# fast mode (f32 transform, no float64 fix-up) may round rare ties the
# other way; its PSNR must stay within this many dB of exact mode's
FAST_PSNR_BOUND_DB = 0.05


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str | None:
    """``name, power.limit`` of the first card, or None if unreadable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None
    return lines[0].strip()


class Rates:
    """Prints MP/s only when the card's name and power limit are known."""

    def __init__(self, card: str | None):
        self.card = card

    def report(self, label: str, megapixels: float, seconds: float):
        if self.card is not None:
            log(f"  rate {label}: {megapixels / seconds:.1f} MP/s "
                f"({megapixels:.2f} MP in {seconds:.4f} s) [{self.card}]")


def timed(fn, *args, reps: int = 3, **kw):
    """(result, median warm seconds) after one untimed warm-up call."""
    out = fn(*args, **kw)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2]


def megapixels(images) -> float:
    return sum(int(np.asarray(im).size) for im in images) / 1e6


def adversarial_contents(h: int, w: int) -> dict[str, np.ndarray]:
    """Content the natural corpus never produces: noise, checkerboards,
    gradients, flat fields, stripes."""
    y, x = np.mgrid[0:h, 0:w]
    return {
        "noise": np.random.RandomState(7).randint(0, 256, (h, w))
        .astype(np.uint8),
        "checker1": ((x + y) % 2 * 255).astype(np.uint8),
        "checker4": (((x // 4 + y // 4) % 2) * 255).astype(np.uint8),
        "hgrad": (x * 255 // max(w - 1, 1)).astype(np.uint8),
        "vgrad": (y * 255 // max(h - 1, 1)).astype(np.uint8),
        "flat0": np.zeros((h, w), np.uint8),
        "flat255": np.full((h, w), 255, np.uint8),
        "stripes": ((x % 2) * 255).astype(np.uint8),
    }


# -- one-card phases -----------------------------------------------------

def oracle_streams(images, quality: int):
    """(oracle bytes with the TICX trailer, oracle CodecArrays) per image."""
    from tinyimgcodec_tpu import container, golden

    arrays = [golden.encode_arrays(np.asarray(im), quality) for im in images]
    refs = [container.compress_arrays(a, block_index=True) for a in arrays]
    return refs, arrays


def phase_corpus_encode(images, quality: int, rates: Rates) -> list[bytes]:
    """api.compress_batch, exact (byte identity) and fast (PSNR bound,
    coefficient disagreement with the oracle)."""
    import jax

    from tinyimgcodec_tpu import api, container, metrics
    from tinyimgcodec_tpu.ops import transform

    refs, arrays = oracle_streams(images, quality)
    out, dt = timed(api.compress_batch, images, quality, precision="exact")
    bad = sum(a != b for a, b in zip(out, refs))
    log(f"  exact: {len(refs) - bad}/{len(refs)} streams byte-identical "
        "to the oracle")
    check(bad == 0, f"exact compress_batch: {bad} streams differ")
    rates.report("compress_batch exact", megapixels(images), dt)

    fast, dt = timed(api.compress_batch, images, quality, precision="fast")
    rates.report("compress_batch fast", megapixels(images), dt)
    worst = np.inf
    for im, f, r in zip(images, fast, refs):
        p_fast = metrics.psnr(im, container.decompress(f))
        p_exact = metrics.psnr(im, container.decompress(r))
        worst = min(worst, p_fast - p_exact)
    log(f"  fast: all decode; worst PSNR(fast) - PSNR(exact) = "
        f"{worst:.4f} dB (bound -{FAST_PSNR_BOUND_DB})")
    check(worst >= -FAST_PSNR_BOUND_DB, "fast-mode PSNR below the bound")

    encode = jax.jit(lambda x: transform.encode_blocks(
        transform.blockify(x), quality, transform.FAST))
    zz_fast = np.asarray(encode(np.asarray(images)))
    zz_ref = np.stack([
        np.concatenate(
            [np.cumsum(a.dc, dtype=np.int64)[:, None], a.ac], axis=1
        )
        for a in arrays
    ])
    diff = int(np.count_nonzero(zz_fast != zz_ref))
    log(f"  fast-mode coefficients differing from exact mode: {diff} "
        f"of {zz_ref.size}")
    return refs


def phase_single_images(named: dict, quality: int, rates: Rates) -> None:
    from tinyimgcodec_tpu import api, container

    for name, im in named.items():
        t0 = time.perf_counter()
        ref = container.compress(im, quality, block_index=True)
        t_oracle = time.perf_counter() - t0
        out, dt = timed(api.compress, im, quality, reps=1)
        log(f"  {name} {im.shape[0]}x{im.shape[1]}: "
            f"{'byte-identical' if out == ref else 'DIFFERS'} "
            f"({len(ref)} bytes; oracle {t_oracle:.1f} s)")
        check(out == ref, f"api.compress {name} differs from the oracle")
        rates.report(f"api.compress {name}", megapixels([im]), dt)


def phase_golden(quality: int = 50) -> None:
    from tinyimgcodec_tpu import container, corpus, metrics

    g = corpus.golden_image()
    data = container.compress(g, quality)
    p = metrics.psnr(g, container.decompress(data))
    log(f"  golden image q={quality}: {len(data)} bytes, PSNR {p:.4f} dB "
        f"(pinned {corpus.GOLDEN_Q50_BYTES}, {corpus.GOLDEN_Q50_PSNR})")
    check(len(data) == corpus.GOLDEN_Q50_BYTES, "golden byte count moved")
    check(abs(p - corpus.GOLDEN_Q50_PSNR) < 5e-4, "golden PSNR moved")


def phase_sweep(images, qualities) -> None:
    from tinyimgcodec_tpu import api, container, metrics

    for q in qualities:
        refs, _ = oracle_streams(images, q)
        out = api.compress_batch(images, q, precision="exact")
        bad = sum(a != b for a, b in zip(out, refs))
        cr = np.mean([im.size / len(s) for im, s in zip(images, out)])
        p = np.mean([metrics.psnr(im, container.decompress(s))
                     for im, s in zip(images, out)])
        log(f"  q={q}: {len(refs) - bad}/{len(refs)} byte-identical, "
            f"CR {cr:.3f}, PSNR {p:.3f} dB")
        check(bad == 0, f"sweep q={q}: {bad} streams differ")


def phase_adversarial(size: int, qualities) -> None:
    """Where the oracle refuses (coefficients beyond the standard
    table), the device path must raise the same error, never emit
    bytes."""
    from tinyimgcodec_tpu import api, container

    contents = adversarial_contents(size, size)
    for q in qualities:
        good, refs, refused = [], [], []
        for name, im in contents.items():
            try:
                refs.append(container.compress(im, q, block_index=True))
                good.append(name)
            except ValueError:
                refused.append(name)
        out = api.compress_batch(
            np.stack([contents[n] for n in good]), q, precision="exact")
        bad = [n for n, a, b in zip(good, out, refs) if a != b]
        check(not bad, f"adversarial q={q}: {bad} differ")
        for name in refused:
            try:
                api.compress(contents[name], q)
            except ValueError as e:
                check("Huffman table range" in str(e),
                      f"adversarial q={q} {name}: wrong error {e}")
            else:
                raise SmokeFailure(
                    f"adversarial q={q} {name}: device emitted bytes "
                    "where the oracle refuses")
        log(f"  q={q}: {len(good)} byte-identical "
            f"({', '.join(good)}); {len(refused)} refused as by the "
            f"oracle ({', '.join(refused) or '-'})")


def phase_auto_table(quality: int = 50) -> None:
    from tinyimgcodec_tpu import api, container, corpus

    g = corpus.golden_image()
    out = api.compress(g, quality, auto_generate_huffman_table=True)
    ref = container.compress(g, quality, True, block_index=True)
    check(out == ref, "auto-table bytes differ from the oracle")
    dec = api.decompress(out)
    check(np.array_equal(dec, container.decompress(ref)),
          "auto-table decode differs from the oracle")
    log(f"  auto table q={quality}: byte-identical ({len(out)} bytes), "
        "decode pixel-identical")


def phase_decode(streams_by_q: dict, rates: Rates) -> None:
    """Device chain and host C LUT, each pixel-identical to the oracle;
    host fallbacks counted on the device chain."""
    from tinyimgcodec_tpu import api, container
    from tinyimgcodec_tpu.engine import Engine

    device = Engine("exact", device_entropy=True)
    host = Engine("exact", device_entropy=False)
    for q, streams in streams_by_q.items():
        ref = np.stack([container.decompress(s) for s in streams])
        mp = ref.size / 1e6
        for label, eng in (("device chain", device), ("host C LUT", host)):
            before = eng.host_fallbacks
            out = eng.decompress_batch(streams)
            fallbacks = eng.host_fallbacks - before
            same = np.array_equal(np.asarray(out), ref)
            log(f"  q={q} {label}: "
                f"{'pixel-identical' if same else 'DIFFERS'}; "
                f"host fallbacks per call {fallbacks}")
            check(same, f"decode q={q} {label} differs from the oracle")
            if label == "device chain" and q == QUALITY:
                check(fallbacks == 0, "device chain fell back to the host")
            _, dt = timed(eng.decompress_batch, streams)
            rates.report(f"decompress_batch q={q} {label}", mp, dt)
    streams = streams_by_q[QUALITY]
    ref = [container.decompress(s) for s in streams]
    out = api.decompress_batch(streams)
    check(all(np.array_equal(a, b) for a, b in zip(out, ref)),
          "api.decompress_batch differs from the oracle")
    one = api.decompress(streams[0])
    check(np.array_equal(one, ref[0]), "api.decompress differs")
    log("  api.decompress_batch / api.decompress: pixel-identical")


def compile_times(images, quality: int) -> None:
    """Lower + compile the batch encode program in both precisions."""
    from tinyimgcodec_tpu.parallel import make_mesh
    from tinyimgcodec_tpu.parallel.batch import _build
    from tinyimgcodec_tpu.parallel.tiled import _MeshKey

    key = _MeshKey(make_mesh(1))
    x = np.asarray(images)
    for precision in ("exact", "fast"):
        t0 = time.perf_counter()
        _build(key, quality, precision, None).lower(x).compile()
        log(f"  compile encode program {precision} "
            f"{x.shape}: {time.perf_counter() - t0:.2f} s")


def run_single(card: str | None) -> None:
    from tinyimgcodec_tpu import corpus

    rates = Rates(card)
    images = corpus.synthetic_corpus(49, 512)
    with phase("compile"):
        compile_times(images, QUALITY)
    with phase("golden image oracle"):
        phase_golden()
    with phase("corpus encode 49x512^2 q=50"):
        streams = {QUALITY: phase_corpus_encode(images, QUALITY, rates)}
    with phase("api.compress 512^2 and 4096^2"):
        phase_single_images({
            "golden": corpus.golden_image(),
            "big": corpus.synthetic_corpus(1, 4096)[0],
        }, QUALITY, rates)
    with phase("quality sweep on 8 corpus images"):
        phase_sweep(images[:8], SWEEP_QUALITIES)
    with phase("adversarial battery 256^2"):
        phase_adversarial(256, ADVERSARIAL_QUALITIES)
    with phase("auto Huffman table"):
        phase_auto_table()
    with phase("decode 49x512^2 at q=50 and q=90"):
        streams[90] = oracle_streams(images, 90)[0]
        phase_decode(streams, rates)


# -- four-card phases ------------------------------------------------------

def run_multi(card: str | None, n: int = 4, n_images: int = 49,
              size: int = 512, big_size: int = 4096) -> None:
    import jax

    from tinyimgcodec_tpu import container, corpus, metrics
    from tinyimgcodec_tpu.parallel import make_mesh
    from tinyimgcodec_tpu.parallel.batch import (
        compress_batch,
        decompress_batch_sharded,
    )
    from tinyimgcodec_tpu.parallel.tiled import encode_tiled

    check(len(jax.devices()) >= n, f"--multi needs {n} devices")
    rates = Rates(card)
    mesh1, mesh_n = make_mesh(1), make_mesh(n)
    images = corpus.synthetic_corpus(n_images, size)
    big = corpus.synthetic_corpus(1, big_size)[0]
    one: list = []

    def sharded_encode():
        ref, dt1 = timed(compress_batch, images, QUALITY, mesh=mesh1,
                         block_index=True)
        out, dtn = timed(compress_batch, images, QUALITY, mesh=mesh_n,
                         block_index=True)
        bad = sum(a != b for a, b in zip(out, ref))
        log(f"  compress_batch over {n} devices: {len(ref) - bad}/"
            f"{len(ref)} byte-identical to the one-device run")
        check(bad == 0, "sharded encode differs from one device")
        rates.report("compress_batch exact, 1 device", megapixels(images),
                     dt1)
        rates.report(f"compress_batch exact, {n} devices",
                     megapixels(images), dtn)
        one.extend(ref)

    def tiled():
        ref = container.compress(big, QUALITY)
        host = encode_tiled(big, QUALITY, mesh=mesh_n)
        check(host == ref, "encode_tiled host assembly differs")
        # device assembly resolves exact rounding ties itself instead of
        # by the float64 fix-up: rare coefficients may differ from the
        # oracle's, the quality may not
        dev = encode_tiled(big, QUALITY, mesh=mesh_n, assemble="device")
        a = container.decompress(dev)
        b = container.decompress(ref)
        check(a.shape == b.shape, "device-assembled stream shape")
        p_dev, p_ref = metrics.psnr(big, a), metrics.psnr(big, b)
        check(p_dev >= p_ref - FAST_PSNR_BOUND_DB,
              f"device-assembled PSNR {p_dev:.4f} below the oracle's "
              f"{p_ref:.4f}")
        diff = int(np.count_nonzero(a != b))
        log(f"  encode_tiled {big_size}^2 over {n} devices: host assembly "
            f"byte-identical; device assembly decodes, PSNR {p_dev:.4f} "
            f"vs oracle {p_ref:.4f} dB ({diff} pixels differ)")

    def sharded_decode():
        ref = np.stack([container.decompress(s) for s in one])
        out = decompress_batch_sharded(one, mesh=mesh_n)
        check(out is not None, "sharded decode refused the batch")
        check(np.array_equal(out, ref), "sharded decode differs")
        log(f"  decompress_batch_sharded over {n} devices: "
            "pixel-identical")

    with phase(f"sharded encode, {n} devices"):
        sharded_encode()
    with phase(f"tiled encode, {n} devices"):
        tiled()
    with phase(f"sharded decode, {n} devices"):
        sharded_decode()


@contextlib.contextmanager
def phase(name: str):
    log(f"phase: {name}")
    t0 = time.perf_counter()
    yield
    log(f"  done in {time.perf_counter() - t0:.1f} s")


def init_gpu(multi: bool):
    """Pin JAX to CUDA (before any JAX call) and return its devices."""
    if not multi:
        # the one-card run sees exactly one card: the first of those the
        # caller made visible, else card 0
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
        os.environ["CUDA_VISIBLE_DEVICES"] = visible[0].strip() or "0"
    import jax

    jax.config.update("jax_platforms", "cuda")
    try:
        devices = jax.devices()
    except Exception as e:  # any backend failure here means no usable GPU
        raise SmokeFailure(
            f"no GPU: JAX found no CUDA device ({type(e).__name__}: {e})"
        ) from e
    check(devices[0].platform == "gpu",
          f"no GPU: JAX reports platform {devices[0].platform!r}")
    if not multi:
        check(len(devices) == 1,
              f"one-card run sees {len(devices)} devices")
    return devices


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="four cards: sharded encode and decode only")
    args = parser.parse_args(argv)
    try:
        devices = init_gpu(args.multi)
        sys.path.insert(0, REPO)
        card = card_info()
        log(f"card: {card if card is not None else 'unknown'}")
        log(f"jax devices: {len(devices)} x {devices[0].device_kind}")
        if args.multi:
            run_multi(card)
            count = 4
        else:
            run_single(card)
            count = len(devices)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
