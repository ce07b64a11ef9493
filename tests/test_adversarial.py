"""Adversarial-content encode conformance tests.

Property-style sweeps that drive the public encode paths with content the
natural-image e2e tests never produce (noise, checkerboards, saturated
edges) and with stream sizes stepping across the device-assembly
capacity.  An earlier design once corrupted output silently when a
stream landed in the last row of its capacity buffer.  The reference
encoder can never corrupt output -- its BitBuffer grows without bound
(reference codec.py:133-164, bitbuffer.py:20-27) -- so byte-identity at
*default* settings must hold for every input, not just natural images,
and every capacity either fits the stream or takes the worst-case retry.
"""

import numpy as np
import pytest

from tinyimgcodec_tpu import api, container
from tinyimgcodec_tpu.engine import Engine
from tinyimgcodec_tpu.ops import entropy, transform
from tinyimgcodec_tpu.parallel import make_mesh
from tinyimgcodec_tpu.parallel.batch import compress_batch


def _noise(h, w, seed=7):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w)
    ).astype(np.uint8)


def _contents(h, w):
    """Adversarial content battery: name -> (h, w) uint8 image."""
    y, x = np.mgrid[0:h, 0:w]
    return {
        "noise": _noise(h, w),
        "checker1": ((x + y) % 2 * 255).astype(np.uint8),
        "checker4": (((x // 4 + y // 4) % 2) * 255).astype(np.uint8),
        "hgrad": (x * 255 // max(w - 1, 1)).astype(np.uint8),
        "vgrad": (y * 255 // max(h - 1, 1)).astype(np.uint8),
        "flat0": np.zeros((h, w), np.uint8),
        "flat255": np.full((h, w), 255, np.uint8),
        "stripes": ((x % 2) * 255).astype(np.uint8),
    }


def _payload_bits(stream: bytes) -> int:
    return (len(stream) - container.HEADER_BYTES) * 8


def test_verdict_repro_near_capacity_exact():
    """A 64x64 RandomState(7) noise image, q=50, exact precision,
    default settings -> byte-identical (the historical corruption
    repro)."""
    img = _noise(64, 64, seed=7)
    ref = container.compress(img, quality=50)
    out = compress_batch(img[None], quality=50, precision="exact")[0]
    assert out == ref
    assert np.array_equal(
        container.decompress(out), container.decompress(ref)
    )


def _budget_for_words(cap_words: int, pixels: int) -> float:
    """bits_per_pixel_budget that yields exactly cap_words capacity."""
    return cap_words * 32 / pixels


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_capacity_boundary_device_assembly(precision):
    """Device-assembled bytes must be budget-independent: sweep the
    capacity across the stream's exact word count and both adjacent
    128-word edges; a capacity that is too small takes the worst-case
    retry, never a truncated stream."""
    img = _noise(64, 64, seed=11)
    mesh = make_mesh(1)
    golden = compress_batch(
        img[None], 50, mesh=mesh, precision=precision, assemble="device",
        bits_per_pixel_budget=16.0,
    )[0]
    need = -(-_payload_bits(golden) // 32)
    row_up = -(-need // 128) * 128
    for cap in sorted({need - 64, need - 1, need, need + 1, row_up}):
        out = compress_batch(
            img[None], 50, mesh=mesh, precision=precision,
            assemble="device",
            bits_per_pixel_budget=_budget_for_words(cap, img.size),
        )[0]
        assert out == golden, f"cap_words={cap} (need={need})"
    from tinyimgcodec_tpu import metrics

    dec = container.decompress(golden)
    assert dec.shape == img.shape
    ref = container.decompress(container.compress(img, 50))
    # device assembly resolves exact ties by correct rounding, so a
    # rare coefficient may differ from the oracle's; quality may not
    assert metrics.psnr(img, dec) >= metrics.psnr(img, ref) - 0.05


def test_capacity_boundary_stitch_words_direct():
    """stitch_words places the stream bit-perfectly whenever the
    capacity admits it, and always reports the true total so callers
    detect a capacity that does not."""
    img = _noise(64, 64, seed=3)
    blocks = transform.blockify(img[None])
    zz = transform.encode_blocks(blocks, 50, transform.EXACT)
    dc, ac = transform.dc_dpcm(zz)
    w0, w1, bits, _ = entropy.block_symbols(dc, ac)
    words, block_bits = entropy.pack_blocks(w0, w1, bits)
    words = np.asarray(words)[0]
    block_bits = np.asarray(block_bits)[0].astype(np.int32)
    total_bits = int(block_bits.sum())
    need = -(-total_bits // 32)
    from tinyimgcodec_tpu.bitstream import pack_ragged_words

    expect = np.frombuffer(
        pack_ragged_words(words, block_bits).ljust(need * 4, b"\0"), ">u4"
    )
    for cap in sorted({need - 129, need - 1, need, need + 1, need + 128}):
        stream, total = entropy.stitch_words(words, block_bits, cap)
        assert int(total) == total_bits
        if cap >= need:
            assert np.array_equal(np.asarray(stream)[:need], expect)
        else:
            assert int(total) > cap * 32


def test_capacity_boundary_sharded_exact():
    """Sharded batch (8 virtual devices): host assembly is
    byte-identical to the oracle, and device assembly is
    budget-independent across the per-image capacity boundary."""
    imgs = np.stack([_noise(64, 64, seed=100 + i) for i in range(8)])
    refs = [container.compress(im, quality=50) for im in imgs]
    mesh = make_mesh(8)
    assert compress_batch(imgs, 50, mesh=mesh) == refs
    roomy = compress_batch(imgs, 50, mesh=mesh, assemble="device",
                           bits_per_pixel_budget=16.0)
    w_hi = max(-(-_payload_bits(r) // 32) for r in roomy)
    for cap in sorted({w_hi - 1, w_hi, -(-w_hi // 128) * 128}):
        out = compress_batch(
            imgs, 50, mesh=mesh, assemble="device",
            bits_per_pixel_budget=cap * 32 / (64 * 64),
        )
        assert out == roomy, f"cap_words={cap}"


@pytest.mark.parametrize("batch", [1, 7, 9])
def test_any_batch_size_exact(batch):
    """Every batch size runs the same XLA program family (padded to the
    mesh) and stays byte-exact; no batch shape is refused."""
    imgs = np.stack([_noise(64, 64, seed=s) for s in range(batch)])
    out = api.compress_batch(imgs, quality=50, precision="exact")
    refs = [
        container.compress(im, quality=50, block_index=True)
        for im in imgs
    ]
    assert out == refs


def test_stream_path_near_capacity_exact():
    """compress_stream at DEFAULT settings on high-entropy input."""
    from tinyimgcodec_tpu.parallel.stream import compress_stream

    imgs = [_noise(64, 64, seed=s) for s in (7, 8, 9)]
    refs = [
        container.compress(im, quality=50, block_index=True)
        for im in imgs
    ]
    out = list(
        compress_stream(imgs, quality=50, precision="exact", chunk=2)
    )
    assert out == refs


@pytest.mark.parametrize("quality", [1, 10, 50, 90, 95, 99])
def test_adversarial_content_exact_byte_identity(quality):
    """Content battery x quality: the batch exact path at default
    settings is byte-identical to the float64 host oracle for EVERY
    input, including ones the natural corpus never produces.  Where the
    oracle itself refuses (q=99 extreme content overflows the standard
    table's AC size range -- the reference dies with a bare KeyError
    there, codec.py:153-162), the device path must raise the same
    documented error, never emit bytes."""
    imgs = np.stack(list(_contents(64, 64).values()))
    try:
        refs = [container.compress(im, quality=quality) for im in imgs]
    except ValueError:
        with pytest.raises(ValueError, match="Huffman table range"):
            compress_batch(imgs, quality=quality, precision="exact")
        return
    out = compress_batch(imgs, quality=quality, precision="exact")
    assert out == refs
    for im, s in zip(imgs, out):
        dec = container.decompress(s)
        assert dec.shape == im.shape


@pytest.mark.parametrize("quality", [1, 50, 99])
def test_adversarial_content_fast_decodable(quality):
    """Fast mode on the same battery: always decodable, dimensions
    preserved, and rate/distortion sane vs the oracle."""
    from tinyimgcodec_tpu import metrics

    contents = _contents(64, 64)
    imgs = np.stack(list(contents.values()))
    try:
        refs = [container.compress(im, quality=quality) for im in imgs]
    except ValueError:
        with pytest.raises(ValueError, match="Huffman table range"):
            compress_batch(imgs, quality=quality, precision="fast")
        return
    out = compress_batch(imgs, quality=quality, precision="fast")
    for name, im, s, r in zip(contents, imgs, out, refs):
        dec = container.decompress(s)
        assert dec.shape == im.shape, name
        p_fast = metrics.psnr(im, dec)
        p_ref = metrics.psnr(im, container.decompress(r))
        # flat content decodes losslessly on both paths (PSNR inf)
        assert p_fast >= p_ref - 0.6, (name, quality, p_fast, p_ref)
        assert abs(len(s) - len(r)) <= max(16, len(r) // 50), name


@pytest.mark.parametrize("name", sorted(_contents(8, 8)))
def test_adversarial_content_engine_single_image(name):
    """The single-image Engine path on each battery content (odd 60x52
    shape: reflect padding + true dims), q=50 exact, is byte-identical
    to the oracle including the TICX trailer."""
    img = _contents(60, 52)[name]
    out = Engine("exact").compress(img, 50)
    assert out == container.compress(img, 50, block_index=True)
    assert container.parse_header(out)[:2] == (60, 52)


@pytest.mark.parametrize("quality", [97, 99])
def test_batch_pad_images_never_overflow(quality):
    """Batches padded to the mesh size (1 real image over 8 devices)
    must not fail on the pads: checkerboard content encodes at q>=97,
    but a zero image would overflow the standard tables there."""
    img = _contents(64, 64)["checker1"]
    ref = container.compress(img, quality)
    assert compress_batch(img[None], quality, mesh=make_mesh(8)) == [ref]
