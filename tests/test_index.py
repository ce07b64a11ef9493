"""TICX block-offset index extension: parallel entropy decode.

The trailer rides after the payload; reference decoders read exactly
nblocks blocks and ignore trailing bytes (reference codec.py:175-186,
SURVEY quirk 2.5-3/10), so indexed streams stay reference-decodable
while our decoder splits the serial bit-cursor walk at every indexed
block and decodes chunks concurrently.
"""

import numpy as np
import pytest

from tests.conftest import needs_reference, synthetic_image
from tinyimgcodec_tpu import container, native


def test_index_make_parse_roundtrip():
    offsets = np.cumsum(np.arange(1, 257) * 7)
    offsets = offsets - offsets[0]  # starts at 0
    trailer = container.make_block_index(offsets, stride=64)
    data = b"\x00" * 16 + b"\xaa" * (int(offsets[-1]) // 8 + 4) + trailer
    got = container.parse_block_index(data, 256)
    assert got is not None
    off, stride, end = got
    assert stride == 64
    assert np.array_equal(off, offsets[::64])
    assert end == len(data) - len(trailer)


def test_index_rejects_tampering():
    offsets = np.arange(0, 64 * 40, 40)
    trailer = container.make_block_index(offsets, stride=64)
    base = b"\x00" * 16 + b"\xbb" * 400

    assert container.parse_block_index(base, 64) is None  # no trailer
    data = base + trailer
    assert container.parse_block_index(data, 64) is not None
    # wrong block count
    assert container.parse_block_index(data, 128) is None
    # corrupt magic
    assert container.parse_block_index(data[:-1] + b"Y", 64) is None
    # truncated
    assert container.parse_block_index(data[:-3], 64) is None
    # non-monotone offsets
    bad = np.array([0, 100, 50, 200])
    t2 = container.make_block_index(
        np.repeat(bad, 64)[: 4 * 64], stride=64
    )
    assert container.parse_block_index(base + t2, 4 * 64) is None
    # offset past payload end
    t3 = container.make_block_index(
        np.arange(0, 64 * 64 * 800, 800), stride=64
    )
    assert container.parse_block_index(base + t3, 64 * 64) is None


def test_host_indexed_stream_roundtrips_identically():
    img = synthetic_image(128, 96, seed=41)
    plain = container.compress(img, 50)
    indexed = container.compress(img, 50, block_index=True)
    # the payload is untouched -- the trailer is a pure suffix
    assert indexed[: len(plain)] == plain
    assert len(indexed) > len(plain)
    out_plain = container.decompress(plain)
    out_indexed = container.decompress(indexed)
    assert np.array_equal(out_plain, out_indexed)


@pytest.mark.skipif(not native.available(), reason="no C compiler")
def test_indexed_decode_matches_serial_decode():
    img = synthetic_image(256, 256, seed=42)  # 1024 blocks = 16 chunks
    indexed = container.compress(img, 50, block_index=True)
    nb = 1024
    parsed = container.parse_block_index(indexed, nb)
    assert parsed is not None
    chunk_off, stride, pay_end = parsed
    assert len(chunk_off) == nb // stride

    serial_dc, serial_ac = native.entropy_decode(indexed[16:pay_end], nb)
    par_dc, par_ac = native.entropy_decode_indexed(
        indexed[16:pay_end], nb, chunk_off, stride
    )
    assert np.array_equal(serial_dc, par_dc)
    assert np.array_equal(serial_ac, par_ac)


def test_indexed_stream_truncation_degrades_gracefully():
    img = synthetic_image(128, 128, seed=43)
    indexed = container.compress(img, 50, block_index=True)
    # cutting the stream destroys the trailer -> validated away -> the
    # serial path decodes what remains (quirk 2.5-10 semantics)
    half = container.decompress(indexed[: len(indexed) // 2])
    assert half.shape == img.shape


def test_engine_block_index(monkeypatch):
    from tinyimgcodec_tpu import api

    img = synthetic_image(64, 64, seed=44)
    plain = api.compress(img, 50, backend="host")
    indexed = api.compress(img, 50, backend="host", block_index=True)
    assert indexed[: len(plain)] == plain
    assert np.array_equal(
        api.decompress(plain, backend="host"),
        api.decompress(indexed, backend="host"),
    )

    eng_indexed = api.compress(img, 50, backend="jax", block_index=True)
    # engine and host emit identical bytes including the trailer
    assert eng_indexed == indexed


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_batch_pipeline_block_index(precision):
    from tinyimgcodec_tpu.parallel.batch import compress_batch

    imgs = np.stack(
        [synthetic_image(64, 64, seed=50 + i) for i in range(3)]
    )
    plain = compress_batch(imgs, 50, precision=precision)
    indexed = compress_batch(imgs, 50, precision=precision,
                             block_index=True)
    for p, ix, img in zip(plain, indexed, imgs):
        assert ix[: len(p)] == p
        assert container.parse_block_index(ix, 64) is not None
        assert np.array_equal(
            container.decompress(ix), container.decompress(p)
        )
        if precision == "exact":
            # trailer offsets match the host container's byte-for-byte
            assert ix == container.compress(img, 50, block_index=True)


@needs_reference
def test_reference_decoder_ignores_index(lenna):
    """Cross-implementation conformance: the reference's own decoder
    must decode an indexed stream exactly like a plain one (it stops
    after nblocks blocks; trailing bytes never reach its bit cursor)."""
    from tests.ref_shim import import_reference

    ref = import_reference()
    img = lenna[:128, :128]
    plain = container.compress(img, 50)
    indexed = container.compress(img, 50, block_index=True)
    a = ref.decompress(plain)
    b = ref.decompress(indexed)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(a), container.decompress(plain))
