"""Decoder robustness fuzzing.

The reference's decoder survives truncated/corrupt payloads via its
per-block try/except (codec.py:178-186, SURVEY quirk 2.5-10): failed
blocks decode as flat, nothing raises.  Our decoders (pure-python
oracle, native C LUT path, indexed path, device transform) must uphold
the same contract for ARBITRARY byte corruption -- no crashes, no
out-of-bounds reads (the C path runs under the ASan selftest in
tests/test_native.py; this file covers the Python-visible behavior).
"""

import struct

import numpy as np
import pytest

from tests.conftest import synthetic_image
from tinyimgcodec_tpu import container, native


def _valid_stream(seed=0, q=50, shape=(64, 64), **kw):
    return container.compress(synthetic_image(*shape, seed=seed), q, **kw)


def test_random_payload_bytes_never_raise():
    rng = np.random.RandomState(0)
    header = struct.pack("<IIII", 64, 64, 50, 0)
    for trial in range(25):
        payload = rng.bytes(rng.randint(0, 400))
        out = container.decompress(header + payload)
        assert out.shape == (64, 64)
        assert out.dtype == np.uint8


def test_bit_flips_in_valid_stream_never_raise():
    data = bytearray(_valid_stream(seed=5))
    rng = np.random.RandomState(1)
    for trial in range(25):
        mut = bytearray(data)
        for _ in range(rng.randint(1, 8)):
            i = rng.randint(16, len(mut))  # corrupt payload, not header
            mut[i] ^= 1 << rng.randint(0, 8)
        out = container.decompress(bytes(mut))
        assert out.shape == (64, 64)


def test_truncations_at_every_granularity():
    data = _valid_stream(seed=6)
    for n in range(16, len(data), 37):
        out = container.decompress(data[:n])
        assert out.shape == (64, 64)


def test_corrupt_custom_table_stream_degrades():
    data = bytearray(_valid_stream(seed=7, **{
        "auto_generate_huffman_table": True
    }))
    rng = np.random.RandomState(2)
    for trial in range(10):
        mut = bytearray(data)
        for _ in range(4):
            i = rng.randint(16, len(mut))
            mut[i] ^= 0xFF
        try:
            out = container.decompress(bytes(mut))
            assert out.shape == (64, 64)
        except (ValueError, EOFError):
            # a corrupted TABLE segment may be structurally undecodable
            # (lengths describe more bits than exist); raising a clean
            # error there is acceptable -- crashes/hangs are not
            pass


def test_corrupt_index_trailer_degrades_to_serial():
    # stride 16 gives nb=64 four chunks, so start+12 is a genuine
    # INTERIOR chunk offset and the monotone/in-range offset validation
    # (not just the length bookkeeping) is what must reject it
    data = bytearray(
        _valid_stream(seed=8, block_index=True, index_stride=16)
    )
    ref = container.decompress(bytes(_valid_stream(seed=8)))
    # corrupt offsets inside the TICX trailer: parse must reject it and
    # decode must fall back to the serial cursor with identical output
    body_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    start = len(data) - 8 - body_len
    # second chunk offset -> huge: breaks offset monotonicity
    struct.pack_into("<I", data, start + 12, 0xFFFFFFFF)
    nb = 64
    assert container.parse_block_index(bytes(data), nb) is None
    out = container.decompress(bytes(data))
    assert np.array_equal(out, ref)


@pytest.mark.skipif(not native.available(), reason="no C compiler")
def test_native_and_python_decoders_agree_on_garbage():
    """The C LUT decoder and the pure-python oracle must produce the
    SAME coefficients even on corrupt input (same cursor semantics)."""
    rng = np.random.RandomState(3)
    data = bytearray(_valid_stream(seed=9))
    for trial in range(10):
        mut = bytearray(data)
        for _ in range(3):
            i = rng.randint(16, len(mut))
            mut[i] ^= 1 << rng.randint(0, 8)
        a = container.decompress_to_arrays(bytes(mut), use_native=True)
        b = container.decompress_to_arrays(bytes(mut), use_native=False)
        assert np.array_equal(a.dc, b.dc)
        assert np.array_equal(a.ac, b.ac)


def test_device_decode_path_fuzz_matches_host_oracle():
    """Corrupt TICX streams through the DEVICE entropy decoder (chain +
    continuation + validation) must produce exactly the host oracle's
    graceful-degradation pixels: bad chunks fail validation and the
    whole image host-decodes, so outputs agree bit-for-bit."""
    from tinyimgcodec_tpu.engine import Engine

    eng = Engine("exact", device_entropy=True)
    rng = np.random.RandomState(13)
    base = bytearray(
        _valid_stream(seed=21, shape=(64, 64), block_index=True,
                      index_stride=16)
    )
    for trial in range(8):
        mut = bytearray(base)
        for _ in range(rng.randint(1, 6)):
            i = rng.randint(16, len(mut))
            mut[i] ^= 1 << rng.randint(0, 8)
        data = bytes(mut)
        dev = eng.decompress(data)
        host = container.decompress(data)
        assert np.array_equal(dev, host), f"trial {trial} diverged"
    # truncating INSIDE the payload invalidates the trailer bookkeeping
    # -> parse_block_index rejects -> device path is skipped cleanly
    half = bytes(base[: len(base) // 2])
    assert np.array_equal(eng.decompress(half),
                          container.decompress(half))
