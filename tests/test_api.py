"""API-boundary behavior: validation, backend selection, dynamic tables.

VERDICT round-1 items 5 and 7: quality is validated at the boundary
(the reference silently NaNs at q=100, SURVEY quirk 2.5-6), engine
failures raise, and auto_generate_huffman_table runs on the
device path (the reference's one broken feature, codec.py:146-148).
"""

import numpy as np
import pytest

from tinyimgcodec_tpu import api, container
from tinyimgcodec_tpu.config import CodecConfig


def test_quality_100_raises(small_image):
    with pytest.raises(ValueError, match="quality"):
        api.compress(small_image, quality=100)


def test_quality_0_raises(small_image):
    with pytest.raises(ValueError, match="quality"):
        api.compress(small_image, quality=0)


def test_bad_backend_raises(small_image):
    with pytest.raises(ValueError, match="backend"):
        api.compress(small_image, backend="cuda")


def test_bad_precision_raises(small_image):
    with pytest.raises(ValueError, match="precision"):
        api.compress(small_image, precision="double")


def test_config_object_round_trip(small_image):
    cfg = CodecConfig(quality=75, precision="exact")
    data = api.compress(small_image, config=cfg)
    out = api.decompress(data)
    assert out.shape == small_image.shape
    # block_index now defaults ON at this boundary (round-4 verdict #2)
    assert data == container.compress(small_image, 75, block_index=True)


def test_engine_failure_warns_and_jax_reraises(small_image, monkeypatch):
    """An engine that fails to build raises under every JAX backend
    choice: nothing degrades into the host path unnoticed."""
    monkeypatch.setattr(api, "_ENGINES", {})

    import tinyimgcodec_tpu.engine as engine_mod

    boom = ImportError("no XLA for you")

    class _Broken:
        def __init__(self, *a, **k):
            raise boom

    monkeypatch.setattr(engine_mod, "Engine", _Broken)
    for backend in ("auto", "jax"):
        with pytest.raises(ImportError) as ei:
            api.compress(small_image, quality=50, backend=backend)
        assert ei.value is boom
    # the host path never builds an engine
    data = api.compress(small_image, quality=50, backend="host")
    assert data == container.compress(small_image, 50, block_index=True)


def test_missing_jax_falls_back_to_host(small_image, monkeypatch):
    """Only a missing ``jax`` install sends backend="auto" to the host."""
    import importlib.util

    monkeypatch.setattr(api, "_ENGINES", {})
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "jax" else real(name, *a),
    )
    data = api.compress(small_image, quality=50, backend="auto")
    assert data == container.compress(small_image, 50, block_index=True)
    with pytest.raises(RuntimeError, match="jax is not installed"):
        api.compress(small_image, quality=50, backend="jax")


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_auto_table_device_matches_host_bytes(lenna, quality):
    """Dynamic tables end-to-end on the device path: byte-identical to the
    host container path (same histograms -> same canonical tables -> same
    payload bits), and round-trips."""
    dev = api.compress(
        lenna, quality=quality, auto_generate_huffman_table=True,
        backend="jax",
    )
    host = container.compress(
        lenna, quality, auto_generate_huffman_table=True,
        block_index=True,
    )
    assert dev == host
    out = api.decompress(dev)
    ref = container.decompress(host)
    np.testing.assert_array_equal(out, ref)


def test_auto_table_smaller_than_static(lenna):
    """Frequency-optimal tables should beat the Annex K defaults."""
    auto = api.compress(lenna, quality=50, auto_generate_huffman_table=True)
    static = api.compress(lenna, quality=50)
    # table serialization costs ~hundreds of bytes; the payload saving on a
    # 512x512 natural image exceeds it
    assert len(auto) < len(static)


def test_auto_table_odd_shape(small_image):
    data = api.compress(
        small_image, quality=35, auto_generate_huffman_table=True,
        backend="jax",
    )
    host = container.compress(small_image, 35, True, block_index=True)
    assert data == host
    np.testing.assert_array_equal(
        api.decompress(data), container.decompress(host)
    )


def test_symbol_counts_match_per_block_rle(small_image):
    from collections import Counter

    from tinyimgcodec_tpu import golden
    from tinyimgcodec_tpu.golden import bits_required, run_length_encode
    from tinyimgcodec_tpu.huffman import symbol_counts

    arrays = golden.encode_arrays(small_image, 50)
    dc_counts, ac_counts = symbol_counts(arrays.dc, arrays.ac)
    ref_dc = Counter(int(c) for c in bits_required(arrays.dc))
    ref_ac: Counter = Counter()
    for row in arrays.ac:
        for run, value in run_length_encode(row):
            ref_ac[(run, int(bits_required(np.int32(value))))] += 1
    from tinyimgcodec_tpu.huffman import AC_SIZES, DC_CATS

    for cat in range(DC_CATS):
        assert dc_counts[cat] == ref_dc.get(cat, 0)
    for run in range(16):
        for size in range(AC_SIZES):
            assert ac_counts[run * AC_SIZES + size] == ref_ac.get(
                (run, size), 0
            ), (run, size)


def test_concat_bit_payload():
    from tinyimgcodec_tpu.bitstream import (
        BitWriter,
        bytes_to_bits,
        concat_bit_payload,
    )

    rng = np.random.RandomState(0)
    for prefix_bits in [0, 1, 5, 8, 13, 16, 23]:
        for payload_bits in [0, 3, 8, 17, 64, 129]:
            pre_bits = rng.randint(0, 2, prefix_bits)
            pay_bits = rng.randint(0, 2, payload_bits)
            w = BitWriter()
            for b in pre_bits:
                w.write_bits(int(b), 1)
            pw = BitWriter()
            for b in pay_bits:
                pw.write_bits(int(b), 1)
            out = concat_bit_payload(
                w.to_bytes(), prefix_bits, pw.to_bytes(), payload_bits
            )
            want = np.concatenate([pre_bits, pay_bits]).astype(np.uint8)
            got = bytes_to_bits(out)[: prefix_bits + payload_bits]
            np.testing.assert_array_equal(got, want)
