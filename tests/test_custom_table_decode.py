"""Dynamic-table streams through the chunk-parallel DEVICE decoder.

Round-5 capability: ``block_index`` works with
``auto_generate_huffman_table`` (the TICX trailer is payload-relative
in both layouts, container.py), and the device entropy chain accepts
the stream's parsed canonical tables as RUNTIME tensors
(ops/entropy_decode.py ``tables=``), so auto-table streams reach the
same 980 MP/s decode path as standard ones.  The admission gate
(:func:`canonical_tables`) falls back to the host bit-cursor for
anything the device layout cannot represent: >16-bit codes,
non-canonical code sets, extended-range symbols (DC category > 11 /
AC size > 10 -- the same bound as the device ENCODER,
huffman.HuffmanSpec.extended).

Reference parity bar: the reference's own dynamic-table path is broken
on its decoder (flag endianness, SURVEY quirk 2.5-1); ours must
round-trip bit-exactly through BOTH the host and device decoders.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tinyimgcodec_tpu import container, golden, native
from tinyimgcodec_tpu.engine import Engine
from tinyimgcodec_tpu.huffman import build_huffman_spec
from tinyimgcodec_tpu.ops import entropy_decode as ed

from conftest import synthetic_image


def _auto_stream(img, quality, **kw):
    return container.compress(
        img, quality, auto_generate_huffman_table=True, block_index=True,
        **kw,
    )


def _device_engine():
    return Engine("exact", device_entropy=True)


def test_auto_table_trailer_parses_and_host_roundtrips():
    img = synthetic_image(96, 120, seed=11)
    data = _auto_stream(img, 50, index_stride=16)
    _, _, _, flag = container.parse_header(data)
    assert flag & (1 << 31)  # FLAG_CUSTOM_TABLE
    nb = -(-96 // 8) * -(-120 // 8)
    idx = container.parse_block_index(data, nb)
    assert idx is not None and idx[1] == 16
    ref = container.decompress(
        container.compress(img, 50, auto_generate_huffman_table=True)
    )
    np.testing.assert_array_equal(container.decompress(data), ref)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_custom_table_device_decode_parity(quality):
    img = synthetic_image(128, 128, seed=quality)
    data = _auto_stream(img, quality, index_stride=16)
    prep = ed.prepare_batch([data])
    assert prep is not None and prep["tables"] is not None
    ref = container.decompress(data)
    out = _device_engine().decompress_batch([data])
    np.testing.assert_array_equal(np.asarray(out)[0], ref)


def test_custom_table_device_resume_escalation():
    # q=90 noise exhausts the content-adaptive first-pass budget rarely,
    # so force tiny stride + dense content to drive the continuation
    # machinery through the runtime-table chain as well
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (64, 64)).astype(np.uint8)
    data = _auto_stream(img, 90, index_stride=8)
    ref = container.decompress(data)
    out = _device_engine().decompress_batch([data])
    np.testing.assert_array_equal(np.asarray(out)[0], ref)


def test_custom_table_batch_uniform_tables_device():
    # identical image -> identical table: the batch shares one table
    # and decodes on device as a batch
    img = synthetic_image(64, 64, seed=5)
    data = _auto_stream(img, 50, index_stride=8)
    streams = [data, bytes(data)]
    prep = ed.prepare_batch(streams)
    assert prep is not None and prep["tables"] is not None
    ref = container.decompress(data)
    out = _device_engine().decompress_batch(streams)
    out = np.asarray(out)
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)


def test_mixed_tables_fall_back_correctly():
    # different content -> different tables: prepare_batch refuses (one
    # compiled table per batch) and the engine host path still decodes
    a = _auto_stream(synthetic_image(64, 64, seed=1), 50)
    b = _auto_stream(synthetic_image(64, 64, seed=9), 50)
    assert ed.prepare_batch([a, b]) is None
    out = _device_engine().decompress_batch([a, b])
    out = np.asarray(out)
    np.testing.assert_array_equal(out[0], container.decompress(a))
    np.testing.assert_array_equal(out[1], container.decompress(b))


def test_extended_range_table_rejected_cleanly():
    # the test_extended_tables fixture: DC cat >= 12 / AC size >= 11
    rng = np.random.RandomState(7)
    img = np.zeros((64, 64), np.uint8)
    for by in range(8):
        for bx in range(8):
            img[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = (
                255 if (by + bx) % 2 else 0
            )
    img[16:48, 16:48] = rng.randint(0, 256, (32, 32))
    spec = build_huffman_spec(golden.encode_arrays(img, 99))
    assert spec.extended  # fixture must exercise the range
    data = _auto_stream(img, 99)
    assert ed.prepare_batch([data]) is None
    ref = container.decompress(data)
    np.testing.assert_array_equal(_device_engine().decompress(data), ref)


def test_canonical_tables_admission():
    ok = {"DC": {0: "00", 1: "01", 2: "10"}, "AC": {(0, 0): "0"}}
    assert ed.canonical_tables(ok) is not None
    # canonical as a SET with permuted symbol assignment is decodable
    # (huffval follows code order); still admitted
    perm = {"DC": {0: "00", 2: "01", 1: "10"}, "AC": {(0, 0): "0"}}
    assert ed.canonical_tables(perm) is not None
    # non-canonical numbering (no code 00) is not
    bad = {"DC": {0: "01", 1: "11"}, "AC": {(0, 0): "0"}}
    assert ed.canonical_tables(bad) is None
    # >16-bit code
    long = {"DC": {0: "0" * 17, 1: "1"}, "AC": {(0, 0): "0"}}
    assert ed.canonical_tables(long) is None
    # extended-range symbols
    extdc = {"DC": {12: "0"}, "AC": {(0, 0): "0"}}
    assert ed.canonical_tables(extdc) is None
    extac = {"DC": {0: "0"}, "AC": {(0, 11): "0"}}
    assert ed.canonical_tables(extac) is None


@pytest.mark.skipif(not native.available(), reason="no C compiler")
def test_custom_table_indexed_host_decode_parity():
    # the C LUT decoder's index-parallel path with the stream's own
    # LUTs must match the pure-python bit cursor
    img = synthetic_image(128, 96, seed=4)
    data = _auto_stream(img, 50, index_stride=8)
    a_nat = container.decompress_to_arrays(data, use_native=True)
    a_py = container.decompress_to_arrays(data, use_native=False)
    np.testing.assert_array_equal(a_nat.dc, a_py.dc)
    np.testing.assert_array_equal(a_nat.ac, a_py.ac)


def test_sharded_decode_rejects_custom_tables():
    from tinyimgcodec_tpu.parallel.batch import decompress_batch_sharded

    img = synthetic_image(64, 64, seed=6)
    data = _auto_stream(img, 50, index_stride=8)
    assert decompress_batch_sharded([data, bytes(data)]) is None


def test_corrupt_custom_trailer_degrades_to_serial():
    # parse_block_index's off[-1] bound over-counts by the table-segment
    # bits on custom streams; an offset landing in that window must
    # still degrade to the serial cursor (prepare_batch/host indexed
    # path re-validate against the TRUE payload bit length)
    import struct

    from tinyimgcodec_tpu.bitstream import BitReader
    from tinyimgcodec_tpu.constants import HEADER_BYTES

    img = synthetic_image(64, 64, seed=12)
    data = bytearray(_auto_stream(img, 50, index_stride=8))
    ref = container.decompress(
        container.compress(img, 50, auto_generate_huffman_table=True)
    )
    nb = 64
    body_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    start = len(data) - 8 - body_len
    reader = BitReader(bytes(data))
    reader.seek(HEADER_BYTES * 8)
    container.read_huffman_table(reader)
    pay_bits_true = start * 8 - reader.tell()
    # last chunk offset -> inside the table-bits over-count window:
    # >= true payload bits but < parse_block_index's loose bound
    bogus = (start - HEADER_BYTES) * 8 - 1
    assert bogus >= pay_bits_true
    n_off = (body_len - 8) // 4
    struct.pack_into("<I", data, start + 8 + 4 * (n_off - 1), bogus)
    # loose structural parse still accepts it ...
    assert container.parse_block_index(bytes(data), nb) is not None
    # ... but the consumers reject and fall back to the serial cursor
    assert ed.prepare_batch([bytes(data)]) is None
    np.testing.assert_array_equal(container.decompress(bytes(data)), ref)
    np.testing.assert_array_equal(
        _device_engine().decompress(bytes(data)), ref
    )


def test_standard_path_unchanged_by_tables_arg():
    # tables=None must produce the exact standard-table program output
    img = synthetic_image(64, 64, seed=8)
    data = container.compress(img, 50, block_index=True, index_stride=8)
    prep = ed.prepare_batch([data])
    assert prep is not None and prep["tables"] is None
    a = container.decompress_to_arrays(data)
    zz, ok, _ = ed.entropy_decode_chunks(
        jnp.asarray(prep["words"]),
        jnp.asarray(prep["chunk_start"]),
        jnp.asarray(prep["chunk_blocks"]),
        jnp.asarray(prep["chunk_block_base"]),
        jnp.asarray(prep["chunk_end_lo"]),
        jnp.asarray(prep["chunk_end_hi"]),
        nb_total=prep["nb_total"], stride=prep["stride"],
    )
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(zz)[:, 0], a.dc)
    np.testing.assert_array_equal(np.asarray(zz)[:, 1:], a.ac)
