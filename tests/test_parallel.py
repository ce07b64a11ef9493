"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from tests.conftest import synthetic_image
from tinyimgcodec_tpu import container
from tinyimgcodec_tpu.parallel import make_mesh
from tinyimgcodec_tpu.parallel.batch import compress_batch
from tinyimgcodec_tpu.parallel.tiled import encode_tiled


def _n_devices():
    import jax

    return len(jax.devices())


def test_mesh_has_8_virtual_devices():
    assert _n_devices() == 8


@pytest.mark.parametrize("n", [2, 8])
def test_tiled_encode_matches_single_device(n):
    img = synthetic_image(96, 128, seed=41)  # 192 blocks over n shards
    mesh = make_mesh(n)
    data = encode_tiled(img, 50, mesh=mesh)
    assert data == container.compress(img, 50)


def test_tiled_encode_device_assembly():
    img = synthetic_image(96, 128, seed=41)
    mesh = make_mesh(4)
    dev = encode_tiled(img, 50, mesh=mesh, assemble="device")
    host = container.compress(img, 50)
    # device assembly resolves exact ties by correct rounding; streams may
    # differ in rare coefficients but must decode to the same quality
    a = container.decompress(dev).astype(float)
    b = container.decompress(host).astype(float)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2.0
    assert abs(len(dev) - len(host)) <= 8


def test_tiled_nonmultiple_blocks():
    # 5x7=35 blocks over 8 shards -> padding exercised
    img = synthetic_image(40, 56, seed=42)
    data = encode_tiled(img, 50, mesh=make_mesh(8))
    assert data == container.compress(img, 50)


def test_tiled_quality_sweep():
    img = synthetic_image(64, 64, seed=43)
    for q in (10, 90):
        assert encode_tiled(img, q, mesh=make_mesh(8)) == container.compress(
            img, q
        )


def test_batch_compress_matches_single(small_image):
    imgs = np.stack(
        [synthetic_image(64, 80, seed=s) for s in range(6)]
    )  # 6 images over 8 devices -> padding exercised? (6 < 8: pad)
    out = compress_batch(imgs, 50, mesh=make_mesh(2))
    assert len(out) == 6
    for i in range(6):
        assert out[i] == container.compress(imgs[i], 50)


def test_batch_device_assembly_decodes():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in range(4)])
    out = compress_batch(imgs, 50, mesh=make_mesh(4), assemble="device")
    for i in range(4):
        dec = container.decompress(out[i])
        ref = container.decompress(container.compress(imgs[i], 50))
        assert np.abs(dec.astype(float) - ref.astype(float)).max() <= 2.0


def test_tiled_large_image():
    """BASELINE config 4 shape: a large image tiled across all devices
    (scaled down for the CPU mesh; the structure is identical at 4K+)."""
    img = synthetic_image(512, 1024, seed=44)  # 8192 blocks over 8 shards
    mesh = make_mesh(8)
    data = encode_tiled(img, 50, mesh=mesh)
    assert data == container.compress(img, 50)
    out = container.decompress(data)
    assert out.shape == (512, 1024)


def test_batch_sharded_matches_single_device():
    """The batch pipeline over 8 devices == over one device, per image:
    exact mode is deterministic across shardings, and byte-identical
    to the float64 reference encoder."""
    imgs = np.stack(
        [synthetic_image(64, 64, seed=s) for s in range(40, 56)]
    )  # 16 images over 8 devices -> 2 per shard
    sharded = compress_batch(imgs, 50, mesh=make_mesh(), precision="exact")
    single = compress_batch(imgs, 50, mesh=make_mesh(1), precision="exact")
    assert sharded == single
    assert sharded[0] == container.compress(imgs[0], 50)
    assert sharded[-1] == container.compress(imgs[-1], 50)
    assert container.decompress(sharded[3]).shape == (64, 64)


def test_batch_sharded_ragged_batch():
    """Batch not divisible by the mesh: padded shards, real images
    sliced back out."""
    imgs = np.stack(
        [synthetic_image(32, 32, seed=s) for s in range(90, 95)]
    )  # 5 images over 8 devices
    out = compress_batch(imgs, 50, mesh=make_mesh(), precision="exact")
    assert len(out) == 5
    for img, s in zip(imgs, out):
        assert s == container.compress(img, 50)
        assert container.decompress(s).shape == img.shape


def test_compress_stream_double_buffered():
    """Streaming ingest (parallel/stream.py): chunked double-buffered
    feed must produce exactly the per-batch pipeline's bytes, including
    a padded trailing partial chunk and an odd-shaped input."""
    from tinyimgcodec_tpu.parallel.stream import compress_stream

    imgs = np.stack([synthetic_image(64, 64, seed=70 + i) for i in range(7)])
    got = list(compress_stream(iter(imgs), quality=50, chunk=3))
    ref = compress_batch(imgs, 50, precision="fast", block_index=True)
    assert len(got) == 7
    assert got == ref

    # non-multiple-of-8 images are reflect-padded for the device but
    # the headers record TRUE dims (crop contract)
    odd = [synthetic_image(60, 52, seed=90 + i) for i in range(3)]
    got_odd = list(compress_stream(odd, quality=50, chunk=2))
    ref_odd = compress_batch(np.stack(odd), 50, precision="fast",
                             block_index=True)
    assert got_odd == ref_odd
    assert container.parse_header(got_odd[0])[:2] == (60, 52)

    # shape mismatch is rejected
    with pytest.raises(ValueError):
        list(compress_stream([imgs[0], synthetic_image(32, 32)], chunk=2))
