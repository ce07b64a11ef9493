"""Crop-contract + public-API routing regressions.

The reference records TRUE image dims in the header and crops on decode
(reference codec.py:69, utils.py:56-61).  Every public entry point --
batch, stream and single-image -- must honor that contract, and every
encode runs the one XLA pipeline: there is no second (kernel) route.
"""

import inspect

import numpy as np
import pytest

from tests.conftest import synthetic_image
from tinyimgcodec_tpu import api, container
from tinyimgcodec_tpu.engine import Engine


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_batch_odd_shape_records_true_dims(precision):
    imgs = np.stack(
        [synthetic_image(60, 52, seed=s) for s in (11, 12)]
    )
    out = api.compress_batch(imgs, quality=50, precision=precision)
    for data, img in zip(out, imgs):
        h, w, q, _ = container.parse_header(data)
        assert (h, w) == (60, 52)
        dec = container.decompress(data)
        assert dec.shape == (60, 52)
        assert abs(float(dec.mean()) - float(img.mean())) < 8.0
    if precision == "exact":
        # byte-identical to the host/golden container path per image
        for data, img in zip(out, imgs):
            assert data == container.compress(img, 50, block_index=True)


def test_compress_stream_odd_shape_records_true_dims():
    from tinyimgcodec_tpu.parallel.stream import compress_stream

    imgs = [synthetic_image(60, 52, seed=s) for s in range(3)]
    out = list(compress_stream(iter(imgs), quality=50, chunk=2))
    assert len(out) == 3
    for data in out:
        h, w, _, _ = container.parse_header(data)
        assert (h, w) == (60, 52)
        assert container.decompress(data).shape == (60, 52)


def test_compress_stream_exact_matches_container():
    from tinyimgcodec_tpu.parallel.stream import compress_stream

    imgs = [synthetic_image(60, 52, seed=s) for s in range(2)]
    out = list(
        compress_stream(iter(imgs), quality=50, chunk=2, precision="exact")
    )
    for data, img in zip(out, imgs):
        # stream output carries the TICX trailer by default
        assert data == container.compress(img, 50, block_index=True)


@pytest.mark.parametrize("shape", [(64, 80), (60, 52), (72, 72)])
def test_engine_exact_bytes(shape):
    # 72x72 -> 81 blocks: any block count runs the same XLA program
    img = synthetic_image(*shape, seed=21)
    assert Engine("exact").compress(img, 50) == container.compress(
        img, 50, block_index=True
    )


def test_engine_has_no_kernel_route():
    """One encode path: the Engine takes no routing options, and the
    removed kernel pipeline cannot be imported."""
    params = list(inspect.signature(Engine).parameters)
    assert params == ["precision", "device_entropy"]
    eng = Engine("exact")
    assert not any("pallas" in name for name in dir(eng))
    with pytest.raises(ImportError):
        import tinyimgcodec_tpu.pallas_pipeline  # noqa: F401


@pytest.mark.parametrize("platform,expected", [("cpu", False), ("gpu", True)])
def test_engine_decode_default_by_platform(platform, expected, monkeypatch):
    """The entropy-decode route follows the default JAX platform: the
    host C LUT on the CPU, the device chain on the GPU."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert Engine("exact")._device_entropy is expected


@pytest.mark.parametrize("forced", [True, False])
def test_engine_decode_route_override(forced):
    eng = Engine("exact", device_entropy=forced)
    assert eng._device_entropy is forced
    img = synthetic_image(64, 64, seed=25)
    data = container.compress(img, 50, block_index=True)
    assert np.array_equal(eng.decompress(data), container.decompress(data))
    assert eng.host_fallbacks == 0


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_engine_block_index(precision):
    img = synthetic_image(64, 80, seed=23)
    eng = Engine(precision)
    data = eng.compress(img, 50, block_index=True)
    plain = eng.compress(img, 50, block_index=False)
    nb = (64 // 8) * (80 // 8)
    idx = container.parse_block_index(data, nb)
    assert idx is not None
    assert data[: len(plain)] == plain  # index is a pure trailer
    assert np.array_equal(
        container.decompress(data), container.decompress(plain)
    )
    if precision == "exact":
        assert plain == container.compress(img, 50)


def test_batch_exact_block_index_offsets():
    # the batch path emits the TICX trailer; offsets must equal the
    # host container's
    img = synthetic_image(64, 64, seed=24)
    out = api.compress_batch(img[None], quality=50, precision="exact")[0]
    ref = container.compress(img, 50, block_index=True)
    assert out == ref


def test_api_compress_batch_matches_container():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (31, 32)])
    out = api.compress_batch(imgs, quality=50, precision="exact")
    for data, img in zip(out, imgs):
        assert data == container.compress(img, 50, block_index=True)


def test_api_decompress_batch_roundtrip():
    imgs = np.stack([synthetic_image(60, 52, seed=s) for s in (41, 42)])
    streams = api.compress_batch(imgs, quality=50, precision="exact")
    out = api.decompress_batch(streams)
    ref = np.stack([container.decompress(s) for s in streams])
    assert out.shape == (2, 60, 52)
    assert np.array_equal(out, ref)
    host = api.decompress_batch(streams, backend="host")
    assert np.array_equal(host, ref)


def test_api_compress_batch_host_backend():
    imgs = np.stack([synthetic_image(24, 24, seed=s) for s in (33, 34)])
    out = api.compress_batch(imgs, quality=50, backend="host")
    for data, img in zip(out, imgs):
        assert data == container.compress(img, 50, block_index=True)


def test_decompress_stream_roundtrip_mixed_shapes():
    """decompress_stream: the decode dual of compress_stream -- chunks
    group by (shape, quality, flags), shape changes flush, output order
    matches input order, bytes decode to the oracle's pixels."""
    import numpy as np

    from tinyimgcodec_tpu import container
    from tinyimgcodec_tpu.parallel.stream import decompress_stream
    from conftest import synthetic_image

    imgs = [
        synthetic_image(64, 64, seed=1),
        synthetic_image(64, 64, seed=2),
        synthetic_image(48, 40, seed=3),   # shape change flushes
        synthetic_image(64, 64, seed=4),
        synthetic_image(64, 64, seed=5),
        synthetic_image(64, 64, seed=6),
    ]
    streams = [container.compress(im, quality=50) for im in imgs]
    streams[4] = container.compress(imgs[4], quality=75)  # quality flush
    out = list(decompress_stream(streams, chunk=2))
    assert len(out) == len(imgs)
    for s, dec in zip(streams, out):
        assert np.array_equal(dec, container.decompress(s))
