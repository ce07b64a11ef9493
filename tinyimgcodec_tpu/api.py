"""Top-level one-call codec API.

``compress``/``decompress`` mirror the reference's byte-level entry points
(reference codec.py:133-189) but run the JAX pipeline
(``tinyimgcodec_tpu.engine``) on the default JAX device.  The host golden
path runs only with ``backend="host"``, or under ``backend="auto"`` when
JAX itself cannot be imported.

All knobs are validated through :class:`tinyimgcodec_tpu.config.CodecConfig`
at this boundary (the reference silently NaNs at quality=100, SURVEY quirk
2.5-6; here it raises).
"""

from __future__ import annotations

import importlib.util

import numpy as np

from . import container
from .config import CodecConfig

_ENGINES: dict = {}


def _get_engine(precision: str = "exact"):
    """Lazily construct the JAX pipeline engine (imports jax on demand).

    Returns None only when ``jax`` is not installed; any other failure
    to build the engine (a broken accelerator setup, say) raises, so it
    never degrades into the ~1500x slower host path unnoticed.
    """
    if precision not in _ENGINES:
        if importlib.util.find_spec("jax") is None:
            return None
        from .engine import Engine

        _ENGINES[precision] = Engine(precision)
    return _ENGINES[precision]


def _engine_unavailable_error() -> RuntimeError:
    return RuntimeError("backend='jax' requested but jax is not installed")


def compress(
    image: np.ndarray,
    quality: int = 50,
    auto_generate_huffman_table: bool = False,
    backend: str = "auto",
    precision: str = "exact",
    block_index: bool | None = None,
    index_stride: int = 64,
    config: CodecConfig | None = None,
) -> bytes:
    """Grayscale image (H, W) -> compressed bytes.

    backend: "auto" (JAX when installed), "jax", or "host".
    precision: "exact" (byte-identical to the float64 reference) or
    "fast" (f32 transform; rare rounding ties may differ).
    block_index: append the TICX block-offset trailer so decoders can
    entropy-decode chunks in parallel.  Default ON (None resolves per
    CodecConfig) for both table kinds: the payload stays byte-identical
    to the reference encoder's and reference decoders ignore the
    trailer, at ~1.3% size cost (docs/FORMAT.md); pass
    ``block_index=False`` for trailer-free bytes.
    config: a validated CodecConfig; overrides the loose kwargs.
    """
    if config is None:
        config = CodecConfig(
            quality=quality,
            precision=precision,
            auto_huffman_table=auto_generate_huffman_table,
            block_index=block_index,
            index_stride=index_stride,
        )
    if backend not in ("auto", "jax", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError("expected a 2-D grayscale image")
    if backend in ("auto", "jax"):
        engine = _get_engine(config.precision)
        if engine is not None:
            return engine.compress(
                image, config.quality,
                auto_table=config.auto_huffman_table,
                block_index=config.block_index,
                index_stride=config.index_stride,
            )
        if backend == "jax":
            raise _engine_unavailable_error()
    return container.compress(
        image, config.quality, config.auto_huffman_table,
        block_index=config.block_index, index_stride=config.index_stride,
    )


def compress_batch(
    images,
    quality: int = 50,
    backend: str = "auto",
    precision: str = "exact",
    block_index: bool | None = None,
    index_stride: int = 64,
) -> list[bytes]:
    """(B, H, W) same-shaped grayscale images -> list of compressed bytes.

    The batch entry point of the public API: one device dispatch for the
    whole batch through the XLA batch pipeline
    (:func:`tinyimgcodec_tpu.parallel.batch.compress_batch` over every
    local device).  ``images`` may be a numpy array or a ``jax.Array``.
    precision="exact" is byte-identical to the float64 reference.
    """
    config = CodecConfig(
        quality=quality, precision=precision, block_index=block_index,
        index_stride=index_stride,
    )
    if backend not in ("auto", "jax", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "host" and _get_engine(config.precision) is not None:
        from .parallel.batch import compress_batch as xla_batch

        return xla_batch(
            np.asarray(images), quality=config.quality,
            precision=config.precision, block_index=config.block_index,
            index_stride=config.index_stride,
        )
    if backend == "jax":
        raise _engine_unavailable_error()
    return [
        container.compress(
            im, config.quality, block_index=config.block_index,
            index_stride=config.index_stride,
        )
        for im in np.asarray(images)
    ]


def decompress(data: bytes, backend: str = "auto",
               precision: str = "exact") -> np.ndarray:
    """Compressed bytes -> uint8 image (H, W)."""
    if backend not in ("auto", "jax", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "jax"):
        engine = _get_engine(precision)
        if engine is not None:
            return engine.decompress(data)
        if backend == "jax":
            raise _engine_unavailable_error()
    return container.decompress(data)


def decompress_batch(
    streams: list[bytes], backend: str = "auto", precision: str = "exact"
):
    """Compressed streams -> decoded uint8 images.

    The batch decode entry point: off the CPU, TICX-indexed batches
    (standard tables, or uniform standard-range dynamic tables)
    entropy-decode fully ON DEVICE (chunk-parallel,
    ops/entropy_decode.py); otherwise entropy decode runs
    thread-parallel through the native C LUT decoder and ONE batched
    device program runs the transform half.  Uniform batches
    return a stacked ``(B, H, W)`` array; mixed shapes/qualities are
    grouped into uniform runs and a list of (H, W) arrays comes back
    in input order.
    """
    if backend not in ("auto", "jax", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "jax"):
        engine = _get_engine(precision)
        if engine is not None:
            return engine.decompress_batch(streams)
        if backend == "jax":
            raise _engine_unavailable_error()
    out = [container.decompress(s) for s in streams]
    if len({o.shape for o in out}) > 1:
        return out  # mixed shapes: list, same contract as the engine
    return np.stack(out)
