"""Streaming ingest: double-buffered host->device encode feed.

The reference's C encoder streams 8-pixel-row bands through a FIFO so
output appears while input is still being read (c/encode.c:47-59).  The
device analog works at chunk-of-images granularity: while the device
encodes chunk i, chunk i+1 is already transferring host->device, so the
link and the device stay busy at the same time.  JAX dispatch is async --
``jax.device_put`` returns immediately and the blocking pull of chunk
i's compressed bytes is exactly the window chunk i+1's transfer hides
behind.

All chunks share one shape (the tail is padded with repeats and
trimmed), so a single compiled program serves the whole stream.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..ops import transform


def _chunked(images: Iterable[np.ndarray], n: int):
    """Yield lists of up to ``n`` same-shaped uint8 images.  They stay
    unpadded: the batch pipeline reflect-pads them to block multiples
    and records their TRUE dimensions in the headers (the reference's
    crop contract, codec.py:69, utils.py:56-61)."""
    buf: list[np.ndarray] = []
    shape: tuple[int, int] | None = None
    for im in images:
        im = np.ascontiguousarray(np.asarray(im), dtype=np.uint8)
        if shape is None:
            shape = im.shape
        elif im.shape != shape:
            raise ValueError(
                f"stream images must share one shape: {im.shape} "
                f"vs {shape}"
            )
        buf.append(im)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def compress_stream(
    images: Iterable[np.ndarray],
    quality: int = 50,
    chunk: int = 8,
    precision: str = transform.FAST,
    block_index: bool = True,
    index_stride: int = 64,
) -> Iterator[bytes]:
    """Encode an image stream, yielding compressed bytes per image.

    Keeps two chunks in flight (double buffering): the host->device
    transfer of the next chunk overlaps the device encode + result pull
    of the current one.  Each chunk runs the batch pipeline
    (:func:`parallel.batch.compress_batch`), so exact precision is
    byte-identical to the float64 oracle.  Images must share one
    (H, W); the trailing partial chunk is padded with repeats of its
    last image so every dispatch reuses the same compiled program, and
    the pads are never yielded.

    block_index (default on, like the other compress entries) appends
    the TICX trailer so streamed output feeds the chunk-parallel device
    decoder; reference decoders ignore it (docs/FORMAT.md).
    """
    from .batch import compress_batch, stage_images
    from .mesh import make_mesh

    mesh = make_mesh()

    def encode(batch: np.ndarray, staged, count: int) -> list[bytes]:
        out = compress_batch(
            batch, quality, mesh=mesh, precision=precision,
            staged=staged, block_index=block_index,
            index_stride=index_stride,
        )
        return out[:count]

    prev = None
    for batch in _chunked(images, chunk):
        count = len(batch)
        if count < chunk:
            batch = batch + [batch[-1]] * (chunk - count)
        batch = np.stack(batch)
        staged = stage_images(batch, mesh)  # async transfer
        if prev is not None:
            # device encodes the previous chunk while this transfer runs
            yield from encode(*prev)
        prev = (batch, staged, count)
    if prev is not None:
        yield from encode(*prev)


def decompress_stream(
    streams: "Iterable[bytes]",
    chunk: int = 8,
    precision: str = "exact",
) -> "Iterator[np.ndarray]":
    """Decode a stream of compressed images, yielding uint8 arrays.

    The decode dual of :func:`compress_stream` (the reference's C
    encoder streams row bands, c/encode.c:47-59; nothing streams on its
    decode side).  Streams are decoded in same-shaped chunks through
    ``Engine.decompress_batch`` -- off the CPU, TICX-indexed chunks run
    the chunk-parallel device entropy decoder -- and JAX's async
    dispatch overlaps chunk i+1's upload with chunk i's pull.  Shapes
    may vary across the stream: a shape change flushes the current
    chunk (each chunk must be uniform).
    """
    from ..engine import Engine

    eng = Engine(precision)

    def flush(buf: list[bytes]):
        if not buf:
            return
        if len(buf) == 1:
            yield eng.decompress(buf[0])
        else:
            yield from eng.decompress_batch(buf)

    from .. import container

    buf: list[bytes] = []
    key: tuple | None = None
    for data in streams:
        h, w, q, flag = container.parse_header(data)
        k = (h, w, q, flag)
        if key is not None and (k != key or len(buf) >= chunk):
            yield from flush(buf)
            buf = []
        key = k
        buf.append(data)
    yield from flush(buf)
