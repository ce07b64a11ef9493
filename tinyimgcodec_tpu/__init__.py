"""tinyimgcodec_tpu: a device-parallel grayscale JPEG-style codec framework.

A from-scratch JAX/XLA re-architecture of the capabilities of
clysto/tinyimgcodec: 8x8 block transform coding (DCT -> quantize -> zig-zag
-> DC DPCM) with JPEG Annex K Huffman entropy coding, designed for an
accelerator:

- the transform stage runs as batched 8x8 matmuls over device-resident
  block tensors;
- entropy coding (RLE, code/length gathers, bit packing) is vectorized on
  device via parallel prefix sums instead of per-block host loops;
- multi-device scale-out shards images and block-tiles over a
  ``jax.sharding.Mesh`` and stitches per-shard bitstream segments with
  collectives.

Public API (superset of the reference's ``encode, decode, compress,
decompress``, /root/reference/tinyimgcodec/__init__.py:1-5):

- ``compress(image, quality) -> bytes`` / ``decompress(bytes) -> image``:
  one-call codec; runs the JAX pipeline on the default JAX device (the GPU
  when there is one), or the host golden path with ``backend="host"``.
- ``encode(image, quality) -> CodecArrays`` / ``decode(CodecArrays) ->
  image``: array-level API (self-consistent, unlike the reference --
  SURVEY quirk 2.5-4).
"""

from __future__ import annotations

from .constants import (
    AC,
    DC,
    EOB,
    LUMINANCE_QUANTIZATION_TABLE,
    ZIGZAG_ORDER,
    ZRL,
)
from .golden import CodecArrays
from .golden import decode_arrays as decode
from .golden import encode_arrays as encode
from .api import compress, compress_batch, decompress, decompress_batch

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "compress",
    "compress_batch",
    "decompress",
    "decompress_batch",
    "CodecArrays",
    "LUMINANCE_QUANTIZATION_TABLE",
    "ZIGZAG_ORDER",
    "EOB",
    "ZRL",
    "DC",
    "AC",
    "__version__",
]
