"""Multi-chip scale-out: mesh sharding, collectives, bitstream stitching.

The reference has no parallelism at all (SURVEY 2.4); this package is the
device-parallel replacement demanded by BASELINE.json:

- :mod:`.mesh` -- device mesh construction + multi-host init helpers.
- :mod:`.batch` -- data-parallel corpus encode (images sharded over the
  mesh's batch axis).
- :mod:`.tiled` -- block-tile sharding of one large image across devices,
  with cross-shard DC DPCM via ``ppermute`` and bitstream assembly via
  all-gather of per-shard segment lengths -> prefix offsets -> segment
  stitch (XLA collectives; NCCL over NVLink on GPUs).
"""

from .mesh import make_mesh  # noqa: F401
