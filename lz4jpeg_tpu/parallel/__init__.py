"""Device-mesh data parallelism for the codec pipelines.

The reference's entire parallel repertoire is one Win32 thread per
block/MCU with lock-guarded shared structs and an index-addressed ordered
gather (``Algorithms/parallel/LZ4/LZ4.c:495-514, :742``;
``Algorithms/parallel/JPEG/JPEG.c:1297-1304``).  The device-mesh equivalent:

* a 1-D ``jax.sharding.Mesh`` over the visible devices, within a host
  (NVLink) or across hosts (``mesh.py``);
* the block/MCU batch axis sharded across devices under ``jit`` /
  ``shard_map`` — XLA partitions the batched kernels, no locks exist by
  construction (``jpeg.py``, ``lz4.py``);
* the ordered gather is an ``all_gather`` collective over the device axis
  (payloads keep their original block index), replacing the reference's
  ``frame_blocks[index] = *block`` under a critical section;
* shared tables (quant tables, codebooks) are replicated arrays — the
  broadcast the reference gets implicitly from process shared memory.
"""

from lz4jpeg_tpu.parallel.mesh import codec_mesh, pad_to_devices  # noqa: F401
from lz4jpeg_tpu.parallel.jpeg import (  # noqa: F401
    ShardedJPEGForward,
    ShardedSparseJPEG,
)
from lz4jpeg_tpu.parallel.lz4 import sharded_block_parse  # noqa: F401
