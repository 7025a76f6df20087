"""lz4jpeg_tpu — a JAX codec framework for the accelerator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference C
project ``CyrilMorel42/LZ4-JPEG``: an LZ4-style lossless block codec and a
JPEG-style lossy image pipeline, plus the LZW encoder, experiment harness,
logging/trace utilities and random-input generators the reference ships.

Layout (mirrors SURVEY.md §7's layer map):

- ``oracle/``   — exact NumPy/Python transcriptions of the reference semantics;
                  the ground truth every device kernel is verified against.
- ``formats/``  — container/bitstream formats (LZ4 frame pack/unpack).
- ``ops/``      — batched device ops (DCT, quantize, zigzag, RLE, Huffman,
                  match finding) as XLA-fused jnp formulations, plus the
                  fused forward kernel (``ops/pallas_fwd.py``).
- ``models/``   — codec pipelines (LZ4, JPEG, LZW) composing the ops.
- ``parallel/`` — device mesh, shard_map data parallelism, ordered gather,
                  multi-host utilities.
- ``utils/``    — host I/O (PNG, files, hexdump), config, logging, stats,
                  random-input generators.
- ``bench/``    — benchmark harness mirroring the reference's methodology.
- ``native/``   — C++ host-side runtime (frame serializer, parity match
                  finder) loaded via ctypes.
"""

__version__ = "0.1.0"

from lz4jpeg_tpu.config import LZ4Config, JPEGConfig  # noqa: F401

from lz4jpeg_tpu.models import JPEGPipeline  # noqa: F401
from lz4jpeg_tpu.models.lz4 import LZ4Codec  # noqa: F401
