"""Configuration layer.

The reference has no config system — every knob is a compile-time ``#define``
(block length / file paths at ``Algorithms/sequential/LZ4/LZ4.c:20-28``, quant
tables at ``Algorithms/sequential/JPEG/JPEG.c:12-27``, image names hardcoded in
``main``).  Here the same knobs are first-class dataclasses, shared by the
codec pipelines, the benchmark harness and the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LZ4Config:
    """Knobs of the LZ4-style block codec.

    Defaults reproduce the reference constants
    (``Algorithms/sequential/LZ4/LZ4.c:20-23``).
    """

    block_length: int = 300          # DEFAULT_BLOCK_LENGTH
    min_match_length: int = 4        # MIN_MATCH_LENGTH
    max_match_length: int = 1024     # MAX_MATCH_LENGTH
    window_size: int = 65535         # WINDOW_SIZE
    # "parity" replicates every reference quirk bit-for-bit (uint8 length
    # truncation, signed-char decode, ≤255 blocks).  "fast" uses sane 64 KiB
    # blocks, a hash-chain matcher and a widened frame header.
    mode: str = "parity"
    # Append-mode encode log (the reference opens encoding_log.txt on every
    # encode, LZ4.c:24,683, and threads it to the frame/block/sequence
    # printers at :220-287).  None disables logging.
    log_path: Optional[str] = None
    # Suffix words carried through the device matcher's lcp verification
    # (ops/lz4_fast.py): 4 keeps the full-quality suffix, 1 and 2 carry
    # less per sort and so trade compression ratio for speed.
    match_lcp_words: int = 4

    def __post_init__(self):
        # The reference rejects this exact value (LZ4.c:672-677, :1040-1045).
        if self.block_length == 500:
            raise ValueError("block length cannot have the value 500")
        if self.mode not in ("parity", "fast"):
            raise ValueError(f"unknown LZ4 mode: {self.mode!r}")
        if self.match_lcp_words not in (1, 2, 4):
            raise ValueError(
                f"match_lcp_words must be 1, 2 or 4: {self.match_lcp_words}"
            )


@dataclasses.dataclass(frozen=True)
class JPEGConfig:
    """Knobs of the JPEG-style pipeline.

    The reference fixes 8×8 luma MCUs with 4:2:2 horizontal subsampling
    (chroma blocks are 8 rows × 4 cols) and truncating quantization
    (``Algorithms/sequential/JPEG/JPEG.c:496-550, :621-629``).
    """

    mcu_size: int = 8
    # "exact": float64 DCT matching the C double pipeline (CPU-verifiable).
    # "fast": float32 matmul DCT on the accelerator.
    precision: str = "fast"
    # Entropy stage: "per_block" rebuilds a Huffman tree per block per channel
    # like the reference (JPEG.c:1035-1097); "shared" builds one canonical
    # codebook per channel from global statistics and vector-encodes it.
    entropy: str = "shared"
    # None = the reference's fixed tables (JPEG.c:12-27), required for
    # parity.  1–100 scales them with the standard libjpeg quality curve
    # (a framework extension; the reference has no quality control).
    quality: Optional[int] = None

    def __post_init__(self):
        if self.precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision: {self.precision!r}")
        if self.entropy not in ("per_block", "shared"):
            raise ValueError(f"unknown entropy mode: {self.entropy!r}")
        if self.quality is not None and not 1 <= self.quality <= 100:
            raise ValueError(f"quality must be in [1, 100]: {self.quality}")

    @property
    def dtype(self):
        import jax.numpy as jnp

        return jnp.float64 if self.precision == "exact" else jnp.float32


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for data-parallel encode/decode.

    The reference's only parallelism is one Win32 thread per block/MCU on a
    shared-memory machine (``Algorithms/parallel/LZ4/LZ4.c:742``); here the
    block/MCU axis is sharded over a (hosts × devices) mesh and compressed
    payloads are gathered back in original order by index.
    """

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None = all visible devices
