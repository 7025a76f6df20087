"""Serializable container for JPEG-pipeline encodes.

The reference can never persist an encode: its per-block Huffman trees are
rebuilt in memory and shared between its encoder and decoder halves, and no
code table is ever written (SURVEY.md §2.2.8).  The framework's shared-
codebook entropy mode is serializable by construction — this module defines
the wire format:

    Container := magic:u32le ("TJPG") version:u8 quality:u8
                 height:u32le width:u32le checksum:u16le     (v2)
                 Channel["lum"] Channel["r"] Channel["b"]
    Channel   := codebook_len:u32le codebook (see CanonicalCodebook)
                 nbits:u32le packed_len:u32le packed bytes

The header's third byte carries the quality setting (0 = the reference's
fixed tables); decode rebuilds the quant tables from it.  Block boundaries
are recovered from the RLE counts (each block's pair counts sum to its
coefficient count).

``checksum`` (v2) is CRC32 of the header's first 14 bytes plus everything
after the checksum field, folded into [1, 0xFFFF] — so a flipped height,
codebook bit or payload byte raises the typed error instead of silently
reconstructing a wrong image (the mutation-fuzz guarantee,
tests/test_robustness.py).  v1 containers (no checksum) still decode.
"""

from __future__ import annotations

import struct
from typing import TYPE_CHECKING

import numpy as np

from lz4jpeg_tpu.ops.huffman import CanonicalCodebook

if TYPE_CHECKING:
    from lz4jpeg_tpu.models.jpeg import JPEGEncoded

MAGIC = 0x47504A54  # "TJPG"
VERSION = 2


class JPEGContainerError(ValueError):
    pass


def _container_checksum16(data: bytes) -> int:
    """Checksum over the container with the checksum field excluded."""
    from lz4jpeg_tpu.formats.fast_frame import content_checksum16

    import zlib

    return (
        content_checksum16(data[16:], zlib.crc32(data[:14]))
    )


def pack_container(enc: "JPEGEncoded") -> bytes:
    if enc.entropy_mode != "shared":
        raise JPEGContainerError(
            "only shared-codebook encodes are serializable; re-encode with "
            'entropy="shared" (per-block trees are in-memory parity '
            "artifacts, like the reference)"
        )
    out = bytearray()
    quality = getattr(enc, "quality", None) or 0
    out += struct.pack(
        "<IBBII", MAGIC, VERSION, quality, enc.height, enc.width
    )
    out += b"\x00\x00"  # checksum backfilled below
    for c in ("lum", "r", "b"):
        codebook, packed, nbits = enc.shared_streams[c]
        blob = codebook.serialize()
        out += struct.pack("<I", len(blob))
        out += blob
        out += struct.pack("<II", nbits, len(packed))
        out += packed
    struct.pack_into("<H", out, 14, _container_checksum16(bytes(out)))
    return bytes(out)


def unpack_container(data: bytes) -> "JPEGEncoded":
    from lz4jpeg_tpu.models.jpeg import _CHANNEL_SHAPES, JPEGEncoded, _split_symbols
    from lz4jpeg_tpu.native import native_available, native_backend
    from lz4jpeg_tpu.ops.huffman import unpack_symbols

    if len(data) < 14:
        raise JPEGContainerError("container too short")
    magic, version, quality, height, width = struct.unpack_from(
        "<IBBII", data, 0
    )
    if magic != MAGIC:
        raise JPEGContainerError("bad magic")
    if version not in (1, VERSION):
        raise JPEGContainerError(f"unsupported version {version}")
    if version >= 2:
        if len(data) < 16:
            raise JPEGContainerError("container too short")
        (checksum,) = struct.unpack_from("<H", data, 14)
        if checksum and _container_checksum16(data) != checksum:
            raise JPEGContainerError("container checksum mismatch")
        p = 16
    else:
        p = 14  # legacy v1: no checksum field
    bpc, bpr = -(-height // 8), -(-width // 8)
    num_blocks = bpc * bpr
    shared = {}
    rle = {}
    lengths = {}
    for c in ("lum", "r", "b"):
        try:
            (blob_len,) = struct.unpack_from("<I", data, p)
            p += 4
            codebook, _ = CanonicalCodebook.deserialize(data[p : p + blob_len])
            p += blob_len
            nbits, packed_len = struct.unpack_from("<II", data, p)
            p += 8
            packed = data[p : p + packed_len]
            if len(packed) != packed_len:
                raise JPEGContainerError(f"truncated stream for {c!r}")
            p += packed_len
            shared[c] = (codebook, packed, nbits)
        except JPEGContainerError:
            raise
        except (struct.error, ValueError, IndexError) as e:
            raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
    if p != len(data):
        raise JPEGContainerError("trailing bytes after container")

    # Decode the streams back to RLE.  Prefer the sparse-delta combined
    # layout (the interchange: h2d-ready for the folded-einsum
    # device inverse, one buffer, same bytes as packed16); a stream the
    # strict sparse walker rejects falls back to the packed-u16 pairs,
    # then to the int32 quirk-compatible path, keeping every channel in
    # one uniform layout.
    native = native_backend() if native_available() else None
    sparse16 = native is not None
    combined = None
    if sparse16:
        from lz4jpeg_tpu.ops.rle import CHANNEL_SLICES, COMBINED_LANES

        slices = CHANNEL_SLICES
        combined = np.zeros((num_blocks, COMBINED_LANES), np.uint16)
        for c in ("lum", "r", "b"):
            codebook, packed, nbits = shared[c]
            h, w = _CHANNEL_SHAPES[c]
            try:
                got = native.huff_unpack_sparse16(
                    packed, nbits, codebook, h * w, num_blocks,
                    out_sparse=combined, col_off=slices[c].start,
                )
            except ValueError as e:
                raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
            if got is None:
                sparse16 = False
                rle.clear()
                lengths.clear()
                combined = None
                break
            rle[c], lengths[c] = combined[:, slices[c]], got[1]
    if sparse16:
        return JPEGEncoded(
            quality=quality or None,
            height=height,
            width=width,
            blocks_per_col=bpc,
            blocks_per_row=bpr,
            rle=rle,
            rle_lengths={c: np.asarray(v) for c, v in lengths.items()},
            entropy_mode="shared",
            rle_sparse16=True,
            rle_combined=combined,
            shared_streams=shared,
        )
    packed16 = native is not None
    if packed16:
        for c in ("lum", "r", "b"):
            codebook, packed, nbits = shared[c]
            h, w = _CHANNEL_SHAPES[c]
            try:
                got = native.huff_unpack_pairs16(
                    packed, nbits, codebook, h * w, num_blocks, h * w
                )
            except ValueError as e:
                raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
            if got is None:
                packed16 = False
                rle.clear()
                lengths.clear()
                break
            rle[c], lengths[c] = got
    if not packed16:
        for c in ("lum", "r", "b"):
            codebook, packed, nbits = shared[c]
            h, w = _CHANNEL_SHAPES[c]
            try:
                got = (
                    native.huff_unpack_pairs(
                        packed, nbits, codebook, h * w, num_blocks, 2 * h * w
                    )
                    if native is not None
                    else None
                )
                if got is None:
                    symbols = unpack_symbols(packed, nbits, codebook)
                    got = _split_symbols(
                        symbols, num_blocks, 2 * h * w, h * w
                    )
            except (ValueError, IndexError, RuntimeError) as e:
                raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
            rle[c], lengths[c] = got
    return JPEGEncoded(
        quality=quality or None,
        height=height,
        width=width,
        blocks_per_col=bpc,
        blocks_per_row=bpr,
        rle={c: np.asarray(v) for c, v in rle.items()},
        rle_lengths={c: np.asarray(v) for c, v in lengths.items()},
        entropy_mode="shared",
        rle_packed16=packed16,
        shared_streams=shared,
    )


def is_jpeg_container(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data, 0)[0] == MAGIC
