"""The LZ4-style block codec.

Pipeline (SURVEY.md §7 steps 3-4):

1. split input into independent fixed-size blocks (``divide_input``,
   LZ4.c:123-177) — the data-parallel axis;
2. per-block match tables + greedy parse on the device (``ops/match.py``), batched
   over all blocks at once — the reference's O(n²·L) per-position scan
   (LZ4.c:290-323) becomes one vectorized compare/scan pass per block batch;
3. host-side frame serialization (``formats/lz4_frame.py``), byte-identical
   to the reference writer.

Encoding in ``parity`` mode is bit-exact with the committed golden
``compressed.bin`` (tested); the native C++ backend (``native/``) provides
the same parse on the host for I/O-bound paths, and ``fast`` mode (64 KiB
blocks, hash-chain matcher) rides the same frame layer.

Decode unpacks the frame robustly (see ``formats``) and reconstructs with
the LZ77 copy-back.  Parity-frame framing is a serial scan over block sizes
exactly like the reference (LZ4.c:1065-1108); the fast (LZ4T) frame keeps
its size table up front so framing is a prefix sum and match resolution
runs block-parallel on the device (``ops/lz4t_decode.py``,
``parallel/lz4.py::sharded_fast_decode``) — pass ``engine="device"``.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import numpy as np

from lz4jpeg_tpu.config import LZ4Config
from lz4jpeg_tpu.formats import (
    Block,
    Sequence,
    decode_frame_bytes,
    pack_frame,
)
from lz4jpeg_tpu.ops.match import greedy_parse, match_tables, pad_blocks


@functools.lru_cache(maxsize=None)
def _device_fast_encode(lcp_words: int = 4):
    """Jitted sort matcher + compactor (``ops/lz4_fast.py``), cached at
    module scope so repeated ``encode(engine="device")`` calls reuse the
    compilation (jit caches by shape under one callable; a per-call
    ``@jax.jit`` would retrace every time).  ``lcp_words`` is
    ``LZ4Config.match_lcp_words``."""
    from lz4jpeg_tpu.ops.lz4_fast import compact_parse, fast_match_blocks

    return jax.jit(
        lambda b, l: compact_parse(
            *fast_match_blocks(b, l, lcp_words=lcp_words)
        )
    )


class LZ4Codec:
    """Block LZ4 codec with device-batched match finding."""

    def __init__(self, config: LZ4Config = LZ4Config(), batch_blocks: int = 256):
        self.config = config
        # Blocks processed per device dispatch: bounds the (B, P, P) match
        # table memory (B·P²·4 bytes).
        self.batch_blocks = batch_blocks

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    def encode(self, data: bytes, engine: str = "auto") -> bytes:
        """Compress ``data``.

        ``engine`` (fast mode only): ``"device"`` runs the hash-bucket
        matcher on the accelerator (``ops/lz4_fast.py``), ``"native"`` the C++
        host encoder, ``"python"`` the executable spec; ``"auto"`` prefers
        native and falls back to python.  All engines produce valid LZ4T
        frames decodable by every decoder (match choices may differ).
        """
        if self.config.mode == "parity":
            return self._log_encode(data, self._encode_parity(data))
        if engine == "device":
            return self._log_encode(data, self._encode_fast_device(data))
        from lz4jpeg_tpu.native import native_available, native_backend

        if engine == "native" or (engine == "auto" and native_available()):
            return self._log_encode(data, native_backend().encode_fast(data))
        from lz4jpeg_tpu.formats.fast_frame import encode_fast

        return self._log_encode(data, encode_fast(data))

    def _log_encode(self, data: bytes, frame: bytes) -> bytes:
        """Append an encode record to the configured log — the role of the
        reference's ``encoding_log.txt`` + ``print_frame_details``
        (LZ4.c:24,683 opens the log per encode; :220-287 are the printers).
        Full per-sequence structure is logged for parity frames (bounded at
        ≤255 blocks by the format); fast frames get the block-size summary.
        """
        if self.config.log_path is None:
            return frame
        from lz4jpeg_tpu.formats.lz4_frame import describe_frame
        from lz4jpeg_tpu.utils.io import EncodingLog

        log = EncodingLog(self.config.log_path)
        log.write(
            f"encode mode={self.config.mode} in={len(data)}B "
            f"out={len(frame)}B ratio={len(frame)/max(len(data),1):.4f}"
        )
        detail = describe_frame(frame).splitlines()
        if len(detail) > 1024:  # keep multi-GB encodes from exploding the log
            detail = detail[:1024] + [f"... ({len(detail) - 1024} more lines)"]
        log.write("\n".join(detail))
        return frame

    def _encode_fast_device(self, data: bytes) -> bytes:
        """Fast-mode encode with device match finding (SURVEY.md §7 step 9)."""
        from lz4jpeg_tpu.formats.fast_frame import assemble_frame
        from lz4jpeg_tpu.ops.lz4_fast import DEVICE_BLOCK_LOG

        payloads, raws = self._device_chunk_payloads(data)
        return assemble_frame(payloads, raws, len(data), DEVICE_BLOCK_LOG)

    def _device_chunk_payloads(self, data: bytes):
        """Device match + host emission for one chunk of consecutive
        ``DEVICE_BLOCK_LOG`` blocks; returns ``(payloads, raws)`` lists
        ready for frame assembly — shared by ``encode()`` and the streaming
        ``encode_file(engine="device")`` path.

        Blocks go up as uint8 (4× fewer bytes than int32), and only the
        device-compacted match records come back — ``max(counts)``
        (pos, len·dist) int32 pairs per block instead of the 12·P-byte
        dense parse fields.
        """
        import jax.numpy as jnp

        from lz4jpeg_tpu.formats.fast_frame import emit_block_from_parse
        from lz4jpeg_tpu.native import native_available, native_backend
        from lz4jpeg_tpu.ops.lz4_fast import DEVICE_BLOCK_LOG, pad_blocks_fast

        padded, lengths = pad_blocks_fast(data, DEVICE_BLOCK_LOG)
        num_blocks, p = padded.shape
        pos_bits = (p - 1).bit_length()

        data_u8 = padded.astype(np.uint8)
        pos_sorted, packed, counts = _device_fast_encode(
            self.config.match_lcp_words
        )(
            jnp.asarray(data_u8), jnp.asarray(lengths)
        )
        max_count = int(jnp.max(counts))
        k = 1 << max(1, (max_count - 1).bit_length())  # pow2 → few slice shapes
        k = min(k, p)
        pos_h, packed_h, counts_h = jax.device_get(
            (pos_sorted[:, :k], packed[:, :k], counts)
        )

        # Re-densify on host (vectorized scatter, cheap) for the emitters.
        is_match = np.zeros((num_blocks, p), np.uint8)
        emit_len = np.zeros((num_blocks, p), np.int32)
        emit_dist = np.zeros((num_blocks, p), np.int32)
        slot = np.arange(k)[None, :] < counts_h[:, None]
        rows = np.broadcast_to(np.arange(num_blocks)[:, None], (num_blocks, k))
        r, c = rows[slot], pos_h[slot]
        is_match[r, c] = 1
        emit_len[r, c] = packed_h[slot] >> pos_bits
        emit_dist[r, c] = packed_h[slot] & (p - 1)

        raws = [
            data_u8[bi, : int(lengths[bi])].tobytes()
            for bi in range(num_blocks)
        ]
        if native_available():
            # All blocks in one native call — a per-block ctypes loop is
            # the host-side wall for multi-GB inputs.
            payloads = native_backend().emit_blocks(
                data_u8, lengths, is_match, emit_len, emit_dist
            )
        else:
            payloads = [
                emit_block_from_parse(
                    raws[bi],
                    is_match[bi, : int(lengths[bi])],
                    emit_len[bi, : int(lengths[bi])],
                    emit_dist[bi, : int(lengths[bi])],
                )
                for bi in range(num_blocks)
            ]
        return payloads, raws

    def _encode_parity(self, data: bytes) -> bytes:
        block_length = self.config.block_length
        if len(data) < block_length:
            raise ValueError("default block length is too high for this input")
        padded, lengths = pad_blocks(data, block_length)
        blocks: List[Block] = []
        for start in range(0, padded.shape[0], self.batch_blocks):
            chunk = padded[start : start + self.batch_blocks]
            best_len, best_dist = match_tables(
                chunk, max_match=self.config.max_match_length
            )
            is_match, emit_len, emit_dist = jax.device_get(
                greedy_parse(best_len, best_dist)
            )
            for bi in range(chunk.shape[0]):
                n = int(lengths[start + bi])
                block_bytes = bytes(
                    np.asarray(chunk[bi, :n], np.int32).astype(np.uint8)
                )
                blocks.append(
                    _build_sequences(
                        block_bytes,
                        np.asarray(is_match[bi]),
                        np.asarray(emit_len[bi]),
                        np.asarray(emit_dist[bi]),
                        n,
                    )
                )
        return pack_frame(blocks)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def encode_file(
        self,
        input_path: str,
        output_path: str,
        chunk_blocks: int = 1024,
        engine: str = "auto",
    ) -> int:
        """Stream-encode a file of arbitrary size into one LZ4T frame.

        Reads ``chunk_blocks`` blocks at a time, so memory stays O(chunk)
        for inputs far beyond RAM; the size table (and content checksum)
        are backfilled after the payloads (the format keeps them up front
        for parallel decode framing).  Returns compressed size.  Fast mode
        only — the parity format caps inputs at 255 blocks by construction.

        Engines (the same fast engines as ``encode``, at chunk
        granularity): ``"native"`` compresses each whole chunk in one C++
        call (``lz4t_encode_chunk``); ``"device"`` runs the device matcher
        per chunk (16 KiB blocks); ``"python"`` is the spec loop;
        ``"auto"`` prefers native.
        """
        import os
        import struct
        import zlib

        from lz4jpeg_tpu.formats.fast_frame import (
            DEFAULT_BLOCK_LOG,
            MAGIC,
            RAW_FLAG,
            VERSION,
            compress_block,
            fold_checksum16,
        )
        from lz4jpeg_tpu.native import native_available, native_backend

        if self.config.mode != "fast":
            raise ValueError("encode_file requires fast mode")
        native = (
            native_backend()
            if engine in ("auto", "native") and native_available()
            else None
        )
        if engine == "native" and native is None:
            raise RuntimeError("native engine requested but not built")
        if engine == "device":
            from lz4jpeg_tpu.ops.lz4_fast import DEVICE_BLOCK_LOG

            block_log = DEVICE_BLOCK_LOG
        else:
            block_log = DEFAULT_BLOCK_LOG
        block_size = 1 << block_log
        total = os.path.getsize(input_path)
        block_count = -(-total // block_size) if total else 0
        sizes: List[int] = []
        crc = 0
        with open(input_path, "rb") as src, open(output_path, "wb") as dst:
            dst.write(
                struct.pack(
                    "<IBBHQI", MAGIC, VERSION, block_log, 0,
                    total, block_count,
                )
            )
            dst.write(b"\x00" * (4 * block_count))  # size table backfilled
            while True:
                chunk = src.read(block_size * chunk_blocks)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                if engine == "device":
                    payloads, raws = self._device_chunk_payloads(chunk)
                    for payload, raw in zip(payloads, raws):
                        if payload is None or len(payload) >= len(raw):
                            sizes.append(len(raw) | RAW_FLAG)
                            dst.write(raw)
                        else:
                            sizes.append(len(payload))
                            dst.write(payload)
                elif native is not None:
                    body, recs = native.encode_chunk(chunk, block_log)
                    sizes.extend(int(r) for r in recs)
                    dst.write(body)
                else:
                    for start in range(0, len(chunk), block_size):
                        raw = chunk[start : start + block_size]
                        payload = compress_block(raw)
                        if len(payload) >= len(raw):
                            sizes.append(len(raw) | RAW_FLAG)
                            dst.write(raw)
                        else:
                            sizes.append(len(payload))
                            dst.write(payload)
            dst.seek(6)
            dst.write(struct.pack("<H", fold_checksum16(crc) if total else 0))
            dst.seek(20)
            dst.write(struct.pack(f"<{len(sizes)}I", *sizes))
        return os.path.getsize(output_path)

    def decode_file(
        self, input_path: str, output_path: str, chunk_blocks: int = 1024
    ) -> int:
        """Stream-decode an LZ4T file; returns raw size.

        Decodes ``chunk_blocks`` blocks per native call
        (``lz4t_decode_chunk`` — no per-block sub-frame wrapping) and
        verifies the frame's content checksum incrementally.
        """
        import struct
        import zlib

        from lz4jpeg_tpu.formats.fast_frame import (
            FastFormatError,
            MAGIC,
            RAW_FLAG,
            VERSION,
            decompress_block,
            fold_checksum16,
        )
        from lz4jpeg_tpu.native import native_available, native_backend

        native = native_backend() if native_available() else None

        with open(input_path, "rb") as src:
            header = src.read(20)
            if len(header) < 20:
                raise FastFormatError("frame too short")
            magic, version, block_log, checksum, raw_size, block_count = (
                struct.unpack("<IBBHQI", header)
            )
            if magic != MAGIC:
                raise FastFormatError("bad magic")
            if version != VERSION:
                raise FastFormatError(f"unsupported version {version}")
            table = src.read(4 * block_count)
            if len(table) < 4 * block_count:
                raise FastFormatError("truncated size table")
            sizes = struct.unpack(f"<{block_count}I", table)
            block_size = 1 << block_log
            written = 0
            crc = 0
            with open(output_path, "wb") as dst:
                for group in range(0, block_count, chunk_blocks):
                    recs = sizes[group : group + chunk_blocks]
                    payload_len = sum(
                        (r & ~RAW_FLAG) if r & RAW_FLAG else r for r in recs
                    )
                    payloads = src.read(payload_len)
                    if len(payloads) != payload_len:
                        raise FastFormatError("truncated payloads")
                    raw_total = min(
                        block_size * len(recs), raw_size - written
                    )
                    if raw_total < 0:
                        raise FastFormatError("block count exceeds raw size")
                    if native is not None:
                        try:
                            data = native.decode_chunk(
                                payloads, recs, block_log, raw_total
                            )
                        except RuntimeError as e:
                            raise FastFormatError(str(e)) from e
                    else:
                        parts = []
                        p = 0
                        done = written
                        for i, rec in enumerate(recs):
                            expected = min(block_size, raw_size - done)
                            if rec & RAW_FLAG:
                                length = rec & ~RAW_FLAG
                                part = payloads[p : p + length]
                                if len(part) != expected:
                                    raise FastFormatError(
                                        f"raw block {group + i} truncated"
                                    )
                            else:
                                length = rec
                                part = decompress_block(
                                    payloads[p : p + rec], expected
                                )
                            parts.append(part)
                            p += length
                            done += expected
                        data = b"".join(parts)
                    crc = zlib.crc32(data, crc)
                    dst.write(data)
                    written += len(data)
                if src.read(1):
                    raise FastFormatError("trailing garbage after frame")
            if written != raw_size:
                raise FastFormatError("frame size mismatch")
            if checksum and fold_checksum16(crc) != checksum:
                raise FastFormatError("content checksum mismatch")
        return written

    def decode(self, compressed: bytes, engine: str = "auto") -> bytes:
        """Decompress a parity or LZ4T frame (format auto-detected).

        ``engine="device"`` resolves all match chains on the accelerator —
        a batched copy resolve per block for LZ4T frames
        (``ops/lz4t_decode.py``), the global-buffer variant for parity
        frames (``ops/lz4_decode.py``).  ``"native"`` forces the C++
        decoder, ``"python"`` the executable spec; ``"auto"`` decodes on
        the host (native C++ when built, Python spec otherwise)."""
        from lz4jpeg_tpu.formats.fast_frame import is_fast_frame

        if is_fast_frame(compressed):
            import struct

            from lz4jpeg_tpu.formats.fast_frame import decode_fast
            from lz4jpeg_tpu.native import native_available, native_backend

            if engine == "device":
                from lz4jpeg_tpu.ops.lz4t_decode import decode_fast_device

                return decode_fast_device(compressed)
            if engine == "native" or (engine == "auto" and native_available()):
                (raw_size,) = struct.unpack_from("<Q", compressed, 8)
                return native_backend().decode_fast(compressed, raw_size)
            return decode_fast(compressed)
        if engine == "device":
            from lz4jpeg_tpu.ops.lz4_decode import decode_frame_device

            return decode_frame_device(compressed)
        return decode_frame_bytes(compressed)

    def roundtrip(self, data: bytes) -> bytes:
        return self.decode(self.encode(data))


def _build_sequences(
    block: bytes,
    is_match: np.ndarray,
    emit_len: np.ndarray,
    emit_dist: np.ndarray,
    n: int,
) -> Block:
    """Parse flags → Sequence list (mirrors block_encode's emission,
    LZ4.c:516-613): each match closes the pending literal run; a trailing
    literal run becomes an offset-0 sequence."""
    seqs: List[Sequence] = []
    match_positions = np.nonzero(is_match[:n])[0]
    prev_end = 0
    for k in match_positions:
        k = int(k)
        seqs.append(
            Sequence(
                literals=block[prev_end:k],
                match_offset=int(emit_dist[k]),
                match_length=int(emit_len[k]),
            )
        )
        prev_end = k + int(emit_len[k])
    if prev_end < n:
        seqs.append(Sequence(block[prev_end:n], 0, 0))
    return Block(seqs)
