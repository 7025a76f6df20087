"""Native C++ host-side runtime, loaded via ctypes.

Provides host-grade implementations of the serial/host-bound parts of the
framework (the L0/L1 layers the reference wrote in C, SURVEY.md §1): the
LZ4 fast-mode encoder (hash-chain matcher over 64 KiB blocks), the frame
serializer/deserializer, and the LZ77 copy-back — keeping the accelerator
for the batched compute path.

Built with ``make -C lz4jpeg_tpu/native`` (plain g++, no dependencies).
``native_backend()`` raises a clear error if the shared library has not
been built; every native entry point has a pure-Python fallback elsewhere
in the package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "liblz4core.so")

_backend = None


class NativeBackend:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.lz4_encode_fast.restype = ctypes.c_ssize_t
        lib.lz4_encode_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4_decode_fast.restype = ctypes.c_ssize_t
        lib.lz4_decode_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4_encode_parity.restype = ctypes.c_ssize_t
        lib.lz4_encode_parity.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_size_t,
        ]
        lib.lz4t_emit_block.restype = ctypes.c_ssize_t
        lib.lz4t_emit_block.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4t_emit_blocks.restype = ctypes.c_int64
        lib.lz4t_emit_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.lz4t_encode_chunk.restype = ctypes.c_int64
        lib.lz4t_encode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.lz4t_decode_chunk.restype = ctypes.c_int64
        lib.lz4t_decode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4t_build_copy_program.restype = ctypes.c_int64
        lib.lz4t_build_copy_program.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.huff_unpack.restype = ctypes.c_ssize_t
        lib.huff_unpack.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.huff_pack.restype = ctypes.c_ssize_t
        lib.huff_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.huff_unpack_pairs.restype = ctypes.c_int64
        lib.huff_unpack_pairs.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rle_symbol_hist.restype = ctypes.c_int64
        lib.rle_symbol_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.huff_pack_pairs.restype = ctypes.c_int64
        lib.huff_pack_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        # packed-u16 RLE pair layout variants (ops/rle.py pack16)
        lib.rle_symbol_hist16.restype = ctypes.c_int64
        lib.rle_symbol_hist16.argtypes = lib.rle_symbol_hist.argtypes
        lib.huff_pack_pairs16.restype = ctypes.c_int64
        lib.huff_pack_pairs16.argtypes = lib.huff_pack_pairs.argtypes
        lib.huff_unpack_pairs16.restype = ctypes.c_int64
        lib.huff_unpack_pairs16.argtypes = lib.huff_unpack_pairs.argtypes
        # sparse-delta RLE layout variants (ops/rle.py sparse16): all take
        # (row stride, column offset) so they walk the combined (N, 128)
        # device buffer in place
        lib.rle_symbol_hist_sparse16.restype = ctypes.c_int64
        lib.rle_symbol_hist_sparse16.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.huff_pack_sparse16.restype = ctypes.c_int64
        lib.huff_pack_sparse16.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.huff_unpack_sparse16.restype = ctypes.c_int64
        lib.huff_unpack_sparse16.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.huff_per_block_ascii.restype = ctypes.c_int64
        lib.huff_per_block_ascii.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.lz4t_crc32.restype = ctypes.c_uint32
        lib.lz4t_crc32.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t,
        ]

    def encode_fast(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(len(data) + len(data) // 32 + 4096)
        n = self._lib.lz4_encode_fast(data, len(data), out, len(out))
        if n < 0:
            raise RuntimeError(f"native fast encode failed ({n})")
        return out.raw[:n]

    def decode_fast(self, data: bytes, max_out: int) -> bytes:
        out = ctypes.create_string_buffer(max_out)
        n = self._lib.lz4_decode_fast(data, len(data), out, len(out))
        if n < 0:
            raise RuntimeError(f"native fast decode failed ({n})")
        return out.raw[:n]

    def emit_block(
        self, data: bytes, is_match, emit_len, emit_dist
    ) -> bytes:
        """LZ4T payload from device parse arrays (numpy uint8/int32/int32)."""
        import numpy as np

        is_match = np.ascontiguousarray(is_match, np.uint8)
        emit_len = np.ascontiguousarray(emit_len, np.int32)
        emit_dist = np.ascontiguousarray(emit_dist, np.int32)
        out = ctypes.create_string_buffer(len(data) + len(data) // 128 + 64)
        n = self._lib.lz4t_emit_block(
            data, len(data),
            is_match.tobytes(),
            emit_len.ctypes.data, emit_dist.ctypes.data,
            out, len(out),
        )
        if n < 0:
            raise RuntimeError(f"native block emit failed ({n})")
        return out.raw[:n]

    def emit_blocks(self, data, lengths, is_match, emit_len, emit_dist):
        """Batched LZ4T payloads from (B, P) parse arrays — one native call.

        ``data`` is the padded (B, P) uint8 block matrix; ``lengths`` the
        valid prefix per row.  Returns a list of B payload ``bytes``.
        """
        import numpy as np

        data = np.ascontiguousarray(data, np.uint8)
        b, p = data.shape
        lengths = np.ascontiguousarray(lengths, np.int32)
        is_match = np.ascontiguousarray(is_match, np.uint8)
        emit_len = np.ascontiguousarray(emit_len, np.int32)
        emit_dist = np.ascontiguousarray(emit_dist, np.int32)
        cap = int(lengths.astype(np.int64).sum()) + b * (p // 128 + 64)
        out = ctypes.create_string_buffer(cap)
        sizes = np.zeros(b, np.int64)
        total = self._lib.lz4t_emit_blocks(
            data.ctypes.data_as(ctypes.c_char_p), b, p,
            lengths.ctypes.data,
            is_match.ctypes.data_as(ctypes.c_char_p),
            emit_len.ctypes.data, emit_dist.ctypes.data,
            out, cap, sizes.ctypes.data,
        )
        if total < 0:
            raise RuntimeError(f"native batched emit failed ({total})")
        buf = out.raw[:total]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        return [
            buf[offsets[i] : offsets[i + 1]] for i in range(b)
        ]

    def encode_chunk(self, data: bytes, block_log: int):
        """Compress a chunk as consecutive 2**block_log blocks in ONE
        native call (the streaming encode_file granularity).  Returns
        ``(payload_bytes, size_records uint32[count])`` with RAW_FLAG
        semantics matching the frame writer."""
        import numpy as np

        block_size = 1 << block_log
        count = max(0, -(-len(data) // block_size))
        sizes = np.zeros(max(count, 1), np.uint32)
        cap = len(data) + count * (block_size // 255 + 64) + 64
        out = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_encode_chunk(
            data, len(data), block_log, out, cap, sizes.ctypes.data
        )
        if n < 0:
            raise RuntimeError(f"native chunk encode failed ({n})")
        return out.raw[:n], sizes[:count]

    def decode_chunk(
        self, payloads: bytes, recs, block_log: int, raw_total: int
    ) -> bytes:
        """Decode consecutive block payloads in ONE native call (the
        streaming decode_file granularity; no per-block sub-frames)."""
        import numpy as np

        recs = np.ascontiguousarray(recs, np.uint32)
        out = ctypes.create_string_buffer(max(raw_total, 1))
        n = self._lib.lz4t_decode_chunk(
            payloads, len(payloads),
            recs.ctypes.data, len(recs), block_log,
            raw_total, out, max(raw_total, 1),
        )
        if n < 0:
            raise RuntimeError(f"native chunk decode failed ({n})")
        return out.raw[:n]

    def build_copy_program(
        self, frame: bytes, block_count: int, block_size: int,
        depth_cap: int = 1,
    ):
        """LZ4T frame → device-decode copy program.

        Returns ``(lit (B, P) uint8, src (B, P) int32, raw_sizes (B,) int64,
        max_depth int)`` with ``src == -1`` at literal positions; chains
        deeper than ``depth_cap`` are pre-rooted host-side.  See
        ``lz4core.cpp::lz4t_build_copy_program``."""
        import numpy as np

        lit = np.zeros((block_count, block_size), np.uint8)
        src = np.full((block_count, block_size), -1, np.int32)
        sizes = np.zeros(block_count, np.int64)
        depth = np.zeros(1, np.int64)
        got = self._lib.lz4t_build_copy_program(
            frame, len(frame),
            lit.ctypes.data, src.ctypes.data, sizes.ctypes.data,
            depth_cap, depth.ctypes.data,
        )
        if got != block_count:
            raise RuntimeError(f"native copy-program build failed ({got})")
        return lit, src, sizes, int(depth[0])

    def huff_pack(self, codes, lengths) -> tuple:
        """(uint32 codes, uint8 lengths) → (packed bytes, total bits)."""
        import numpy as np

        codes = np.ascontiguousarray(codes, np.uint32)
        lengths = np.ascontiguousarray(lengths, np.uint8)
        cap = int(lengths.astype(np.int64).sum()) // 8 + 8
        out = ctypes.create_string_buffer(cap)
        nbits = self._lib.huff_pack(
            codes.ctypes.data, lengths.tobytes(), len(codes), out, cap
        )
        if nbits < 0:
            raise RuntimeError(f"native huffman pack failed ({nbits})")
        return out.raw[: (nbits + 7) // 8], int(nbits)

    def huff_unpack(self, packed: bytes, nbits: int, lengths, symbols):
        """Canonical Huffman decode; numpy uint8 lengths / int32 symbols."""
        import numpy as np

        lengths = np.ascontiguousarray(lengths, np.uint8)
        symbols = np.ascontiguousarray(symbols, np.int32)
        out = np.empty(max(nbits, 1), np.int32)
        n = self._lib.huff_unpack(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            out.ctypes.data, len(out),
        )
        if n < 0:
            raise RuntimeError(f"native huffman unpack failed ({n})")
        return out[:n].copy()

    def rle_symbol_hist(self, pairs, lengths, offset: int, nbins: int):
        """Histogram of valid symbols in padded (N, 2L) int32 RLE pairs.

        Returns (counts int64[nbins], total) — the single-pass C++
        replacement for mask-compact + ``np.unique`` (seconds vs ~10 ms on
        the throttled host at multi-megapixel streams)."""
        import numpy as np

        pairs = np.ascontiguousarray(pairs, np.int32)
        lengths = np.ascontiguousarray(lengths, np.int32)
        counts = np.zeros(nbins, np.int64)
        total = self._lib.rle_symbol_hist(
            pairs.ctypes.data, lengths.ctypes.data,
            pairs.shape[0], pairs.shape[1], offset,
            counts.ctypes.data, nbins,
        )
        if total < 0:
            raise RuntimeError(f"native symbol hist failed ({total})")
        return counts, int(total)

    def huff_unpack_pairs(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int, pad_width: int,
    ):
        """Canonical decode + RLE re-blocking in one pass (the inverse of
        ``huff_pack_pairs``).  Returns (pairs (N, pad) int32, lengths) or
        None if the stream needs the quirk-compatible numpy path."""
        import numpy as np

        if (nbits + 7) // 8 > len(packed):
            # Hostile/corrupt containers can claim more bits than the
            # buffer holds — the C++ walker trusts nbits, so bound it here
            # (mirrors the check in ops.huffman.unpack_symbols).
            raise ValueError(
                f"bit count {nbits} exceeds packed buffer of {len(packed)} bytes"
            )
        lengths = np.ascontiguousarray(codebook.lengths, np.uint8)
        symbols = np.ascontiguousarray(codebook.symbols, np.int32)
        out_pairs = np.zeros((num_blocks, pad_width), np.int32)
        out_lengths = np.zeros(num_blocks, np.int32)
        n = self._lib.huff_unpack_pairs(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            block_size, num_blocks, pad_width,
            out_pairs.ctypes.data, out_lengths.ctypes.data,
        )
        if n < 0:
            return None
        return out_pairs, out_lengths

    def huff_pack_pairs(self, pairs, lengths, codebook) -> tuple:
        """Map + MSB-first pack valid symbols of padded RLE pairs through a
        CanonicalCodebook, one C++ pass.  Returns (packed bytes, bits)."""
        import numpy as np

        pairs = np.ascontiguousarray(pairs, np.int32)
        lengths = np.ascontiguousarray(lengths, np.int32)
        base = int(codebook.symbols.min())
        size = int(codebook.symbols.max()) - base + 1
        lut_codes = np.zeros(size, np.uint32)
        lut_lens = np.zeros(size, np.uint8)  # 0 = unseen → error in C++
        lut_codes[codebook.symbols - base] = codebook.codes
        lut_lens[codebook.symbols - base] = codebook.lengths
        total = int(lengths.astype(np.int64).sum())
        cap = total * 4 + 16  # ≤32 bits per symbol
        out = ctypes.create_string_buffer(cap)
        nbits = ctypes.c_uint64(0)
        n = self._lib.huff_pack_pairs(
            pairs.ctypes.data, lengths.ctypes.data,
            pairs.shape[0], pairs.shape[1], base,
            lut_codes.ctypes.data, lut_lens.ctypes.data, size,
            out, cap, ctypes.byref(nbits),
        )
        if n < 0:
            raise RuntimeError(f"native pair pack failed ({n})")
        return out.raw[:n], int(nbits.value)

    def rle_symbol_hist16(self, packed, lengths, offset: int, nbins: int):
        """``rle_symbol_hist`` over the packed-u16 pair layout (one uint16
        per [count, value] pair; lengths still count symbols)."""
        import numpy as np

        packed = np.ascontiguousarray(packed, np.uint16)
        lengths = np.ascontiguousarray(lengths, np.int32)
        counts = np.zeros(nbins, np.int64)
        total = self._lib.rle_symbol_hist16(
            packed.ctypes.data, lengths.ctypes.data,
            packed.shape[0], packed.shape[1], offset,
            counts.ctypes.data, nbins,
        )
        if total < 0:
            raise RuntimeError(f"native symbol hist16 failed ({total})")
        return counts, int(total)

    def huff_pack_pairs16(self, packed_pairs, lengths, codebook) -> tuple:
        """``huff_pack_pairs`` over the packed-u16 pair layout."""
        import numpy as np

        packed_pairs = np.ascontiguousarray(packed_pairs, np.uint16)
        lengths = np.ascontiguousarray(lengths, np.int32)
        base = int(codebook.symbols.min())
        size = int(codebook.symbols.max()) - base + 1
        lut_codes = np.zeros(size, np.uint32)
        lut_lens = np.zeros(size, np.uint8)
        lut_codes[codebook.symbols - base] = codebook.codes
        lut_lens[codebook.symbols - base] = codebook.lengths
        total = int(lengths.astype(np.int64).sum())
        cap = total * 4 + 16
        out = ctypes.create_string_buffer(cap)
        nbits = ctypes.c_uint64(0)
        n = self._lib.huff_pack_pairs16(
            packed_pairs.ctypes.data, lengths.ctypes.data,
            packed_pairs.shape[0], packed_pairs.shape[1], base,
            lut_codes.ctypes.data, lut_lens.ctypes.data, size,
            out, cap, ctypes.byref(nbits),
        )
        if n < 0:
            raise RuntimeError(f"native pair pack16 failed ({n})")
        return out.raw[:n], int(nbits.value)

    def huff_unpack_pairs16(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int, pad_pairs: int,
    ):
        """Decode + re-block into the packed-u16 pair layout.

        ``pad_pairs`` is the padded PAIR count per block (half the symbol
        pad width).  Returns (packed (N, pad_pairs) uint16, lengths) or
        None if the stream needs the int32 / quirk-compatible path."""
        import numpy as np

        if (nbits + 7) // 8 > len(packed):
            raise ValueError(
                f"bit count {nbits} exceeds packed buffer of {len(packed)} bytes"
            )
        lengths = np.ascontiguousarray(codebook.lengths, np.uint8)
        symbols = np.ascontiguousarray(codebook.symbols, np.int32)
        out_pairs = np.zeros((num_blocks, pad_pairs), np.uint16)
        out_lengths = np.zeros(num_blocks, np.int32)
        n = self._lib.huff_unpack_pairs16(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            block_size, num_blocks, pad_pairs,
            out_pairs.ctypes.data, out_lengths.ctypes.data,
        )
        if n < 0:
            return None
        return out_pairs, out_lengths

    def rle_symbol_hist_sparse16(
        self, sparse, col_off: int, row_len: int, offset: int, nbins: int
    ):
        """Symbol histogram over one channel of a sparse-delta buffer
        (ops/rle.py::rle_encode_sparse16), walked IN PLACE: ``sparse`` is
        the (N, stride) uint16 combined array (stride = 128 for the
        combined layout, or == row_len for a single channel) and
        ``col_off``/``row_len`` select the channel lanes.  Also returns
        the per-block symbol lengths (2·runs) — the device never ships a
        lengths side channel in this layout."""
        import numpy as np

        sparse = np.ascontiguousarray(sparse, np.uint16)
        counts = np.zeros(nbins, np.int64)
        out_lengths = np.zeros(sparse.shape[0], np.int32)
        total = self._lib.rle_symbol_hist_sparse16(
            sparse.ctypes.data, sparse.shape[0], row_len, sparse.shape[1],
            col_off, offset, counts.ctypes.data, nbins,
            out_lengths.ctypes.data,
        )
        if total < 0:
            raise RuntimeError(f"native sparse16 hist failed ({total})")
        return counts, out_lengths, int(total)

    def huff_pack_sparse16(
        self, sparse, col_off: int, row_len: int, codebook, total_symbols: int
    ) -> tuple:
        """``huff_pack_pairs16`` over one channel of a sparse-delta
        combined buffer (symbols reconstructed during the walk)."""
        import numpy as np

        sparse = np.ascontiguousarray(sparse, np.uint16)
        base = int(codebook.symbols.min())
        size = int(codebook.symbols.max()) - base + 1
        lut_codes = np.zeros(size, np.uint32)
        lut_lens = np.zeros(size, np.uint8)
        lut_codes[codebook.symbols - base] = codebook.codes
        lut_lens[codebook.symbols - base] = codebook.lengths
        cap = total_symbols * 4 + 16  # ≤32 bits per symbol
        out = ctypes.create_string_buffer(cap)
        nbits = ctypes.c_uint64(0)
        n = self._lib.huff_pack_sparse16(
            sparse.ctypes.data, sparse.shape[0], row_len, sparse.shape[1],
            col_off, base,
            lut_codes.ctypes.data, lut_lens.ctypes.data, size,
            out, cap, ctypes.byref(nbits),
        )
        if n < 0:
            raise RuntimeError(f"native sparse16 pack failed ({n})")
        return out.raw[:n], int(nbits.value)

    def huff_unpack_sparse16(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int,
        out_sparse=None, col_off: int = 0,
    ):
        """Decode straight into the sparse-delta layout (h2d-ready).

        ``out_sparse`` may be a pre-allocated zeroed (N, stride) uint16
        combined buffer to decode several channels in place; defaults to
        a fresh (N, block_size) array.  Returns (out_sparse, lengths) or
        None if the stream needs the quirk-compatible Python path."""
        import numpy as np

        if (nbits + 7) // 8 > len(packed):
            raise ValueError(
                f"bit count {nbits} exceeds packed buffer of {len(packed)} bytes"
            )
        lengths = np.ascontiguousarray(codebook.lengths, np.uint8)
        symbols = np.ascontiguousarray(codebook.symbols, np.int32)
        if out_sparse is None:
            out_sparse = np.zeros((num_blocks, block_size), np.uint16)
        out_lengths = np.zeros(num_blocks, np.int32)
        n = self._lib.huff_unpack_sparse16(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            block_size, num_blocks, out_sparse.shape[1], col_off,
            out_sparse.ctypes.data, out_lengths.ctypes.data,
        )
        if n < 0:
            return None
        return out_sparse, out_lengths

    def huff_per_block(self, pairs, lengths):
        """Parity-mode per-block Huffman (reference JPEG.c:844-1097 via the
        oracle's quirk-exact semantics): padded (N, W) int32 RLE symbols +
        (N,) valid lengths → list of N ASCII '0'/'1' bitstrings, one C++
        pass.  Returns None when a symbol is outside the native range (the
        caller then falls back to the Python oracle loop)."""
        import numpy as np

        pairs = np.ascontiguousarray(pairs, np.int32)
        lengths = np.ascontiguousarray(lengths, np.int32)
        n, w = pairs.shape
        # ≤ ~32 bits per symbol is the practical worst case, but the quirky
        # heap can emit code lengths up to (#unique − 1) ≤ 127 for wide
        # blocks — on output-full (-1) retry with a doubled buffer instead
        # of silently falling back to the slow Python oracle loop.
        cap = int(lengths.astype(np.int64).sum()) * 64 + 1024
        counts = np.zeros(n, np.int64)
        total = -1
        for _ in range(3):
            out = ctypes.create_string_buffer(cap)
            total = self._lib.huff_per_block_ascii(
                pairs.ctypes.data, lengths.ctypes.data, n, w,
                out, cap, counts.ctypes.data,
            )
            if total != -1:  # success or kErrBadInput (-2): stop retrying
                break
            cap *= 2
        if total < 0:
            return None
        buf = out.raw[:total].decode("ascii")
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [buf[offsets[i] : offsets[i + 1]] for i in range(n)]

    def crc32(self, data: bytes, crc: int = 0) -> int:
        """Incremental zlib-compatible CRC32 via the native table (the
        streaming writers use ``zlib.crc32``; this export exists so C++
        and Python checksums are provably identical — see the parity test)."""
        return int(self._lib.lz4t_crc32(crc & 0xFFFFFFFF, data, len(data)))

    def encode_parity(self, data: bytes, block_length: int = 300) -> bytes:
        out = ctypes.create_string_buffer(2 * len(data) + 65536)
        n = self._lib.lz4_encode_parity(
            data, len(data), out, len(out), block_length
        )
        if n < 0:
            raise RuntimeError(f"native parity encode failed ({n})")
        return out.raw[:n]


def build_native(quiet: bool = True) -> bool:
    """Compile the shared library in-tree.  Returns True on success."""
    try:
        subprocess.run(
            ["make", "-C", _HERE],
            check=True,
            capture_output=quiet,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def native_backend(build_if_missing: bool = True) -> NativeBackend:
    global _backend
    if _backend is not None:
        return _backend
    if not os.path.exists(_LIB_PATH) and build_if_missing:
        build_native()
    if not os.path.exists(_LIB_PATH):
        raise RuntimeError(
            "native backend not built; run `make -C lz4jpeg_tpu/native`"
        )
    _backend = NativeBackend(ctypes.CDLL(_LIB_PATH))
    return _backend


def native_available() -> bool:
    try:
        native_backend()
        return True
    except RuntimeError:
        return False
