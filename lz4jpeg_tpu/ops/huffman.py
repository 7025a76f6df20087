"""Huffman entropy coding: codebook construction + vectorized bit packing.

Two modes mirror SURVEY.md §7 step 5:

* **per_block parity mode** lives in ``oracle/jpeg_oracle.py`` — it rebuilds
  a tree per block per channel with the reference's exact heap quirks
  (JPEG.c:1035-1097) and is used for bit-level parity checks.

* **shared mode** (this module) is the batched design: one *canonical*
  codebook per channel built from global symbol statistics, broadcast to all
  devices, with encoding as a table gather + bit-pack.  Canonical codes are
  fully determined by (length, symbol) order, which makes the codebook
  serializable in a few bytes per symbol and decode table-driven — unlike
  the reference, which never serializes its trees and can only decode
  in-process (SURVEY.md §2.2.8).

Bit packing is vectorized with NumPy (bit matrix → mask → ``packbits``); the
packed stream is a real artifact that round-trips through bytes.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class CanonicalCodebook:
    """Canonical Huffman codebook over int32 symbols."""

    symbols: np.ndarray   # (S,) int32, sorted by (length, symbol)
    lengths: np.ndarray   # (S,) uint8 code lengths, ascending
    codes: np.ndarray     # (S,) uint32 canonical codewords (MSB-first)

    def encode_map(self) -> Dict[int, Tuple[int, int]]:
        return {
            int(s): (int(c), int(l))
            for s, c, l in zip(self.symbols, self.codes, self.lengths)
        }

    def serialize(self) -> bytes:
        """(count:u32, then per symbol: symbol:i32 length:u8) — canonical
        codes are reconstructible from lengths alone."""
        out = bytearray()
        out += np.uint32(len(self.symbols)).tobytes()
        out += self.symbols.astype("<i4").tobytes()
        out += self.lengths.astype(np.uint8).tobytes()
        return bytes(out)

    @staticmethod
    def deserialize(data: bytes, offset: int = 0) -> Tuple["CanonicalCodebook", int]:
        count = int(np.frombuffer(data, "<u4", 1, offset)[0])
        offset += 4
        symbols = np.frombuffer(data, "<i4", count, offset).copy()
        offset += 4 * count
        lengths = np.frombuffer(data, np.uint8, count, offset).copy()
        offset += count
        codes = _canonical_codes(lengths)
        return CanonicalCodebook(symbols, lengths, codes), offset


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codewords to length-sorted symbols."""
    codes = np.zeros(len(lengths), np.uint32)
    code = 0
    prev_len = int(lengths[0]) if len(lengths) else 0
    for i, l in enumerate(lengths):
        code <<= int(l) - prev_len
        prev_len = int(l)
        codes[i] = code
        code += 1
    return codes


def build_canonical_codebook(symbols: np.ndarray) -> CanonicalCodebook:
    """Optimal code lengths via Huffman (stable heap), then canonical codes.

    A single-symbol alphabet gets a 1-bit code (the reference emits an empty
    code there, JPEG.c:963-975, which is unserializable; 1 bit is the
    canonical fix and still round-trips).
    """
    values, counts = np.unique(np.asarray(symbols, np.int64), return_counts=True)
    return build_canonical_codebook_from_counts(values, counts)


def build_canonical_codebook_from_counts(
    values: np.ndarray, counts: np.ndarray
) -> CanonicalCodebook:
    """``build_canonical_codebook`` from a precomputed (values, counts)
    frequency table — values ascending and unique, counts positive (what
    the native ``rle_symbol_hist`` pass produces)."""
    values = np.asarray(values, np.int64)
    counts = np.asarray(counts)
    if len(values) == 1:
        return CanonicalCodebook(
            values.astype(np.int32),
            np.array([1], np.uint8),
            np.array([0], np.uint32),
        )
    # (count, tiebreak, id): deterministic merge order.
    heap: List[Tuple[int, int, int]] = [
        (int(c), i, i) for i, c in enumerate(counts)
    ]
    heapq.heapify(heap)
    parent = {}
    next_id = len(values)
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    depths = np.zeros(len(values), np.uint8)
    for i in range(len(values)):
        d, node = 0, i
        while node in parent:
            node = parent[node]
            d += 1
        depths[i] = d
    order = np.lexsort((values, depths))
    lengths = depths[order]
    if lengths[-1] > 32:
        # Codewords are uint32 end to end (host packer, native walker,
        # device packer); >32-bit codes require a pathological
        # Fibonacci-like frequency skew that real RLE streams cannot
        # produce — fail loudly rather than overflow silently.
        raise ValueError(
            f"Huffman code length {int(lengths[-1])} exceeds the 32-bit "
            "codeword limit"
        )
    return CanonicalCodebook(
        values[order].astype(np.int32), lengths, _canonical_codes(lengths)
    )


def pack_symbols(
    symbols: np.ndarray, codebook: CanonicalCodebook
) -> Tuple[bytes, int]:
    """Vectorized encode: symbols → (packed bytes, total bit count).

    Symbol→code mapping is a searchsorted gather; the bit concatenation
    runs in the native C++ packer when built (the NumPy bit-matrix
    fallback below is ~100× slower at multi-million-symbol streams).
    """
    symbols = np.asarray(symbols, np.int32)
    if len(symbols) == 0:
        return b"", 0
    # Map symbols → codebook rows via searchsorted on the symbol-sorted view.
    sym_order = np.argsort(codebook.symbols, kind="stable")
    sorted_syms = codebook.symbols[sym_order]
    idx = np.minimum(
        np.searchsorted(sorted_syms, symbols), len(sorted_syms) - 1
    )
    rows = sym_order[idx]
    if not np.array_equal(codebook.symbols[rows], symbols):
        raise ValueError("symbol outside codebook")
    lengths = codebook.lengths[rows]
    codes = codebook.codes[rows]

    from lz4jpeg_tpu.native import native_available, native_backend

    if native_available():
        return native_backend().huff_pack(codes, lengths)

    lengths = lengths.astype(np.int64)
    codes = codes.astype(np.int64)
    max_len = int(lengths.max())
    # Bit matrix: row i holds code i MSB-first in its first lengths[i] slots.
    shifts = lengths[:, None] - 1 - np.arange(max_len, dtype=np.int64)[None, :]
    valid = shifts >= 0
    bits = np.where(
        valid, (codes[:, None] >> np.maximum(shifts, 0)) & 1, 0
    ).astype(np.uint8)
    flat_bits = bits[valid]
    total_bits = int(lengths.sum())
    return np.packbits(flat_bits).tobytes(), total_bits


def pack_symbols_device(
    symbols, codebook: CanonicalCodebook, pad_bits: int
):
    """Vectorized bit packing on the accelerator.

    Jit-compatible variant of ``pack_symbols``: every output *bit* finds its
    source symbol with one ``searchsorted`` over the exclusive bit-offset
    prefix sum, extracts its bit of the codeword, and the bit matrix folds
    to bytes with a (·,8)×(8,) dot.  The production entropy stage is the
    native single-pass packer (``native.huff_pack_pairs``); this op serves
    device-resident pipelines that need occasional in-graph packing, and
    ``bench/entropy_ab.py`` times the two against each other.

    ``pad_bits`` is the static output capacity in bits (a multiple of 8);
    jit recompiles only per capacity bucket, not per input.  Returns
    ``(packed uint8[pad_bits//8], total_bits)``; bits past ``total_bits``
    are zero, matching ``np.packbits``.

    If ``total_bits > pad_bits`` the buffer holds only a truncated prefix —
    the caller MUST check the returned ``total_bits`` against its bucket
    (it is a traced scalar, so the check happens host-side after
    ``device_get``); ``unpack_symbols`` on a truncated buffer fails.
    """
    import jax.numpy as jnp

    if pad_bits % 8:
        raise ValueError("pad_bits must be a multiple of 8")
    symbols = jnp.asarray(symbols, jnp.int32)
    sym_order = np.argsort(codebook.symbols, kind="stable")
    sorted_syms = jnp.asarray(codebook.symbols[sym_order].astype(np.int32))
    row_of_sorted = jnp.asarray(sym_order.astype(np.int32))
    rows = row_of_sorted[jnp.searchsorted(sorted_syms, symbols)]
    lengths = jnp.asarray(codebook.lengths.astype(np.int32))[rows]
    codes = jnp.asarray(codebook.codes.astype(np.uint32))[rows]
    offsets = jnp.cumsum(lengths) - lengths  # exclusive prefix
    total_bits = offsets[-1] + lengths[-1] if symbols.shape[0] else jnp.int32(0)
    j = jnp.arange(pad_bits, dtype=jnp.int32)
    s = jnp.clip(
        jnp.searchsorted(offsets, j, side="right") - 1, 0, symbols.shape[0] - 1
    )
    bit_in_code = j - offsets[s]
    shift = lengths[s] - 1 - bit_in_code
    bits = (codes[s] >> shift.astype(jnp.uint32)) & 1
    bits = jnp.where(j < total_bits, bits, 0).astype(jnp.uint8)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    packed = (bits.reshape(-1, 8).astype(jnp.int32) @ weights).astype(
        jnp.uint8
    )
    return packed, total_bits


def unpack_symbols(
    packed: bytes, total_bits: int, codebook: CanonicalCodebook
) -> np.ndarray:
    """Table-driven canonical decode (first-code arithmetic per length).

    Prefers the native C++ walker (~100 MB/s); the Python loop below is
    the executable spec and fallback.
    """
    if total_bits == 0:
        return np.zeros(0, np.int32)
    if (total_bits + 7) // 8 > len(packed):
        # A corrupt/hostile container could claim more bits than the
        # buffer holds — validated here so the native walker never reads
        # out of bounds.
        raise ValueError(
            f"bit count {total_bits} exceeds packed buffer of "
            f"{len(packed)} bytes"
        )
    from lz4jpeg_tpu.native import native_available, native_backend

    if native_available():
        return native_backend().huff_unpack(
            packed, total_bits, codebook.lengths, codebook.symbols
        )
    bits = np.unpackbits(np.frombuffer(packed, np.uint8))[:total_bits]
    # first_code[l], first_index[l] for each distinct length.
    lengths = codebook.lengths.astype(np.int64)
    out: List[int] = []
    # Precompute per-length ranges.
    uniq = np.unique(lengths)
    first_code = {}
    first_index = {}
    for l in uniq:
        idx = int(np.searchsorted(lengths, l))
        first_code[int(l)] = int(codebook.codes[idx])
        first_index[int(l)] = idx
    count_per_len = {int(l): int((lengths == l).sum()) for l in uniq}
    pos = 0
    code = 0
    code_len = 0
    symbols = codebook.symbols
    while pos < total_bits:
        code = (code << 1) | int(bits[pos])
        pos += 1
        code_len += 1
        fc = first_code.get(code_len)
        if fc is not None and fc <= code < fc + count_per_len[code_len]:
            out.append(int(symbols[first_index[code_len] + (code - fc)]))
            code = 0
            code_len = 0
    if code_len != 0:
        raise ValueError("trailing bits do not form a codeword")
    return np.asarray(out, np.int32)


def concat_bitstreams(pieces):
    """Concatenate MSB-first bitstreams: ``[(packed bytes, nbits), ...]`` →
    ``(packed bytes, total_bits)``.

    Each piece is np.packbits-style (bit 0 = MSB of byte 0, zero padding in
    the final partial byte).  Used by the multi-host entropy gather, where
    per-process substreams end at arbitrary bit offsets.
    """
    val = 0
    total = 0
    for data, nbits in pieces:
        if nbits == 0:
            continue
        nbytes = (nbits + 7) // 8
        if nbytes > len(data):
            raise ValueError("bit count exceeds piece buffer")
        piece = int.from_bytes(data[:nbytes], "big") >> (8 * nbytes - nbits)
        val = (val << nbits) | piece
        total += nbits
    if total % 8:
        val <<= 8 - (total % 8)
    return val.to_bytes((total + 7) // 8, "big"), total
