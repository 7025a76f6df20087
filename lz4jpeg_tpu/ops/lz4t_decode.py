"""Device-parallel decode of the fast (LZ4T) frame.

The reference's parallel decode is a thread per block whose framing walk is
serial (each block's byte size is discovered by reading the previous
block's header, ``Algorithms/parallel/LZ4/LZ4.c:1136-1148``) and whose
create/wait pairing serialized the threads anyway (``:1177-1178``).  The
LZ4T format was designed to fix the framing half: compressed sizes live up
front, so every block's payload offset is one prefix sum over the size
table (``formats/fast_frame.py``).  This module supplies the other half —
block-parallel reconstruction on the accelerator:

1. **Framing + parse (host, linear, memcpy-speed).**  One native C++ pass
   (``lz4core.cpp::lz4t_build_copy_program``) turns the whole frame into a
   *copy program*: a dense (B, P) grid where every output byte is either a
   literal byte or the intra-block index it copies from.  Blocks are
   independent by construction (matches never cross an LZ4T block), so the
   program rows are too.
   The builder walks left to right and keeps every position's root, so
   it hands the device a fully rooted program: each match position
   names the literal it ultimately copies.
2. **Match resolution (device, batched).**  One gather per block row,
   ``lit[root[i]]``, replaces the reference's byte-serial copy loop
   (``interpret_sequence``, LZ4.c:937-982).  All blocks resolve at once,
   and the block axis shards over a device mesh (``parallel/lz4.py::
   sharded_resolve_blocks``) exactly like the encode side.

The parity-frame twin of this module is ``ops/lz4_decode.py`` (global
output buffer, cross-block chains); LZ4T's intra-block chains are what
make the sharded version legal.
"""

from __future__ import annotations

import functools
import struct
from typing import Tuple

import numpy as np

from lz4jpeg_tpu.formats.fast_frame import (
    MAGIC,
    RAW_FLAG,
    VERSION,
    FastFormatError,
)


def build_copy_program_fast(
    frame: bytes, depth_cap: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """LZ4T frame → ``(lit (B, P) u8, src (B, P) i32, raw_sizes (B,), P,
    max_depth)``.

    ``src == -1`` marks literal positions; match positions hold their
    intra-block source index.  Self-overlapping (periodic) matches are
    collapsed to one hop into the source period, chains deeper than
    ``depth_cap`` are pre-rooted (the builder's left-to-right walk keeps
    the root array for free), and ``max_depth`` is the longest remaining
    chain.  The default ``depth_cap=1`` is the fully rooted program
    ``resolve_blocks`` takes; deeper caps exist for tests that check it
    against pointer doubling.  Native single-pass parse when built, pure
    Python otherwise (same output).
    """
    if len(frame) < 20:
        raise FastFormatError("frame too short")
    magic, version, block_log, _res, raw_size, block_count = struct.unpack_from(
        "<IBBHQI", frame, 0
    )
    if magic != MAGIC:
        raise FastFormatError("bad magic")
    if version != VERSION:
        raise FastFormatError(f"unsupported version {version}")
    p = 1 << block_log
    if block_count == 0:
        return (
            np.zeros((0, p), np.uint8),
            np.full((0, p), -1, np.int32),
            np.zeros(0, np.int64),
            p,
            0,
        )

    from lz4jpeg_tpu.native import native_available, native_backend

    if native_available():
        try:
            lit, src, sizes, depth = native_backend().build_copy_program(
                frame, block_count, p, depth_cap
            )
            return lit, src, sizes, p, depth
        except RuntimeError as e:
            raise FastFormatError(str(e)) from e

    sizes_tab = struct.unpack_from(f"<{block_count}I", frame, 20)
    # Prefix-sum framing: the up-front size table gives every payload's
    # offset without touching the payloads (the reference needed a serial
    # header walk here).
    payload_lens = np.asarray(
        [s & ~RAW_FLAG if s & RAW_FLAG else s for s in sizes_tab], np.int64
    )
    offsets = 20 + 4 * block_count + np.concatenate(
        [[0], np.cumsum(payload_lens[:-1])]
    )
    lit = np.zeros((block_count, p), np.uint8)
    src = np.full((block_count, p), -1, np.int32)
    raw_sizes = np.zeros(block_count, np.int64)
    done = 0
    max_depth = 0
    for b, rec in enumerate(sizes_tab):
        expected = min(p, raw_size - done)
        start = int(offsets[b])
        if rec & RAW_FLAG:
            length = rec & ~RAW_FLAG
            if length != expected:
                raise FastFormatError(f"raw block {b} size mismatch")
            lit[b, :length] = np.frombuffer(frame, np.uint8, length, start)
        else:
            d = _parse_payload(
                frame[start : start + rec], lit[b], src[b], expected,
                depth_cap,
            )
            max_depth = max(max_depth, d)
        raw_sizes[b] = expected
        done += expected
    if done != raw_size:
        raise FastFormatError("frame size mismatch")
    return lit, src, raw_sizes, p, max_depth


def _parse_payload(
    payload: bytes, lit_row: np.ndarray, src_row: np.ndarray, expected: int,
    depth_cap: int = 1,
) -> int:
    """One block's payload → its copy-program row (Python spec path).
    Returns the block's maximum (post-cap) chain depth."""
    depth = np.zeros(expected, np.int32)
    root = np.arange(expected, dtype=np.int32)
    depth_cap = max(1, depth_cap)
    q, w, n = 0, 0, len(payload)
    while q < n:
        token = payload[q]
        q += 1
        run = token >> 4
        if run == 15:
            while True:
                if q >= n:
                    raise FastFormatError("truncated literal extension")
                e = payload[q]
                q += 1
                run += e
                if e != 255:
                    break
        if q + run > n or w + run > expected:
            raise FastFormatError("truncated literals")
        lit_row[w : w + run] = np.frombuffer(payload, np.uint8, run, q)
        q += run
        w += run
        if q == n:
            break  # final literals-only sequence
        if q + 2 > n:
            raise FastFormatError("truncated offset")
        offset = payload[q] | (payload[q + 1] << 8)
        q += 2
        if offset == 0 or offset > w:
            raise FastFormatError("bad match offset")
        ml = (token & 0xF) + 4
        if token & 0xF == 15:
            while True:
                if q >= n:
                    raise FastFormatError("truncated match extension")
                e = payload[q]
                q += 1
                ml += e
                if e != 255:
                    break
        if w + ml > expected:
            raise FastFormatError("match overruns block")
        # Periodic self-overlap collapses to one hop into the source period.
        j = np.arange(ml, dtype=np.int32)
        s = w - offset + np.where(j < offset, j, j % offset)
        d = depth[s] + 1
        deep = d > depth_cap
        s = np.where(deep, root[s], s)  # pre-root deep chains
        d = np.where(deep, 1, d)
        src_row[w : w + ml] = s
        depth[w : w + ml] = d
        root[w : w + ml] = root[s]
        w += ml
    if w != expected:
        raise FastFormatError("decoded size mismatch")
    return int(depth.max(initial=0))


@functools.partial(__import__("jax").jit)
def resolve_blocks(lit, src):
    """Batched copy resolve of a fully rooted (B, P) copy program → bytes:
    literal positions (``src == -1``) read themselves, match positions
    read the literal they root at, all in one gather per row."""
    import jax.numpy as jnp

    p = src.shape[1]
    idx = jnp.arange(p, dtype=src.dtype)[None, :]
    return jnp.take_along_axis(lit, jnp.where(src < 0, idx, src), axis=1)


def decode_fast_device(frame: bytes) -> bytes:
    """Full LZ4T decode with device match resolution (single device):
    the host builds the fully rooted copy program, the device resolves
    it with ``resolve_blocks``."""
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.formats.fast_frame import verify_frame_checksum

    lit, src, raw_sizes, _, _ = build_copy_program_fast(frame)
    if lit.shape[0] == 0:
        return b""
    out = np.asarray(
        jax.device_get(resolve_blocks(jnp.asarray(lit), jnp.asarray(src)))
    )
    decoded = _trim_rows(out, raw_sizes)
    verify_frame_checksum(frame, decoded)
    return decoded


def _trim_rows(out: np.ndarray, raw_sizes: np.ndarray) -> bytes:
    if int(raw_sizes.min(initial=out.shape[1])) == out.shape[1]:
        return out.tobytes()  # only full blocks — no ragged tail
    parts = [out[b, : int(n)].tobytes() for b, n in enumerate(raw_sizes)]
    return b"".join(parts)
