"""The forward kernel: color + DCT + sparse-delta RLE in one Pallas pass.

The XLA forward chain (``models/jpeg.py::_forward_rle_impl``) writes the
YCbCr planes, relayouts them into 8×8 tiles, materialises float32 matmul
operands and outputs, and only then runs the sparse-delta epilogue
(``ops/rle.py::rle_encode_sparse16``).  Fused, the chain needs about
7 bytes per pixel of device-memory traffic: the uint8 RGB read once and
the (N, 128) uint16 combined stream written once.  This kernel is that
fusion, written for the Triton route of Pallas (``backend="triton"``):

* one program handles ``TILE_BLOCKS`` consecutive MCUs in block-row-major
  order and gathers their pixels straight from the interleaved (H, W, 3)
  image — no relayout pass exists anywhere;
* the 4:2:2 subsample is a choice of gather positions: chroma reads
  only the odd full-resolution columns (``chroma_subsample_422``), so
  the chroma bases stay (32, 32);
* DCT + quantize + zigzag is one float32 product per channel against the
  fused basis of ``ops/fused.py`` at ``Precision.HIGHEST`` (IEEE fp32,
  not TF32), followed by the same tie-snapping truncation;
* the sparse-delta epilogue needs each coefficient's predecessor in
  zigzag order, and Triton has no register shift: the program stores its
  biased coefficients to its own output rows, waits at a block barrier,
  reads them back one lane over, waits again, and overwrites the rows
  with the deltas.  The round trip stays in the SM's cache; a one-hot
  shift product instead (tensor cores beside the fp32 FMA products)
  measured an order of magnitude slower on an H200.

``models/jpeg.py::_forward_rle_impl`` calls the kernel when lowering for
a CUDA device with an 8-aligned shape; every other case runs the XLA
chain the kernel is tested against (``PERF.md`` has both times).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lz4jpeg_tpu.ops.fused import _table_key, forward_basis
from lz4jpeg_tpu.ops.rle import COMBINED_LANES, SPARSE16_DELTA_BIAS

TILE_BLOCKS = 64  # MCUs per program (a power of two, as Triton requires)
NUM_WARPS = 8  # measured best with TILE_BLOCKS on an H200 (PERF.md)
_STORE_BIAS = 4096  # coefficients are stored biased positive in uint16


@functools.lru_cache(maxsize=None)
def _bases(lum_key: bytes, chr_key: bytes):
    """Kernel operands as float32 numpy arrays: transposed fused bases
    (64, 64) and (32, 32), and offsets (1, 64) and (1, 32)."""
    my, offy = forward_basis(8, 8, lum_key)
    mc, offc = forward_basis(4, 8, chr_key)
    return (
        np.ascontiguousarray(my.T, np.float32),
        np.ascontiguousarray(mc.T, np.float32),
        offy.astype(np.float32)[None, :],
        offc.astype(np.float32)[None, :],
    )


def _snap_trunc_i32(x, eps):
    """``ops/color.py::_snap_trunc`` then int32, from primitives the
    Triton lowering has (no ``round``): within ``eps`` of an integer the
    nearest integer is ``floor(x + 0.5)``, and float→int truncates."""
    nearest = jnp.floor(x + 0.5)
    return jnp.where(jnp.abs(x - nearest) <= eps, nearest, x).astype(jnp.int32)


def _fwd_kernel(
    x_ref, my_ref, mc_ref, offy_ref, offc_ref, o_ref,
    *, width: int, bpr: int, nblocks: int, tb: int, threads: bool,
):
    # Blocks n of this program, in block-row-major order.  Rows past the
    # last block read the last block's pixels and write the padding rows
    # the wrapper slices off, so no load leaves the image and no two rows
    # store to one address.
    n = pl.program_id(0) * tb + jax.lax.broadcasted_iota(jnp.int32, (tb, 1), 0)
    nc = jnp.minimum(n, nblocks - 1)
    row = jax.lax.div(nc, jnp.int32(bpr))
    bx = jax.lax.rem(nc, jnp.int32(bpr))

    def channels(k, cols_log2, col_of):
        # Pixel index of position k of each block in the tile; the image
        # arrives as little-endian uint32 words (see ``forward_kernel``).
        pix = (
            (row * 8 + jnp.right_shift(k, cols_log2)) * width
            + bx * 8 + col_of(k)
        )
        out = []
        for ch in range(3):
            byte = pix * 3 + ch
            word = x_ref[jnp.right_shift(byte, 2)]
            shift = (jnp.bitwise_and(byte, 3) * 8).astype(jnp.uint32)
            value = jnp.bitwise_and(
                jax.lax.shift_right_logical(word, shift), jnp.uint32(0xFF)
            )
            out.append(value.astype(jnp.int32).astype(jnp.float32))
        return out

    def dct(plane, m_ref, off_ref):
        ratio = pl.dot(
            plane, m_ref[...], precision=jax.lax.Precision.HIGHEST
        ) - off_ref[...]
        return _snap_trunc_i32(ratio, 1e-5)

    def store_sparse(xq, lane0, lanes):
        # Sparse-delta epilogue through the program's own output rows (see
        # the module docstring): lane 0 of each channel has predecessor 0.
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, lanes), 1)
        row_base = n * COMBINED_LANES + lane0
        o_ref[row_base + lane] = (xq + _STORE_BIAS).astype(jnp.uint16)
        if threads:  # the interpreter runs a program as one sequence
            plgpu.debug_barrier()
        first = lane == 0
        prev = plgpu.load(
            o_ref.at[row_base + jnp.maximum(lane - 1, 0)],
            mask=jnp.broadcast_to(~first, (tb, lanes)),
            other=_STORE_BIAS,
        ).astype(jnp.int32) - _STORE_BIAS
        if threads:
            plgpu.debug_barrier()
        w = jnp.where(first | (xq != prev), xq - prev + SPARSE16_DELTA_BIAS, 0)
        o_ref[row_base + lane] = w.astype(jnp.uint16)

    # Luma: all 64 positions, row-major within the 8×8 tile.  Reference
    # color semantics: Y truncated, Cr/Cb truncated then clamped
    # (JPEG.c:127,157,180,132-139).
    k64 = jax.lax.broadcasted_iota(jnp.int32, (1, 64), 1)
    r, g, b = channels(k64, 3, lambda k: jnp.bitwise_and(k, 7))
    y = _snap_trunc_i32(0.299 * r + 0.587 * g + 0.114 * b, 1e-4)
    store_sparse(dct(y.astype(jnp.float32), my_ref, offy_ref), 0, 64)

    # Chroma: the 8×4 subsampled tile reads full-resolution column 2c+1.
    k32 = jax.lax.broadcasted_iota(jnp.int32, (1, 32), 1)
    r, g, b = channels(k32, 2, lambda k: 2 * jnp.bitwise_and(k, 3) + 1)
    for lane0, plane in (
        (64, 0.439 * r - 0.368 * g - 0.071 * b + 128.0),
        (96, -0.148 * r - 0.291 * g + 0.439 * b + 128.0),
    ):
        c = jnp.clip(_snap_trunc_i32(plane, 1e-4), 0, 255)
        store_sparse(dct(c.astype(jnp.float32), mc_ref, offc_ref), lane0, 32)


def forward_kernel(
    rgb: jnp.ndarray,
    lum_table: np.ndarray,
    chr_table: np.ndarray,
    interpret: bool = False,
) -> jnp.ndarray:
    """(H, W, 3) uint8 → (N, 128) uint16 combined sparse streams, N =
    (H/8)·(W/8) blocks in block-row-major order.  Requires H % 8 == 0 and
    W % 8 == 0.  Batches through ``jax.vmap`` (one grid axis per frame).

    The image goes in as uint32 words: the Triton lowering addresses an
    operand under 4 GiB with 32-bit element offsets that the pointer
    arithmetic reads as signed, so a uint8 batch between 2 and 4 GiB (256
    frames of 2048²) would wrap; words keep every offset below 2**30.
    """
    h, w, _ = rgb.shape
    if h % 8 or w % 8:
        raise ValueError(f"forward kernel needs 8-aligned shapes: {rgb.shape}")
    nblocks, bpr = (h // 8) * (w // 8), w // 8
    grid = pl.cdiv(nblocks, TILE_BLOCKS)
    consts = _bases(_table_key(lum_table), _table_key(chr_table))
    words = jax.lax.bitcast_convert_type(rgb.reshape(-1, 4), jnp.uint32)
    out = pl.pallas_call(
        functools.partial(
            _fwd_kernel, width=w, bpr=bpr, nblocks=nblocks,
            tb=TILE_BLOCKS, threads=not interpret,
        ),
        grid=(grid,),
        out_shape=jax.ShapeDtypeStruct(
            (grid * TILE_BLOCKS * COMBINED_LANES,), jnp.uint16
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="jpeg_forward_sparse16",
    )(words, *(jnp.asarray(c) for c in consts))
    out = out.reshape(grid * TILE_BLOCKS, COMBINED_LANES)
    return out if grid * TILE_BLOCKS == nblocks else out[:nblocks]
