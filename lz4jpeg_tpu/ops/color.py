"""Color transforms and chroma subsampling as batched jnp ops.

Semantics match the reference exactly (verified against ``oracle``):

* ``rgb_to_ycbcr``: Y truncated on uint8 assignment (JPEG.c:127), Cr/Cb
  truncated via ``(int)`` then clamped (JPEG.c:157, :180, :132-139);
* ``chroma_subsample_422``: horizontal 4:2:2 keeping odd columns
  (JPEG.c:327-333);
* ``ycbcr_to_rgb_mcus``: per-term ``(int)`` truncation with the
  1.402 / 0.344136 / 0.714136 / 1.772 coefficients (JPEG.c:598-604).

Everything is elementwise over full planes — XLA fuses the whole transform
into one VPU pass over the image.
"""

from __future__ import annotations

import jax.numpy as jnp


def _snap_trunc(x: jnp.ndarray, eps: float = 1e-4) -> jnp.ndarray:
    """Truncate toward zero, snapping values within ``eps`` of an integer.

    The C truncates the literal double expression; under XLA the sum may be
    reassociated/FMA-fused and land an ulp on the other side of an exact
    integer.  All color coefficients here have ≤3 decimals, so true values
    lie on a 1/1000 grid: a non-integer true value is ≥1e-3 from any
    integer, making ``eps=1e-4`` snapping exact for f32 and f64 alike.
    """
    nearest = jnp.round(x)
    return jnp.trunc(jnp.where(jnp.abs(x - nearest) <= eps, nearest, x))


def rgb_to_ycbcr(rgb: jnp.ndarray, dtype=jnp.float32):
    """(H, W, 3) uint8 → (Y, Cr, Cb) uint8 planes."""
    r = rgb[..., 0].astype(dtype)
    g = rgb[..., 1].astype(dtype)
    b = rgb[..., 2].astype(dtype)
    y = _snap_trunc(0.299 * r + 0.587 * g + 0.114 * b)
    cr = jnp.clip(_snap_trunc(0.439 * r - 0.368 * g - 0.071 * b + 128), 0, 255)
    cb = jnp.clip(_snap_trunc(-0.148 * r - 0.291 * g + 0.439 * b + 128), 0, 255)
    return y.astype(jnp.uint8), cr.astype(jnp.uint8), cb.astype(jnp.uint8)


def chroma_subsample_422(plane: jnp.ndarray) -> jnp.ndarray:
    """Keep odd columns: H×W → H×(W//2)."""
    w = plane.shape[1]
    return plane[:, 1::2][:, : w // 2]


def split_mcus(y: jnp.ndarray, cr_sub: jnp.ndarray, cb_sub: jnp.ndarray):
    """Planes → batched MCU tiles in block_row-major order.

    Returns ``(lum (N,8,8), r (N,8,4), b (N,8,4))`` uint8, zero-padded at
    ragged edges like ``divide_image`` (JPEG.c:512-523).  Pure reshapes +
    pads — no gathers — so XLA keeps it in registers.
    """
    h, w = y.shape
    bpc, bpr = -(-h // 8), -(-w // 8)

    def tile(plane, th, tw, bh, bw):
        if plane.shape != (bh * th, bw * tw):
            # Ragged edge: zero-pad like divide_image (JPEG.c:512-523).
            # Shapes are static under jit, so evenly divisible images
            # (every power-of-two bench size) skip this copy entirely.
            padded = jnp.zeros((bh * th, bw * tw), dtype=plane.dtype)
            plane = padded.at[: plane.shape[0], : plane.shape[1]].set(plane)
        return (
            plane.reshape(bh, th, bw, tw)
            .transpose(0, 2, 1, 3)
            .reshape(bh * bw, th, tw)
        )

    lum = tile(y, 8, 8, bpc, bpr)
    r = tile(cr_sub, 8, 4, bpc, bpr)
    b = tile(cb_sub, 8, 4, bpc, bpr)
    return lum, r, b


def merge_mcus(tiles: jnp.ndarray, bpc: int, bpr: int) -> jnp.ndarray:
    """(N, th, tw) tiles → (bpc*th, bpr*tw) plane (inverse of split_mcus)."""
    n, th, tw = tiles.shape
    return (
        tiles.reshape(bpc, bpr, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(bpc * th, bpr * tw)
    )


def ycbcr_planes_to_rgb(
    y_plane: jnp.ndarray,
    cr_sub: jnp.ndarray,
    cb_sub: jnp.ndarray,
    height: int,
    width: int,
    dtype=jnp.float32,
    chroma_upsampled: bool = False,
) -> jnp.ndarray:
    """Plane-view YCbCr → RGB merge (``assemble_image``,
    JPEG.c:598-604) — identical arithmetic to ``ycbcr_to_rgb_mcus`` but
    fed reconstructed PLANES, so there is no ``merge_mcus`` tile
    relayout anywhere in the inverse chain (the decode mirror of the
    plane-view forward)."""
    y = y_plane.astype(jnp.int32)
    if chroma_upsampled:
        # Full-width chroma planes (the upsample was folded into the
        # inverse basis, ops/fused.py) — no lane-interleave repeat here.
        cr = cr_sub.astype(dtype)
        cb = cb_sub.astype(dtype)
    else:
        cr = jnp.repeat(cr_sub, 2, axis=1).astype(dtype)
        cb = jnp.repeat(cb_sub, 2, axis=1).astype(dtype)

    cr_term = jnp.trunc(1.402 * (cr - 128)).astype(jnp.int32)
    g_cb = jnp.trunc(0.344136 * (cb - 128)).astype(jnp.int32)
    g_cr = jnp.trunc(0.714136 * (cr - 128)).astype(jnp.int32)
    cb_term = jnp.trunc(1.772 * (cb - 128)).astype(jnp.int32)

    rr = jnp.clip(y + cr_term, 0, 255)
    gg = jnp.clip(y - g_cb - g_cr, 0, 255)
    bb = jnp.clip(y + cb_term, 0, 255)
    rgb = jnp.stack([rr, gg, bb], axis=-1).astype(jnp.uint8)
    return rgb[:height, :width]


def ycbcr_to_rgb_mcus(
    lum: jnp.ndarray,
    r: jnp.ndarray,
    b: jnp.ndarray,
    bpc: int,
    bpr: int,
    height: int,
    width: int,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Batched MCU YCbCr → (H, W, 3) uint8 RGB (``assemble_image``).

    Chroma columns are duplicated horizontally (4:2:2 upsampling, each
    chroma sample serves local columns 2k and 2k+1, JPEG.c:590-595), and
    each product term is truncated to int separately before combination.
    """
    y_plane = merge_mcus(lum, bpc, bpr).astype(jnp.int32)
    cr_plane = jnp.repeat(merge_mcus(r, bpc, bpr), 2, axis=1).astype(dtype)
    cb_plane = jnp.repeat(merge_mcus(b, bpc, bpr), 2, axis=1).astype(dtype)

    cr_term = jnp.trunc(1.402 * (cr_plane - 128)).astype(jnp.int32)
    g_cb = jnp.trunc(0.344136 * (cb_plane - 128)).astype(jnp.int32)
    g_cr = jnp.trunc(0.714136 * (cr_plane - 128)).astype(jnp.int32)
    cb_term = jnp.trunc(1.772 * (cb_plane - 128)).astype(jnp.int32)

    rr = jnp.clip(y_plane + cr_term, 0, 255)
    gg = jnp.clip(y_plane - g_cb - g_cr, 0, 255)
    bb = jnp.clip(y_plane + cb_term, 0, 255)
    rgb = jnp.stack([rr, gg, bb], axis=-1).astype(jnp.uint8)
    return rgb[:height, :width]
