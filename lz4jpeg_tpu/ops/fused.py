"""Fused MCU transforms: the whole per-block JPEG chain as one matmul.

The reference runs DCT (quadruple loop with on-the-fly ``cos``), quantize,
and zigzag as three separate per-block passes (JPEG.c:451-494, :621-629,
:693-728).  Because every stage is linear (or a static permutation) up to
the final truncation, the *entire* chain folds into a single matrix:

    M[k, (x,y)] = alpha_u * alpha_v * cos_u[u,x] * cos_v[v,y] / table[u,v]
    with (u,v) = zigzag⁻¹(k)
    out_zz[k]   = trunc( X_flat @ Mᵀ  -  128 * Σ_xy M[k] )

i.e. one (N, 64) × (64, 64) matmul + a per-column offset + truncation,
replacing DCT + quantize + zigzag entirely.  The
inverse chain (reverse zigzag → dequantize → IDCT → +128 → round/clamp)
folds the same way.

This module holds the basis construction and the jnp implementation, which
every path uses (the fused forward kernel, ``ops/pallas_fwd.py``, contracts
against the same bases).  Parity: the fused f32 path agrees with the staged f64 exact
path *after quantization* on noise inputs (tested); the staged path
remains the oracle-exact reference.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from lz4jpeg_tpu.oracle.jpeg_oracle import zigzag_indices


def _cos_basis(n: int) -> np.ndarray:
    u = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (2 * x + 1) * u / (2.0 * n))


def _alpha(n: int) -> np.ndarray:
    a = np.full(n, np.sqrt(2.0 / n))
    a[0] = np.sqrt(1.0 / n)
    return a


@functools.lru_cache(maxsize=None)
def forward_basis(width: int, height: int, table_key: bytes):
    """(M, offset): fused DCT+quant+zigzag as (HW, HW) matrix + (HW,) offset.

    ``out_zz = trunc(X_flat @ M.T - offset)`` for X_flat row-major uint8.
    """
    table = np.frombuffer(table_key, dtype=np.int64).astype(np.float64)
    cu, cv = _cos_basis(height), _cos_basis(width)
    au, av = _alpha(height), _alpha(width)
    # full[(u,v), (x,y)] = au[u] av[v] cu[u,x] cv[v,y] / table[u,v]
    scale = np.outer(au, av).reshape(-1) / table  # (HW,) over (u,v)
    kron = np.einsum("ux,vy->uvxy", cu, cv).reshape(
        height * width, height * width
    )
    full = scale[:, None] * kron
    zz = zigzag_indices(width, height)
    m = full[zz]  # rows permuted into zigzag order
    offset = 128.0 * m.sum(axis=1)
    return m, offset


@functools.lru_cache(maxsize=None)
def inverse_basis(width: int, height: int, table_key: bytes):
    """(Minv): fused reverse-zigzag+dequant+IDCT as an (HW, HW) matrix.

    ``pixels = clamp(round(Q_zz @ Minv.T + 128))`` for zigzag-ordered
    quantized coefficients.
    """
    table = np.frombuffer(table_key, dtype=np.int64).astype(np.float64)
    cu, cv = _cos_basis(height), _cos_basis(width)
    au, av = _alpha(height), _alpha(width)
    scale = np.outer(au, av).reshape(-1) * table  # dequant folded in
    kron = np.einsum("ux,vy->xyuv", cu, cv).reshape(
        height * width, height * width
    )
    full = kron * scale[None, :]  # [(x,y), (u,v)]
    zz = zigzag_indices(width, height)
    return full[:, zz]  # columns permuted: input arrives in zigzag order


def _table_key(table: np.ndarray) -> bytes:
    return np.ascontiguousarray(table, dtype=np.int64).tobytes()


def fused_forward_jnp(
    tiles: jnp.ndarray, table: np.ndarray, width: int, height: int,
    dtype=jnp.float32, snap_eps: float = 1e-5,
) -> jnp.ndarray:
    """(N, H, W) uint8 tiles → (N, HW) quantized zigzag coefficients.

    Truncation toward zero with tie snapping (see ``ops/quantize.py``):
    ratios within ``snap_eps`` of an integer snap first, making the f32
    fused path agree with the staged f64 exact path away from pathological
    inputs (tested on noise).
    """
    m, off = forward_basis(width, height, _table_key(table))
    n = tiles.shape[0]
    x = tiles.reshape(n, height * width).astype(dtype)
    # "highest": IEEE fp32 products.  A reduced-precision default (TF32
    # on the GPU's tensor cores) flips quantized coefficients across trunc
    # boundaries; the residue at highest is f32-vs-f64 rounding at
    # boundaries, inherent to the fast path (exact mode stays the oracle).
    ratio = jnp.matmul(
        x, jnp.asarray(m.T, dtype), precision="highest"
    ) - jnp.asarray(off, dtype)
    nearest = jnp.round(ratio)
    ratio = jnp.where(jnp.abs(ratio - nearest) <= snap_eps, nearest, ratio)
    return jnp.trunc(ratio)


def fused_forward_plane_jnp(
    plane: jnp.ndarray, table: np.ndarray, width: int,
    dtype=jnp.float32, snap_eps: float = 1e-5,
) -> jnp.ndarray:
    """Plane-view fused forward: (H, Wp) uint8 channel plane →
    (bh, 8·width, bw) quantized zigzag coefficients, WITHOUT the 8×8 tile
    relayout (``split_mcus``) — the einsum contracts straight over the
    plane's (row-in-block, col-in-block) view, and the output keeps block
    positions along the middle axis (the KT layout the plane-view inverse
    takes; tests use the pair as a reference).

    Same contraction as ``fused_forward_jnp`` of the relayouted tiles,
    in another association order.  Requires H % 8 == 0 and Wp % width == 0.
    """
    m, off = forward_basis(width, 8, _table_key(table))
    h, wp = plane.shape
    bh, bw = h // 8, wp // width
    x = plane.reshape(bh, 8, bw, width).astype(dtype)
    mt = jnp.asarray(m.reshape(8 * width, 8, width), dtype)
    ratio = jnp.einsum(
        "krc,arbc->akb", mt, x, precision="highest"
    ) - jnp.asarray(off, dtype)[None, :, None]
    nearest = jnp.round(ratio)
    ratio = jnp.where(jnp.abs(ratio - nearest) <= snap_eps, nearest, ratio)
    return jnp.trunc(ratio)


def fused_inverse_plane_jnp(
    zz_kt: jnp.ndarray, table: np.ndarray, width: int,
    dtype=jnp.float32, upsample_cols: bool = False,
) -> jnp.ndarray:
    """Plane-view fused inverse: (bh, HW, bw) KT-layout zigzag quantized
    coefficients → (8·bh, width·bw) uint8 channel plane, WITHOUT the
    per-MCU tile relayout (``merge_mcus``) — the decode mirror of
    ``fused_forward_plane_jnp``.  The einsum's output axes (a, u, b, v)
    reshape straight into the plane: row = 8a+u, col = width·b+v, both
    contiguous merges.

    Same contraction, precision="highest", same C-round semantics as
    ``fused_inverse_jnp`` + ``merge_mcus``; an accelerator may accumulate
    the 64-length dots of the strided einsum in another association,
    which can flip a plane value by ±1 at the round-half boundary (the
    CPU lowering is bitwise identical).  After the color combine the RGB
    envelope vs the tile path is ±3 (G sums three independently
    truncated terms).  The fast path's contract is "within a couple of
    levels of exact f64" (tests/test_jpeg_pipeline.py), which both
    formulations satisfy; the plane form deletes ``merge_mcus``.
    """
    minv = inverse_basis(width, 8, _table_key(table))
    bh, hw, bw = zz_kt.shape
    mi_np = minv.T.reshape(hw, 8, width)
    out_w = width
    if upsample_cols:
        # Fold the 4:2:2 horizontal upsample INTO the basis: duplicating
        # each Minv column makes the matmul emit both output pixels of a
        # chroma sample directly — bit-identical to round-then-repeat
        # (the dot is the same; round/clip commute with duplication) and
        # it deletes the (H, W/2)→(H, W) interleave relayout in the color
        # merge.
        mi_np = np.repeat(mi_np, 2, axis=2)
        out_w = 2 * width
    mi = jnp.asarray(mi_np, dtype)
    pix = jnp.einsum(
        "akb,kuv->aubv", zz_kt.astype(dtype), mi, precision="highest"
    ) + 128.0
    rounded = jnp.sign(pix) * jnp.floor(jnp.abs(pix) + 0.5)
    return (
        jnp.clip(rounded, 0, 255)
        .astype(jnp.uint8)
        .reshape(8 * bh, out_w * bw)
    )


@functools.lru_cache(maxsize=None)
def inverse_suffix_basis(width: int, height: int, table_key: bytes):
    """Suffix-summed inverse basis: folds the RLE expansion into the IDCT.

    With the sparse-delta layout (``ops/rle.py::rle_encode_sparse16``)
    the zigzag coefficients are ``zz[k] = Σ_{m≤k} Δ[m]``, so

        pixels = Σ_k Minv[p, k] · zz[k] = Σ_m Δ[m] · (Σ_{k≥m} Minv[p, k])

    i.e. one matmul straight from the deltas, with the suffix sums
    precomputed here in f64 (a column-reversed cumsum of
    ``inverse_basis``).  The decode chain's expansion stage disappears.
    Reference inverse chain: JPEG.c:399-448, :811-842.
    """
    minv = inverse_basis(width, height, table_key)
    return np.cumsum(minv[:, ::-1], axis=1)[:, ::-1].copy()


def fused_inverse_plane_sparse_jnp(
    d_kt: jnp.ndarray, table: np.ndarray, width: int,
    dtype=jnp.float32, upsample_cols: bool = False,
) -> jnp.ndarray:
    """Plane-view fused inverse from SPARSE-DELTA coefficients:
    (bh, HW, bw) KT-layout integer value-deltas (already un-biased) →
    (8·bh, width·bw or 2·width·bw) uint8 channel plane.

    Identical structure to ``fused_inverse_plane_jnp`` but contracting
    with ``inverse_suffix_basis`` — the RLE expansion rides the same
    matmul.  Precision contract:
    the fold reassociates the k-sum (suffix sums are rounded to f32 once
    instead of per-term), which flips ~1e-4 of pixels by ±1 at the
    round-half boundary vs the two-step path — the same envelope as the
    plane-vs-tile formulation difference already shipped (docstring of
    ``fused_inverse_plane_jnp``)."""
    m2 = inverse_suffix_basis(width, 8, _table_key(table))
    bh, hw, bw = d_kt.shape
    mi_np = m2.T.reshape(hw, 8, width)
    out_w = width
    if upsample_cols:
        # Same basis-folded 4:2:2 upsample as the pair-layout path.
        mi_np = np.repeat(mi_np, 2, axis=2)
        out_w = 2 * width
    mi = jnp.asarray(mi_np, dtype)
    pix = jnp.einsum(
        "akb,kuv->aubv", d_kt.astype(dtype), mi, precision="highest"
    ) + 128.0
    rounded = jnp.sign(pix) * jnp.floor(jnp.abs(pix) + 0.5)
    return (
        jnp.clip(rounded, 0, 255)
        .astype(jnp.uint8)
        .reshape(8 * bh, out_w * bw)
    )


def fused_inverse_jnp(
    zz: jnp.ndarray, table: np.ndarray, width: int, height: int,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """(N, HW) zigzag quantized coefficients → (N, H, W) uint8 pixels."""
    minv = inverse_basis(width, height, _table_key(table))
    n = zz.shape[0]
    pix = (
        jnp.matmul(
            zz.astype(dtype), jnp.asarray(minv.T, dtype), precision="highest"
        )
        + 128.0
    )
    # C round(): half away from zero (JPEG.c:443).
    rounded = jnp.sign(pix) * jnp.floor(jnp.abs(pix) + 0.5)
    return (
        jnp.clip(rounded, 0, 255).astype(jnp.uint8).reshape(n, height, width)
    )
