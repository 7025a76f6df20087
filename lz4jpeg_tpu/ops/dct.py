"""Batched 2-D DCT-II / IDCT as matmuls.

The reference computes each coefficient with a quadruple loop and on-the-fly
``cos()`` in double — O(N²·M²) transcendentals per block
(``discrete_cosine_transform``, JPEG.c:451-494).  The batched formulation
precomputes the orthonormal basis once and evaluates the whole batch as two
matrix products per block,

    C = (α_h α_wᵀ) ⊙ (A_h · (X − 128) · A_wᵀ),

batched over all MCUs with a single einsum → two matmuls for the entire
image.  The basis is built in float64 and cast, so the fast float32 path and
the exact float64 path share code.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def dct_basis(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns ``(A, alpha)``: ``A[u, x] = cos(pi (2x+1) u / 2n)`` and the
    orthonormal scale ``alpha[u]`` (sqrt(1/n) for u=0, else sqrt(2/n))."""
    u = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * (2 * x + 1) * u / (2.0 * n))
    alpha = np.full(n, np.sqrt(2.0 / n))
    alpha[0] = np.sqrt(1.0 / n)
    return basis, alpha


def dct2_batched(values: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(N, H, W) uint8 pixel tiles → (N, H, W) DCT coefficients.

    Level-shifts by −128 first (JPEG.c:465-468), then applies the separable
    orthonormal transform.  ``preferred_element_type`` keeps the
    product accumulating in float32 even if inputs are cast lower.
    """
    n, h, w = values.shape
    ah, alpha_h = dct_basis(h)
    aw, alpha_w = dct_basis(w)
    x = values.astype(dtype) - 128.0
    ah = jnp.asarray(ah, dtype)
    aw = jnp.asarray(aw, dtype)
    # "highest": IEEE fp32 products.  A lower default (TF32 on the GPU's
    # tensor cores) flips quantized coefficients across trunc boundaries.
    coeff = jnp.einsum(
        "ux,nxy,vy->nuv", ah, x, aw, preferred_element_type=dtype,
        precision="highest",
    )
    scale = jnp.asarray(np.outer(alpha_h, alpha_w), dtype)
    return coeff * scale


def idct2_batched(coefficients: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """(N, H, W) coefficients → (N, H, W) uint8 pixels.

    Applies the transposed basis, shifts +128, rounds half-away-from-zero
    (C ``round()``) and clamps to [0, 255] (JPEG.c:439-445).
    """
    n, h, w = coefficients.shape
    ah, alpha_h = dct_basis(h)
    aw, alpha_w = dct_basis(w)
    scale = jnp.asarray(np.outer(alpha_h, alpha_w), dtype)
    c = coefficients.astype(dtype) * scale
    ah = jnp.asarray(ah, dtype)
    aw = jnp.asarray(aw, dtype)
    x = jnp.einsum(
        "ux,nuv,vy->nxy", ah, c, aw, preferred_element_type=dtype,
        precision="highest",
    )
    shifted = x + 128.0
    rounded = jnp.sign(shifted) * jnp.floor(jnp.abs(shifted) + 0.5)
    return jnp.clip(rounded, 0, 255).astype(jnp.uint8)
