"""Zigzag reordering as a batched gather.

The reference walks anti-diagonals with per-element control flow
(``zigzag_pattern``, JPEG.c:693-728).  Here the permutation is a
compile-time constant (computed once from the oracle's literal
transcription), so the whole op is a single ``take`` along the last axis —
XLA lowers it to a vectorized gather — and in the fused transform
(``ops/fused.py``) it disappears entirely into a row permutation of the
constant basis matrix.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from lz4jpeg_tpu.oracle.jpeg_oracle import (
    reverse_zigzag_indices,
    zigzag_indices,
)


def _inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def zigzag(blocks: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """(N, H*W) or (N, H, W) blocks → (N, H*W) zigzag streams."""
    flat = blocks.reshape(blocks.shape[0], height * width)
    perm = jnp.asarray(zigzag_indices(width, height))
    return jnp.take(flat, perm, axis=1)


def reverse_zigzag(zz: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """(N, H*W) zigzag streams → (N, H*W) row-major blocks.

    Implemented as a gather with the inverse permutation of the reference's
    scatter (``reverse_zigzag_pattern``, JPEG.c:729-764) — a gather needs
    no write conflicts resolved.
    """
    sperm = reverse_zigzag_indices(width, height)
    gather = jnp.asarray(_inverse_permutation(sperm))
    return jnp.take(zz, gather, axis=1)
