"""LZ4 match finding as a batched, vectorized device op.

The reference's hot loop is a brute-force O(n²·L) scan per position
(``find_longest_match``, LZ4.c:290-323).  The batched formulation computes the
*entire* match-length table of a block at once, for all blocks in parallel:

1. ``EQ[d, k] = x[k] == x[k-d]`` — a (P, P) byte-compare matrix per block
   (one VPU pass over a gathered shift matrix);
2. run lengths ``R[d, k]`` = length of the leading-ones run of ``EQ[d]``
   starting at ``k``, via a *reversed cumulative min* over next-zero
   positions — an associative scan instead of a serial suffix walk;
3. per-position best match = max over ``d`` with ties broken toward the
   **largest** ``d`` (the reference scans candidates oldest→newest with a
   strict ``>``, so the earliest position / largest offset wins,
   LZ4.c:307-311).

The greedy parse that follows (positions consumed by a match emit nothing)
is a sequential dependency; it runs as a ``lax.scan`` over positions with a
1-element carry, vmapped over blocks — O(P) lockstep steps while the O(P²)
table work stays fully parallel.

Padding: blocks are right-padded with *distinct negative* sentinels so
padding never matches anything (including itself), which caps every run at
the true block end — reproducing the oracle's block-end semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MIN_MATCH_LENGTH = 4


def pad_blocks(data: bytes, block_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Split ``data`` into (B, P) int32 blocks padded with distinct
    negatives, plus the (B,) true lengths."""
    n = len(data)
    num_blocks = -(-n // block_length)
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    padded = np.empty((num_blocks, block_length), np.int32)
    sentinel = -(np.arange(block_length, dtype=np.int32) + 1)
    lengths = np.empty(num_blocks, np.int32)
    for i in range(num_blocks):
        chunk = arr[i * block_length : (i + 1) * block_length]
        lengths[i] = len(chunk)
        padded[i, : len(chunk)] = chunk
        padded[i, len(chunk) :] = sentinel[len(chunk) :]
    return padded, lengths


@functools.partial(jax.jit, static_argnames=("max_match",))
def match_tables(blocks: jnp.ndarray, max_match: int = 1024):
    """(B, P) int32 blocks → per-position best matches.

    Returns ``(best_len, best_dist)``, both (B, P) int32: the reference's
    *untruncated* greedy best match length (0 where < MIN_MATCH) and its
    distance.  Downstream parity code applies the uint8 truncation.
    """
    b, p = blocks.shape
    k = jnp.arange(p)
    d = jnp.arange(p)
    # shifted[n, d, k] = blocks[n, k - d]  (clamped; d=0 row unused)
    idx = jnp.maximum(k[None, :] - d[:, None], 0)
    shifted = blocks[:, idx]  # (B, P, P)
    eq = (shifted == blocks[:, None, :]) & (k[None, :] >= d[:, None])
    # next zero position at or after k, per (n, d) row: reversed cummin of
    # (k where ~eq else P).
    zpos = jnp.where(eq, p, k[None, None, :])
    next_zero = jax.lax.cummin(zpos[..., ::-1], axis=zpos.ndim - 1)[..., ::-1]
    run = next_zero - k[None, None, :]  # R[d, k], 0 where eq[k] is False
    run = jnp.minimum(run, max_match)
    # Valid candidates: 1 <= d <= k (candidate j = k - d >= 0).
    valid = (d[None, :, None] >= 1) & (d[None, :, None] <= k[None, None, :])
    run = jnp.where(valid, run, -1)
    # Tie-break toward largest d: argmax over reversed d keeps the first
    # (= largest-d) maximum.
    rev = run[:, ::-1, :]
    arg_rev = jnp.argmax(rev, axis=1)
    best_len = jnp.take_along_axis(rev, arg_rev[:, None, :], axis=1)[:, 0, :]
    best_dist = p - 1 - arg_rev  # d of the winning row
    found = best_len >= MIN_MATCH_LENGTH
    return (
        jnp.where(found, best_len, 0).astype(jnp.int32),
        jnp.where(found, best_dist, 0).astype(jnp.int32),
    )


@jax.jit
def greedy_parse(best_len: jnp.ndarray, best_dist: jnp.ndarray):
    """Greedy left-to-right parse (``block_encode``'s while loop,
    LZ4.c:516-583) as a vmapped ``lax.scan``.

    A position starts a match iff it is not consumed by a previous match
    and its (uint8-truncated) best length is ≥ 1; otherwise it is a literal
    — except that a *zero* truncated length (true length ≡ 0 mod 256)
    degrades to a literal exactly like the reference, where
    ``find_longest_match`` returns 0 and the encoder emits a literal.

    Returns ``(is_match_start, emit_len, emit_dist)``, all (B, P) int32,
    where ``emit_len`` is the truncated length the parse advances by.
    """
    len_u8 = best_len & 0xFF

    def parse_one(lens, dists):
        def step(skip_until, inputs):
            k, ml, dist = inputs
            consumed = k < skip_until
            is_match = (~consumed) & (ml > 0)
            new_skip = jnp.where(is_match, k + ml, skip_until).astype(jnp.int32)
            return new_skip, (is_match, jnp.where(is_match, ml, 0),
                              jnp.where(is_match, dist, 0))

        p = lens.shape[0]
        # Derive the carry init from the input so it picks up the same
        # varying-manual-axes type under shard_map (see shard-map scan-vma).
        init = (lens[0] * 0).astype(jnp.int32)
        _, (is_match, emit_len, emit_dist) = jax.lax.scan(
            step,
            init,
            (jnp.arange(p, dtype=jnp.int32), lens, dists),
        )
        return is_match, emit_len, emit_dist

    return jax.vmap(parse_one)(len_u8.astype(jnp.int32), best_dist)
