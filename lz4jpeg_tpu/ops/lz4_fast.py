"""Device fast-mode LZ4 match finding: gather-free sort-based hash chains.

The parity matcher (``ops/match.py``) materializes the full (P, P)
match-length table per block — exact, but O(P²) memory, fine only for the
reference's 300-byte blocks.  This module is the scalable fast-mode design
(SURVEY.md §7 step 9) for 16 KiB blocks, built from multi-operand sorts,
shifts, and elementwise compares, with no data-dependent gathers or
scatters and one short ``lax.scan``:

1. **Candidates by sort.**  ``w32[i]`` packs the 4-byte window at ``i``;
   one ``lax.sort`` keyed by ``(hash(w32), i)`` makes each position's
   candidate its sorted predecessor (the most recent previous position in
   the same hash bucket) — the batched equivalent of LZ4's hash table,
   with every position inserted, and the predecessor reachable by a
   *shift* instead of a gather.  A direct ``w32`` compare removes hash
   false positives exactly.  The two-back neighbor is a second shift and
   doubles as a free second chain entry.
2. **Match lengths by payload carry.**  The sort carries the suffix's
   first ``4*LCP_WORDS`` bytes as extra operands (each is just ``w32``
   shifted — no gathers to build); the LCP of sorted neighbors is a
   word-wise elementwise compare plus a byte refinement inside the first
   differing word.  Match lengths are therefore capped at ``4*LCP_WORDS``
   bytes — longer matches simply split into several sequences (measured
   ~1% ratio cost on text at 64 B; window/offset semantics unchanged).
3. **Un-sort by a second sort** keyed by position (payloads: length,
   distance) — the inverse permutation without a gather.
4. **Greedy parse, segment-anchored.**  Matches are truncated at
   ``SEG``-byte segment boundaries, which makes every segment's greedy
   scan independent: the parse is a ``lax.scan`` of ``SEG`` lockstep
   steps over all ``B·P/SEG`` segments at once, instead of ``P`` steps
   per block (the reference's per-thread walk,
   ``Algorithms/parallel/LZ4/LZ4.c:518``, is this loop; here it is
   vectorized across segments).

Output feeds the LZ4T frame (``formats/fast_frame.py``) with
``block_log=14``; the stream decodes with the existing native/Python
decoders.  Match *choices* differ from the host encoder's (both are valid
LZ4T streams; compression ratio is what varies).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DEVICE_BLOCK_LOG = 14  # 16 KiB blocks: dist fits the 64 KiB window trivially
_HASH_MULT = 2654435761

LCP_WORDS = 4  # carried suffix words → in-parse match cap 4*LCP_WORDS bytes
# Extension at emission (formats/fast_frame.py) recovers the capped
# lengths, so the carry width mainly shapes parse choices.
SEG = 512  # parse segment: matches never cross a segment boundary
# Longer segments give the greedy parse more room (better ratio); the
# scan's SEG lockstep steps are cheap next to the two sorts.


def pad_blocks_fast(data: bytes, block_log: int = DEVICE_BLOCK_LOG):
    """Split into (B, 2**block_log) uint8-valued int32 blocks + lengths."""
    p = 1 << block_log
    n = len(data)
    num = max(1, -(-n // p))
    arr = np.frombuffer(data, np.uint8)
    padded = np.zeros((num, p), np.int32)
    lengths = np.zeros(num, np.int32)
    for i in range(num):
        chunk = arr[i * p : (i + 1) * p]
        padded[i, : len(chunk)] = chunk
        lengths[i] = len(chunk)
    return padded, lengths


def _leading_equal_bytes(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-element count (0-4) of leading equal bytes of two uint32 words
    (little-endian byte order: byte 0 is the low byte)."""
    x = a ^ b
    return (
        (x & 0x000000FF == 0).astype(jnp.int32)
        + (x & 0x0000FFFF == 0).astype(jnp.int32)
        + (x & 0x00FFFFFF == 0).astype(jnp.int32)
        + (x == 0).astype(jnp.int32)
    )


def _lcp_from_payloads(pay, shift: int) -> jnp.ndarray:
    """LCP (in bytes, ≤ 4*LCP_WORDS) between sorted row ``s`` and row
    ``s-shift``, from the carried suffix words — pure shifts + compares."""
    b = pay[0].shape[0]
    zeros = jnp.zeros((b, shift), pay[0].dtype)
    lcp = jnp.zeros(pay[0].shape, jnp.int32)
    alive = jnp.ones(pay[0].shape, jnp.bool_)
    for w in pay:
        prev = jnp.concatenate([zeros, w[:, :-shift]], axis=1)
        eq_bytes = _leading_equal_bytes(w, prev)
        lcp = lcp + jnp.where(alive, eq_bytes, 0)
        alive = alive & (eq_bytes == 4)
    return lcp


def fast_match_blocks(
    blocks: jnp.ndarray,
    lengths: jnp.ndarray,
    max_dist: int = 65535,
    lcp_words: int = LCP_WORDS,
    seg: int = SEG,
):
    """(B, P) int32 blocks + (B,) lengths → greedy parse fields.

    Returns ``(is_match, emit_len, emit_dist)`` (B, P) int32, ready for
    LZ4T sequence emission.  ``lcp_words`` sets the carried-suffix width
    (the in-parse match-length cap is ``4*lcp_words``; emission extends
    matches greedily past the cap, so it mainly shapes parse choices).
    ``seg`` (a power of two dividing P) sets the parse segment length:
    the lockstep greedy scan runs ``seg`` steps over ``B*P/seg``
    independent segments.
    """
    b, p = blocks.shape
    idx = jnp.arange(p, dtype=jnp.int32)
    x = blocks.astype(jnp.int32)  # accept uint8 uploads (4× cheaper h2d)

    def sh(k):
        return jnp.pad(x[:, k:], ((0, 0), (0, k)))

    def pack32(k):
        return (
            sh(k).astype(jnp.uint32)
            | (sh(k + 1).astype(jnp.uint32) << 8)
            | (sh(k + 2).astype(jnp.uint32) << 16)
            | (sh(k + 3).astype(jnp.uint32) << 24)
        )

    w32 = pack32(0)
    window_ok = idx[None, :] + 4 <= lengths[:, None]
    h = (w32 * jnp.uint32(_HASH_MULT)) >> jnp.uint32(16)  # 16-bit buckets
    # Invalid windows get a per-position unique bucket so they never chain.
    h = jnp.where(window_ok, h.astype(jnp.int32), 0x10000 + idx[None, :])

    # One packed key: (bucket << pos_bits) | position — a single int32
    # compare per bitonic stage instead of a two-key lexicographic one.
    pos_bits = (p - 1).bit_length()
    key = (h << pos_bits) | idx[None, :]
    payload_words = [pack32(4 * k) for k in range(lcp_words)]
    key_s, *pay_s = jax.lax.sort(
        (key, *payload_words), dimension=1, num_keys=1
    )
    h_s = key_s >> pos_bits
    pos_s = key_s & (p - 1)

    def candidate(shift: int):
        """Match fields against the ``shift``-back sorted neighbor."""
        pad_head = jnp.full((b, shift), -1, jnp.int32)
        same = jnp.concatenate(
            [
                jnp.zeros((b, shift), jnp.bool_),
                h_s[:, shift:] == h_s[:, :-shift],
            ],
            axis=1,
        ) & (h_s < 0x10000)
        prev_pos = jnp.concatenate([pad_head, pos_s[:, :-shift]], axis=1)
        dist = pos_s - prev_pos
        # lcp >= 4 IS the exact first-window verification (the first carried
        # word must byte-equal the neighbor's), so hash false positives are
        # rejected without a separate compare.
        lcp = _lcp_from_payloads(pay_s, shift)
        ok = same & (dist <= max_dist) & (lcp >= 4)
        return jnp.where(ok, lcp, 0), jnp.where(ok, dist, 0)

    len1, dist1 = candidate(1)
    len2, dist2 = candidate(2)
    better2 = len2 > len1  # prefer the longer; ties keep the nearer (1-back)
    cand_len = jnp.where(better2, len2, len1)
    cand_dist = jnp.where(better2, dist2, dist1)

    # Un-sort: one more sort keyed by position restores original order;
    # (len, dist) ride packed into a single int32 payload (len ≤ 4*LCP_WORDS,
    # dist < P ≤ 2**pos_bits).
    _, lendist = jax.lax.sort(
        (pos_s, (cand_len << pos_bits) | cand_dist), dimension=1, num_keys=1
    )
    match_len = lendist >> pos_bits
    match_dist = lendist & (p - 1)

    # Caps: block's true end, and the parse segment boundary (so segments
    # parse independently).  Re-check the 4-byte minimum afterwards.
    seg_left = seg - (idx[None, :] & (seg - 1))
    limit = jnp.minimum(lengths[:, None] - idx[None, :], seg_left)
    match_len = jnp.minimum(match_len, jnp.maximum(limit, 0))
    match_len = jnp.where(match_len >= 4, match_len, 0)
    match_dist = jnp.where(match_len > 0, match_dist, 0)

    # Greedy parse: ``seg`` lockstep steps over every segment of every
    # block at once (carry = per-segment skip pointer).
    nseg = (b * p) // seg
    seg_len = match_len.reshape(nseg, seg)
    seg_dist = match_dist.reshape(nseg, seg)

    def stepf(skip_until, inputs):
        k, ml, d = inputs
        is_m = (k >= skip_until) & (ml > 0)
        new_skip = jnp.where(is_m, k + ml, skip_until).astype(jnp.int32)
        return new_skip, (
            is_m,
            jnp.where(is_m, ml, 0),
            jnp.where(is_m, d, 0),
        )

    _, outs = jax.lax.scan(
        stepf,
        jnp.zeros(nseg, jnp.int32),
        (
            jnp.arange(seg, dtype=jnp.int32),
            seg_len.T,
            seg_dist.T,
        ),
    )
    is_match, emit_len, emit_dist = (o.T.reshape(b, p) for o in outs)
    return (
        is_match.astype(jnp.int32),
        emit_len.astype(jnp.int32),
        emit_dist.astype(jnp.int32),
    )


def compact_parse(is_match, emit_len, emit_dist):
    """Parse fields → sparse per-block match records, device-side.

    Dense (B, P) parse fields are 12 P bytes per block to move to the
    host.  One more 2-operand sort compacts each block's matches to the
    front in position order — ``(positions, len<<pos_bits|dist, counts)``
    — so the host fetches only ``max(counts)`` records per block
    (typically P/10).  Gather/scatter-free like everything else here.
    """
    b, p = is_match.shape
    pos_bits = (p - 1).bit_length()
    idx = jnp.arange(p, dtype=jnp.int32)[None, :]
    key = jnp.where(is_match > 0, idx, p)
    payload = (emit_len << pos_bits) | emit_dist
    pos_sorted, packed = jax.lax.sort((key, payload), dimension=1, num_keys=1)
    counts = jnp.sum(is_match > 0, axis=1, dtype=jnp.int32)
    return pos_sorted, packed, counts
