"""Run-length encoding as a batched, fixed-shape vector op.

The reference RLE is a serial loop per block emitting variable-length
``[count, value]`` int pairs (JPEG.c:767-809).  The device formulation is
branch-free with static shapes (SURVEY.md §7 step 5):

* run boundaries  = ``x[i] != x[i-1]`` (elementwise compare),
* start positions = ``where(starts, i, L)`` sorted ascending per row — a
  sorting-network compaction that moves every run start to the front in
  order, carrying the run's value as a sort payload,
* per-run counts  = adjacent difference of the sorted start positions,

then counts/values are interleaved into a zero-padded ``(N, 2L)`` buffer
with a ``(N,)`` valid-length side channel — the standard variable-length-
output-on-SIMD pattern (pad + mask + size side channel).

The production interchange is the SPARSE-DELTA layout
(``rle_encode_sparse16`` below), which needs no compaction at all; the
pair layouts remain as the exact-mode path and the tested packed16 spec.
Decode of the pair layouts inverts with a disjoint-interval membership
einsum — vectorized, unlike the reference's nested fill loops
(JPEG.c:811-842) — while sparse16 decode is a prefix sum that folds into
the inverse DCT einsum entirely (``ops/fused.py::inverse_suffix_basis``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rle_encode_batched(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(N, L) int32 blocks → ((N, 2L) padded [count,value] pairs, (N,) lengths).

    Values must already be integral (the reference compares after ``(int)``
    truncation; quantized coefficients are — truncate first if not).
    Pass 16-bit inputs when the value range allows (quantized zigzag
    coefficients are bounded by ±√(HW)·128 ≤ 1024): the packed
    single-operand sort path below then halves the op's HBM traffic.

    Sort-diff compaction: run starts keyed by position (non-starts keyed
    ``L``) sort to the front in original order, the run's first element
    rides along as a payload, and each run's length is the gap to the next
    sorted start.  One sort + one adjacent diff — no prefix scans, no
    (L, L) one-hot, no gathers/scatters.
    """
    counts, run_values, num_runs = _rle_runs(values)
    n, length = counts.shape
    pairs = jnp.stack([counts, run_values], axis=2).reshape(n, 2 * length)
    return pairs, 2 * num_runs


def _rle_runs(values: jnp.ndarray):
    """Shared core: (N, L) blocks → (counts, run_values, num_runs), each
    (N, L) / (N,), valid runs front-compacted, invalid slots zero."""
    x = values.astype(jnp.int32)
    n, length = x.shape
    idx = jnp.arange(length, dtype=jnp.int32)
    starts = jnp.concatenate(
        [jnp.ones((n, 1), jnp.bool_), x[:, 1:] != x[:, :-1]], axis=1
    )
    key = jnp.where(starts, idx, length)
    if values.dtype.itemsize <= 2:
        # 16-bit inputs: pack key and payload into one int32 word
        # (key in the high bits dominates the comparison, the biased
        # value rides in the low 16).  The sort is the only op in the
        # forward chain XLA cannot fuse — its operands round-trip HBM —
        # so one packed operand instead of (key, payload) halves the
        # chain's dominant memory traffic.  Valid-slot keys are unique
        # positions, so the low bits never affect their ordering.
        packed = (key << 16) + (x + 32768)
        (packed_sorted,) = jax.lax.sort((packed,), dimension=1, num_keys=1)
        key_sorted = packed_sorted >> 16
        val_sorted = (packed_sorted & 0xFFFF) - 32768
    else:
        key_sorted, val_sorted = jax.lax.sort(
            (key, x), dimension=1, num_keys=1
        )
    # Start positions are strictly increasing, so slot k's run ends where
    # slot k+1's begins (or at L for the last run / invalid slots).
    nxt = jnp.concatenate(
        [key_sorted[:, 1:], jnp.full((n, 1), length, jnp.int32)], axis=1
    )
    valid_run = key_sorted < length
    counts = jnp.where(valid_run, nxt - key_sorted, 0)
    run_values = jnp.where(valid_run, val_sorted, 0)
    num_runs = jnp.sum(starts, axis=1, dtype=jnp.int32)
    return counts, run_values, num_runs


PACK16_VALUE_BIAS = 512  # value+512 in the low 10 bits, count-1 in the top 6


def rle_encode_packed16(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``rle_encode_batched`` with each [count, value] pair packed into ONE
    uint16: ``(count-1) << 10 | (value + 512)``.

    Halves the device→host bytes of the dominant transfer in the JPEG
    encode path.  Valid iff counts ≤ 64 (always —
    blocks are ≤64 symbols) and |value| ≤ 511, i.e. quantization tables
    with min entry ≥ 3 (the reference tables have min 6 / 17; extreme
    ``quality`` settings fall back to the int16 pair layout).

    Returns ``(packed (N, L) uint16, lengths (N,))`` where ``lengths``
    counts *symbols* (2·runs), matching ``rle_encode_batched``.

    Built straight from the run arrays, not by interleaving pairs and
    splitting them again (that round trip adds two strided minor-dim
    slices per block).
    """
    counts, run_values, num_runs = _rle_runs(values)
    packed = (
        jnp.maximum(counts - 1, 0) << 10
    ) | (run_values + PACK16_VALUE_BIAS)
    packed = jnp.where(counts > 0, packed, 0).astype(jnp.uint16)
    return packed, 2 * num_runs


def pack16_pairs(pairs: jnp.ndarray) -> jnp.ndarray:
    """(N, 2L) interleaved [count, value] pairs → (N, L) packed uint16.

    Padding slots (count 0) stay 0, so packed streams compare equal across
    the device packer, the host packer and the native decode re-blocker."""
    counts = pairs.astype(jnp.int32)[:, 0::2]
    vals = pairs.astype(jnp.int32)[:, 1::2]
    packed = (
        jnp.maximum(counts - 1, 0) << 10
    ) | (vals + PACK16_VALUE_BIAS)
    return jnp.where(counts > 0, packed, 0).astype(jnp.uint16)


def unpack16_pairs(packed: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(N, L) uint16 → (counts (N, L) int32, values (N, L) int32).

    Invalid (padding) slots decode to count=1 / value=0; callers mask by
    the lengths side channel exactly as with the int pair layout.
    """
    p = packed.astype(jnp.int32)
    return (p >> 10) + 1, (p & 0x3FF) - PACK16_VALUE_BIAS


SPARSE16_DELTA_BIAS = 1024  # biased value delta; valid slots are nonzero

# The combined sparse16 buffer: one (N, 128) uint16 row per 8x8 MCU,
# lanes [0, 64) luma, [64, 96) Cr, [96, 128) Cb.  The one channel→lane
# mapping every consumer shares (models, container, kernels, benches).
COMBINED_LANES = 128
LUM_SLICE = slice(0, 64)
CR_SLICE = slice(64, 96)
CB_SLICE = slice(96, 128)
CHANNEL_SLICES = {"lum": LUM_SLICE, "r": CR_SLICE, "b": CB_SLICE}


def rle_encode_sparse16(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(N, L) int blocks → ((N, L) sparse-delta uint16, (N,) symbol lengths).

    The interchange layout: slot ``m`` holds the run's VALUE DELTA
    (``x[m] - x[m-1]``, with ``x[-1] := 0``) biased by 1024 at run starts,
    and exactly 0 elsewhere.  Three properties make it better than the
    pair layout:

    * no compaction: runs stay at their start positions, so encode is a
      mask + one shift + select — the sort of ``rle_encode_batched``
      disappears;
    * within a run all values are equal, so the previous element ALWAYS
      holds the previous run's value — the delta needs one shift, not a
      scan;
    * decode is an inclusive prefix sum of the deltas
      (``out[p] = Σ_{m≤p} Δ[m]``), which is linear — it FOLDS into the
      inverse DCT einsum (``ops/fused.py::fused_inverse_plane_sparse``),
      deleting the expansion stage from the decode chain entirely.

    Bijective with ``rle_encode_packed16`` (same information, same bytes:
    L uint16 per block); ``lengths`` counts symbols (2·runs), identically.
    Valid slots are nonzero by construction: slot 0 is always a start
    (bias 1024 ≠ 0 even for delta 0) and start deltas are nonzero for
    m > 0 (run boundaries mean the value changed).  Requires |value| ≤
    511 like pack16 (delta range ±1022 → biased [2, 2046], 11 bits).

    Reference stage semantics: ``RLE``, JPEG.c:767-809 (same run
    structure, re-expressed as positions instead of pairs).
    """
    x = values.astype(jnp.int32)
    n, length = x.shape
    prev = jnp.concatenate([jnp.zeros((n, 1), jnp.int32), x[:, :-1]], axis=1)
    starts = jnp.concatenate(
        [jnp.ones((n, 1), jnp.bool_), x[:, 1:] != x[:, :-1]], axis=1
    )
    w = jnp.where(starts, x - prev + SPARSE16_DELTA_BIAS, 0)
    return w.astype(jnp.uint16), 2 * jnp.sum(starts, axis=1, dtype=jnp.int32)


def rle_decode_sparse16(sparse: jnp.ndarray) -> jnp.ndarray:
    """(N, L) sparse-delta uint16 → (N, L) int32 zigzag values.

    One inclusive prefix sum — validity is implicit (zero slots carry
    delta 0).  Production decode paths fold this sum into the inverse
    einsum instead of calling it (see ``rle_encode_sparse16``)."""
    w = sparse.astype(jnp.int32)
    d = jnp.where(w != 0, w - SPARSE16_DELTA_BIAS, 0)
    return jnp.cumsum(d, axis=-1)


def sparse16_to_packed16(sparse: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sparse-delta layout → packed16 pair layout (+ lengths).

    Exact on canonical streams (maximal runs — everything our encoders
    emit); the two layouts are bijective through the decoded values."""
    return rle_encode_packed16(rle_decode_sparse16(sparse))


def packed16_to_sparse16(packed: jnp.ndarray, lengths: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Packed16 pair layout → sparse-delta layout (+ lengths)."""
    k = packed.shape[-1]
    return rle_encode_sparse16(rle_decode_packed16(packed, lengths, k))


def rle_decode_packed16(
    packed: jnp.ndarray, lengths: jnp.ndarray, out_size: int
) -> jnp.ndarray:
    """``rle_decode_batched`` over the packed uint16 layout."""
    counts, vals = unpack16_pairs(packed)
    n, k = counts.shape
    pair_valid = jnp.arange(k, dtype=jnp.int32)[None, :] < (
        lengths.astype(jnp.int32) // 2
    )[:, None]
    counts = jnp.where(pair_valid, counts, 0)
    ends = jnp.cumsum(counts, axis=1, dtype=jnp.int32)
    begins = ends - counts
    pos = jnp.arange(out_size, dtype=jnp.int32)
    member = (
        (begins[:, None, :] <= pos[None, :, None])
        & (pos[None, :, None] < ends[:, None, :])
    ).astype(jnp.float32)
    out = jnp.einsum(
        "npk,nk->np", member, vals.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(jnp.int32)


def rle_decode_batched(
    pairs: jnp.ndarray, lengths: jnp.ndarray, out_size: int
) -> jnp.ndarray:
    """((N, 2K) pairs, (N,) valid lengths) → (N, out_size) int32, capped at
    ``out_size`` and zero-padded, matching ``inverse_RLE``.

    Gather-free: run k owns the half-open interval [end_k − count_k, end_k)
    of output positions; the intervals are disjoint, so each position's
    value is an exact one-hot contraction ``membership @ vals``.
    """
    pairs = pairs.astype(jnp.int32)
    n, two_k = pairs.shape
    k = two_k // 2
    counts = pairs[:, 0::2]
    vals = pairs[:, 1::2]
    pair_valid = jnp.arange(k, dtype=jnp.int32)[None, :] < (
        lengths.astype(jnp.int32) // 2
    )[:, None]
    counts = jnp.where(pair_valid, counts, 0)
    ends = jnp.cumsum(counts, axis=1, dtype=jnp.int32)  # (N, K)
    begins = ends - counts
    pos = jnp.arange(out_size, dtype=jnp.int32)
    member = (
        (begins[:, None, :] <= pos[None, :, None])
        & (pos[None, :, None] < ends[:, None, :])
    ).astype(jnp.float32)  # (N, out_size, K)
    # f32 HIGHEST keeps |vals| ≤ 2^24 exact (bf16 or TF32 would not).
    out = jnp.einsum(
        "npk,nk->np", member, vals.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(jnp.int32)
