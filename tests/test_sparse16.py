"""Sparse-delta RLE interchange (sparse16) — spec, bijection, folding.

The layout (``ops/rle.py::rle_encode_sparse16``) stores each
run's value delta at its start position (zero elsewhere).  These tests
pin the three contracts the production paths rely on:

* exact bijection with the packed16 pair layout (same information),
* decode = prefix sum reconstructs the zigzag values exactly,
* the suffix-basis fold (``ops/fused.py::inverse_suffix_basis``)
  reconstructs pixels within the fast-path envelope of the two-step
  plane inverse.

Reference stage semantics: RLE, JPEG.c:767-842.
"""

import numpy as np
import jax.numpy as jnp

from lz4jpeg_tpu.ops.rle import (
    packed16_to_sparse16,
    rle_decode_packed16,
    rle_decode_sparse16,
    rle_encode_packed16,
    rle_encode_sparse16,
    sparse16_to_packed16,
    SPARSE16_DELTA_BIAS,
)


def _blocks(rng, n=64, k=64):
    """Run-rich random blocks within the |v| <= 511 sparse16 domain."""
    x = rng.integers(-511, 512, size=(n, k))
    rep = np.repeat(rng.integers(-511, 512, size=(n, (k + 7) // 8)), 8, axis=1)
    x[::2] = rep[::2, :k]
    x[5] = 0  # all-zero block
    x[7] = 7  # single-run block
    return x.astype(np.int16)


class TestSparse16Spec:
    def test_roundtrip_exact(self):
        x = _blocks(np.random.default_rng(0))
        w, lengths = rle_encode_sparse16(jnp.asarray(x))
        got = np.asarray(rle_decode_sparse16(w))
        assert np.array_equal(got, x.astype(np.int32))

    def test_slot0_always_valid_and_nonstarts_zero(self):
        x = _blocks(np.random.default_rng(1))
        w, _ = rle_encode_sparse16(jnp.asarray(x))
        w = np.asarray(w)
        assert (w[:, 0] != 0).all()  # slot 0 is always a run start
        # zero slots are exactly the non-starts
        starts = np.ones_like(x, bool)
        starts[:, 1:] = x[:, 1:] != x[:, :-1]
        assert np.array_equal(w != 0, starts)

    def test_delta_bias_range(self):
        x = _blocks(np.random.default_rng(2))
        w, _ = rle_encode_sparse16(jnp.asarray(x))
        w = np.asarray(w).astype(np.int64)
        valid = w[w != 0]
        assert valid.min() >= 2 and valid.max() <= 2046  # 11 bits, nonzero
        assert SPARSE16_DELTA_BIAS == 1024

    def test_lengths_match_pair_layout(self):
        x = _blocks(np.random.default_rng(3))
        _, l_sparse = rle_encode_sparse16(jnp.asarray(x))
        _, l_pairs = rle_encode_packed16(jnp.asarray(x))
        assert np.array_equal(np.asarray(l_sparse), np.asarray(l_pairs))


class TestSparse16Bijection:
    def test_sparse_to_packed(self):
        x = _blocks(np.random.default_rng(4))
        w, _ = rle_encode_sparse16(jnp.asarray(x))
        pk_ref, len_ref = rle_encode_packed16(jnp.asarray(x))
        pk, lengths = sparse16_to_packed16(w)
        assert np.array_equal(np.asarray(pk), np.asarray(pk_ref))
        assert np.array_equal(np.asarray(lengths), np.asarray(len_ref))

    def test_packed_to_sparse(self):
        x = _blocks(np.random.default_rng(5))
        pk, lengths = rle_encode_packed16(jnp.asarray(x))
        w, l2 = packed16_to_sparse16(pk, lengths)
        w_ref, l_ref = rle_encode_sparse16(jnp.asarray(x))
        assert np.array_equal(np.asarray(w), np.asarray(w_ref))
        assert np.array_equal(np.asarray(l2), np.asarray(l_ref))

    def test_decoded_values_agree(self):
        x = _blocks(np.random.default_rng(6))
        pk, lengths = rle_encode_packed16(jnp.asarray(x))
        w, _ = rle_encode_sparse16(jnp.asarray(x))
        via_pairs = np.asarray(rle_decode_packed16(pk, lengths, x.shape[1]))
        via_sparse = np.asarray(rle_decode_sparse16(w))
        assert np.array_equal(via_pairs, via_sparse)


class TestSuffixBasisFold:
    def test_folded_inverse_matches_two_step(self):
        """pixels(delta @ suffix_basis) vs pixels(zz @ basis): same
        envelope as the shipped plane-vs-tile difference (±1 on a tiny
        fraction of pixels; exact on CPU f64 comparison grounds is not
        required — the fast-path contract is near-f64 agreement)."""
        from lz4jpeg_tpu.ops.fused import (
            fused_forward_plane_jnp,
            fused_inverse_plane_jnp,
            fused_inverse_plane_sparse_jnp,
        )
        from lz4jpeg_tpu.ops.quantize import LUMINANCE_QUANTIZATION_TABLE

        rng = np.random.default_rng(7)
        plane = rng.integers(0, 256, size=(64, 1024)).astype(np.uint8)
        table = LUMINANCE_QUANTIZATION_TABLE
        zz_kt = fused_forward_plane_jnp(jnp.asarray(plane), table, 8)
        zz_kt = zz_kt.astype(jnp.int32)
        bh, k, bw = zz_kt.shape

        ref = np.asarray(fused_inverse_plane_jnp(zz_kt, table, 8))

        # sparse deltas in KT layout, through the row-major spec
        zz_rm = jnp.transpose(zz_kt, (0, 2, 1)).reshape(-1, k)
        w, _ = rle_encode_sparse16(zz_rm)
        d_rm = np.asarray(w).astype(np.int32)
        d_rm = np.where(d_rm != 0, d_rm - SPARSE16_DELTA_BIAS, 0)
        d_kt = jnp.transpose(
            jnp.asarray(d_rm).reshape(bh, bw, k), (0, 2, 1)
        )
        got = np.asarray(fused_inverse_plane_sparse_jnp(d_kt, table, 8))

        diff = np.abs(ref.astype(np.int32) - got.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() < 2e-3

    def test_folded_upsample_fold_composes(self):
        from lz4jpeg_tpu.ops.fused import (
            fused_forward_plane_jnp,
            fused_inverse_plane_jnp,
            fused_inverse_plane_sparse_jnp,
        )
        from lz4jpeg_tpu.ops.quantize import CHROMINANCE_QUANTIZATION_TABLE

        rng = np.random.default_rng(8)
        plane = rng.integers(0, 256, size=(32, 512)).astype(np.uint8)
        table = CHROMINANCE_QUANTIZATION_TABLE
        zz_kt = fused_forward_plane_jnp(
            jnp.asarray(plane), table, 4
        ).astype(jnp.int32)
        bh, k, bw = zz_kt.shape
        ref = np.asarray(
            fused_inverse_plane_jnp(zz_kt, table, 4, upsample_cols=True)
        )
        zz_rm = jnp.transpose(zz_kt, (0, 2, 1)).reshape(-1, k)
        w, _ = rle_encode_sparse16(zz_rm)
        d_rm = np.asarray(w).astype(np.int32)
        d_rm = np.where(d_rm != 0, d_rm - SPARSE16_DELTA_BIAS, 0)
        d_kt = jnp.transpose(jnp.asarray(d_rm).reshape(bh, bw, k), (0, 2, 1))
        got = np.asarray(
            fused_inverse_plane_sparse_jnp(d_kt, table, 4, upsample_cols=True)
        )
        diff = np.abs(ref.astype(np.int32) - got.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() < 2e-3
