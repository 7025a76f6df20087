"""End-to-end parity of the JPEGPipeline model against the oracle."""

import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig
from lz4jpeg_tpu.models import JPEGPipeline
from lz4jpeg_tpu.oracle import jpeg_oracle as oracle


def noise(rng, h, w):
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def exact_pipeline():
    return JPEGPipeline(JPEGConfig(precision="exact", entropy="shared"))


@pytest.fixture(scope="module")
def parity_pipeline():
    return JPEGPipeline(JPEGConfig(precision="exact", entropy="per_block"))


class TestForwardParity:
    @pytest.mark.parametrize("size", [8, 16, 32])
    def test_quantized_zigzag_streams_match_oracle(self, rng, exact_pipeline, size):
        img = noise(rng, size, size)
        ref = oracle.jpeg_forward_oracle(img, snap_ties=True)
        stages = exact_pipeline.forward_stages(img)
        np.testing.assert_array_equal(stages["lum"]["zz"], ref["zz_lum"])
        np.testing.assert_array_equal(stages["r"]["zz"], ref["zz_r"])
        np.testing.assert_array_equal(stages["b"]["zz"], ref["zz_b"])

    def test_rle_streams_match_oracle(self, rng, exact_pipeline):
        img = noise(rng, 16, 16)
        ref = oracle.jpeg_forward_oracle(img, snap_ties=True)
        enc = exact_pipeline.encode(img, entropy=False)
        for c, key in (("lum", "rle_lum"), ("r", "rle_r"), ("b", "rle_b")):
            for i in range(enc.num_blocks):
                n = int(enc.rle_lengths[c][i])
                assert list(enc.rle[c][i, :n]) == ref[key][i]

    def test_non_square_image(self, rng, exact_pipeline):
        img = noise(rng, 16, 32)
        ref = oracle.jpeg_forward_oracle(img, snap_ties=True)
        stages = exact_pipeline.forward_stages(img)
        np.testing.assert_array_equal(stages["lum"]["zz"], ref["zz_lum"])


class TestRoundTrip:
    @pytest.mark.parametrize("size", [8, 16])
    def test_reconstruction_matches_oracle_exactly(self, rng, exact_pipeline, size):
        img = noise(rng, size, size)
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        ours = exact_pipeline.roundtrip(img)
        np.testing.assert_array_equal(ours, ref_rec)

    def test_fast_f32_reconstruction_close(self, rng):
        img = noise(rng, 16, 16)
        fast = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        ours = fast.roundtrip(img)
        # f32 vs f64 may flip a truncation on rare boundary values; pixels
        # stay within a couple of levels.
        assert np.abs(ours.astype(int) - ref_rec.astype(int)).max() <= 2

    def test_solid_color_roundtrip(self, exact_pipeline):
        img = np.full((8, 8, 3), 77, dtype=np.uint8)
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        np.testing.assert_array_equal(exact_pipeline.roundtrip(img), ref_rec)


class TestPack16:
    """u16 RLE transfer layouts: the sparse-delta layout is
    (ops/rle.py sparse16) the production interchange for fast+shared
    pipelines whose quant tables bound |value| ≤ 511; the packed-pair
    layout stays as the tested spec + container fallback."""

    def test_fast_pipeline_uses_sparse_layout(self, rng):
        pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        assert pipe._pack16 and pipe._sparse16
        enc = pipe.encode(noise(rng, 16, 16))
        for c in ("lum", "r", "b"):
            assert enc.rle[c].dtype == np.uint16
        assert enc.rle_sparse16 and not enc.rle_packed16
        assert enc.rle_combined is not None

    def test_packed_matches_int_pipeline_end_to_end(self, rng):
        img = noise(rng, 24, 40)
        fast = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        plain = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        plain._pack16 = plain._sparse16 = False
        enc_p = fast.encode(img)
        enc_i = plain.encode(img)
        # identical entropy bitstreams from either layout
        for c in ("lum", "r", "b"):
            assert enc_p.shared_streams[c][1] == enc_i.shared_streams[c][1]
            assert enc_p.shared_streams[c][2] == enc_i.shared_streams[c][2]
        # identical reconstructions, both from entropy and direct
        np.testing.assert_array_equal(fast.decode(enc_p), plain.decode(enc_i))
        np.testing.assert_array_equal(
            fast.decode(enc_p, from_entropy=False),
            plain.decode(enc_i, from_entropy=False),
        )

    def test_pack_roundtrip_ops(self, rng):
        from lz4jpeg_tpu.ops.rle import (
            rle_decode_batched,
            rle_decode_packed16,
            rle_encode_batched,
            rle_encode_packed16,
        )

        vals = rng.integers(-511, 512, size=(32, 64)).astype(np.int16)
        vals[:, 40:] = 0  # give it some runs
        pairs, lengths = map(np.asarray, rle_encode_batched(vals))
        packed, lengths16 = map(np.asarray, rle_encode_packed16(vals))
        np.testing.assert_array_equal(lengths, lengths16)
        np.testing.assert_array_equal(
            np.asarray(rle_decode_packed16(packed, lengths16, 64)),
            np.asarray(rle_decode_batched(pairs, lengths, 64)),
        )

    def test_extreme_quality_falls_back_to_int_pairs(self):
        pipe = JPEGPipeline(
            JPEGConfig(precision="fast", entropy="shared", quality=99)
        )
        assert not pipe._pack16

    def test_entropy_decode_restores_packed_layout(self, rng):
        pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        enc = pipe.encode(noise(rng, 16, 16))
        rle, lengths = pipe.entropy_decode(enc)
        for c in ("lum", "r", "b"):
            assert rle[c].dtype == np.uint16
            np.testing.assert_array_equal(lengths[c], enc.rle_lengths[c])
            np.testing.assert_array_equal(rle[c], enc.rle[c])

    def test_native_packed_passes_match_int_passes(self, rng):
        from lz4jpeg_tpu.models.jpeg import _pack16_host
        from lz4jpeg_tpu.native import native_available, native_backend
        from lz4jpeg_tpu.ops.huffman import (
            build_canonical_codebook_from_counts,
        )

        if not native_available():
            pytest.skip("native backend not built")
        native = native_backend()
        pairs = np.zeros((8, 32), np.int32)
        lengths = np.zeros(8, np.int32)
        for i in range(8):
            n = int(rng.integers(1, 16))
            counts = rng.integers(1, 5, size=n)
            total = 32  # block_size for re-blocking tests
            counts[-1] = max(1, total - int(counts[:-1].sum()))
            if counts.sum() != total or counts[-1] > 64:
                counts = np.array([total])
                n = 1
            vals = rng.integers(-500, 500, size=n)
            pairs[i, 0 : 2 * n : 2] = counts[:n]
            pairs[i, 1 : 2 * n : 2] = vals
            lengths[i] = 2 * n
        packed16 = _pack16_host(pairs)
        off = 2048
        h_int, t_int = native.rle_symbol_hist(pairs, lengths, off, 2 * off)
        h_p16, t_p16 = native.rle_symbol_hist16(
            packed16, lengths, off, 2 * off
        )
        assert t_int == t_p16
        np.testing.assert_array_equal(h_int, h_p16)
        (bins,) = np.nonzero(h_int)
        cb = build_canonical_codebook_from_counts(
            bins.astype(np.int64) - off, h_int[bins]
        )
        s_int = native.huff_pack_pairs(pairs, lengths, cb)
        s_p16 = native.huff_pack_pairs16(packed16, lengths, cb)
        assert s_int == s_p16
        got = native.huff_unpack_pairs16(
            s_p16[0], s_p16[1], cb, 32, 8, 16
        )
        assert got is not None
        np.testing.assert_array_equal(got[0], packed16)
        np.testing.assert_array_equal(got[1], lengths)


class TestEntropy:
    def test_shared_mode_roundtrips_rle(self, rng, exact_pipeline):
        img = noise(rng, 16, 16)
        enc = exact_pipeline.encode(img)
        rle, lengths = exact_pipeline.entropy_decode(enc)
        for c in ("lum", "r", "b"):
            np.testing.assert_array_equal(lengths[c], enc.rle_lengths[c])
            np.testing.assert_array_equal(rle[c], enc.rle[c])

    def test_shared_streams_serialize(self, rng, exact_pipeline):
        from lz4jpeg_tpu.ops.huffman import CanonicalCodebook, unpack_symbols

        img = noise(rng, 16, 16)
        enc = exact_pipeline.encode(img)
        for c in ("lum", "r", "b"):
            codebook, packed, nbits = enc.shared_streams[c]
            blob = codebook.serialize()
            restored, _ = CanonicalCodebook.deserialize(blob)
            np.testing.assert_array_equal(restored.codes, codebook.codes)
            # decode through the deserialized book
            from lz4jpeg_tpu.models.jpeg import _valid_symbols

            ref_syms = _valid_symbols(enc.rle[c], enc.rle_lengths[c])
            np.testing.assert_array_equal(
                unpack_symbols(packed, nbits, restored), ref_syms
            )

    def test_per_block_bits_match_reference_huffman(self, rng, parity_pipeline):
        # The per-block mode reproduces the oracle's (reference-faithful)
        # Huffman bitstrings exactly, quirky heap and all.
        img = noise(rng, 16, 16)
        _, ref = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        enc = parity_pipeline.encode(img)
        assert enc.per_block_bits["lum"] == ref["huff_bits"]["lum"]
        assert enc.per_block_bits["r"] == ref["huff_bits"]["r"]
        assert enc.per_block_bits["b"] == ref["huff_bits"]["b"]

    def test_compressed_bytes_reported(self, rng, exact_pipeline):
        img = noise(rng, 16, 16)
        enc = exact_pipeline.encode(img)
        assert enc.compressed_bytes() > 0


class TestDevicePacking:
    def test_matches_host_packbits(self, rng):
        import jax
        import numpy as np

        from lz4jpeg_tpu.ops.huffman import (
            build_canonical_codebook,
            pack_symbols,
            pack_symbols_device,
        )

        symbols = rng.integers(-50, 50, size=1000).astype(np.int32)
        codebook = build_canonical_codebook(symbols)
        host_packed, host_bits = pack_symbols(symbols, codebook)
        pad_bits = ((host_bits + 1023) // 1024 + 1) * 1024
        dev_packed, dev_bits = jax.jit(
            lambda s: pack_symbols_device(s, codebook, pad_bits)
        )(symbols)
        assert int(dev_bits) == host_bits
        np.testing.assert_array_equal(
            np.asarray(dev_packed)[: (host_bits + 7) // 8],
            np.frombuffer(host_packed, np.uint8),
        )
        assert np.all(np.asarray(dev_packed)[(host_bits + 7) // 8 :] == 0)

    def test_unpack_inverts_device_pack(self, rng):
        import numpy as np

        from lz4jpeg_tpu.ops.huffman import (
            build_canonical_codebook,
            pack_symbols_device,
            unpack_symbols,
        )

        symbols = rng.integers(0, 10, size=257).astype(np.int32)
        codebook = build_canonical_codebook(symbols)
        packed, nbits = pack_symbols_device(symbols, codebook, 8192)
        out = unpack_symbols(bytes(np.asarray(packed)), int(nbits), codebook)
        np.testing.assert_array_equal(out, symbols)


class TestBucketedEncode:
    @pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (40, 16)])
    def test_matches_plain_encode(self, rng, exact_pipeline, h, w):
        img = noise(rng, h, w)
        plain = exact_pipeline.encode(img, entropy=False)
        bucketed = exact_pipeline.encode_bucketed(img, entropy=False)
        for c in ("lum", "r", "b"):
            np.testing.assert_array_equal(bucketed.rle[c], plain.rle[c])
            np.testing.assert_array_equal(
                bucketed.rle_lengths[c], plain.rle_lengths[c]
            )

    def test_shares_bucket_compiles(self, rng, exact_pipeline):
        # 16x16 (4 MCUs) and 8x32 (4 MCUs) land in the same bucket; the
        # heavy stage must not recompile.
        img1, img2 = noise(rng, 16, 16), noise(rng, 8, 32)
        exact_pipeline.encode_bucketed(img1)
        before = exact_pipeline._mcu_forward._cache_size()
        exact_pipeline.encode_bucketed(img2)
        assert exact_pipeline._mcu_forward._cache_size() == before

    def test_decodes_correctly(self, rng, exact_pipeline):
        img = noise(rng, 24, 24)
        enc = exact_pipeline.encode_bucketed(img)
        np.testing.assert_array_equal(
            exact_pipeline.decode(enc), exact_pipeline.roundtrip(img)
        )


class TestBatchAPI:
    def test_encode_batch_matches_single(self, rng, exact_pipeline):
        imgs = np.stack([noise(rng, 16, 16) for _ in range(3)])
        batch = exact_pipeline.encode_batch(imgs, entropy=False)
        for i in range(3):
            single = exact_pipeline.encode(imgs[i], entropy=False)
            for c in ("lum", "r", "b"):
                np.testing.assert_array_equal(batch[i].rle[c], single.rle[c])
                np.testing.assert_array_equal(
                    batch[i].rle_lengths[c], single.rle_lengths[c]
                )

    def test_batch_decodes(self, rng, exact_pipeline):
        imgs = np.stack([noise(rng, 8, 8) for _ in range(2)])
        for enc, img in zip(exact_pipeline.encode_batch(imgs), imgs):
            rec = exact_pipeline.decode(enc)
            np.testing.assert_array_equal(
                rec, exact_pipeline.roundtrip(img)
            )

    def test_decode_batch_matches_single(self, rng):
        pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        imgs = np.stack([noise(rng, 16, 24) for _ in range(3)])
        encs = pipe.encode_batch(imgs)
        recs = pipe.decode_batch(encs)
        assert len(recs) == 3
        for enc, rec in zip(encs, recs):
            np.testing.assert_array_equal(rec, pipe.decode(enc))

    def test_decode_batch_rejects_mixed_sizes(self, rng):
        pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        a = pipe.encode(noise(rng, 16, 16))
        b = pipe.encode(noise(rng, 16, 24))
        with pytest.raises(ValueError):
            pipe.decode_batch([a, b])
        assert pipe.decode_batch([]) == []

    def test_warmup_compiles(self, exact_pipeline):
        exact_pipeline.warmup([(8, 8)])
        before = exact_pipeline._forward_rle._cache_size()
        exact_pipeline.encode(np.zeros((8, 8, 3), np.uint8), entropy=False)
        assert exact_pipeline._forward_rle._cache_size() == before


class TestBucketedDecode:
    @pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (40, 16)])
    def test_matches_plain_decode(self, rng, exact_pipeline, h, w):
        img = noise(rng, h, w)
        enc = exact_pipeline.encode(img)
        np.testing.assert_array_equal(
            exact_pipeline.decode_bucketed(enc), exact_pipeline.decode(enc)
        )

    def test_shares_bucket_compiles(self, rng, exact_pipeline):
        enc1 = exact_pipeline.encode(noise(rng, 16, 16))
        enc2 = exact_pipeline.encode(noise(rng, 8, 32))
        exact_pipeline.decode_bucketed(enc1)
        before = exact_pipeline._mcu_inverse._cache_size()
        exact_pipeline.decode_bucketed(enc2)
        assert exact_pipeline._mcu_inverse._cache_size() == before


class TestQuality:
    def test_default_is_reference_tables(self, exact_pipeline):
        from lz4jpeg_tpu.ops.quantize import LUMINANCE_QUANTIZATION_TABLE

        np.testing.assert_array_equal(
            exact_pipeline._tables["lum"], LUMINANCE_QUANTIZATION_TABLE
        )

    def test_scale_table_endpoints(self):
        from lz4jpeg_tpu.ops.quantize import (
            LUMINANCE_QUANTIZATION_TABLE,
            scale_table,
        )

        t50 = scale_table(LUMINANCE_QUANTIZATION_TABLE, 50)
        np.testing.assert_array_equal(t50, LUMINANCE_QUANTIZATION_TABLE)
        t100 = scale_table(LUMINANCE_QUANTIZATION_TABLE, 100)
        assert t100.max() == 1  # near-lossless
        t1 = scale_table(LUMINANCE_QUANTIZATION_TABLE, 1)
        assert t1.min() >= LUMINANCE_QUANTIZATION_TABLE.min()

    def test_quality_tradeoff(self, rng):
        # Higher quality → better PSNR and larger streams on a smooth image.
        from lz4jpeg_tpu.utils.metrics import psnr

        x = np.linspace(0, 255, 64)
        img = np.stack(
            [np.add.outer(x, x) / 2] * 3, axis=-1
        ).astype(np.uint8)
        results = {}
        for q in (10, 90):
            pipe = JPEGPipeline(
                JPEGConfig(precision="exact", entropy="shared", quality=q)
            )
            enc = pipe.encode(img)
            results[q] = (psnr(img, pipe.decode(enc)), enc.compressed_bytes())
        assert results[90][0] > results[10][0]  # better fidelity
        assert results[90][1] > results[10][1]  # more bytes

    def test_quality_container_roundtrip(self, rng):
        from lz4jpeg_tpu.formats.jpeg_container import (
            pack_container,
            unpack_container,
        )

        pipe = JPEGPipeline(
            JPEGConfig(precision="exact", entropy="shared", quality=75)
        )
        img = noise(rng, 16, 16)
        enc = pipe.encode(img)
        dec = unpack_container(pack_container(enc))
        assert dec.quality == 75
        np.testing.assert_array_equal(pipe.decode(dec), pipe.decode(enc))

    def test_invalid_quality_rejected(self):
        with pytest.raises(ValueError):
            JPEGConfig(quality=0)
        with pytest.raises(ValueError):
            JPEGConfig(quality=101)


class TestSoak:
    def test_64x64_full_roundtrip_vs_oracle(self, rng, exact_pipeline):
        """Larger integration soak: 64 MCUs through encode, entropy,
        container, decode — reconstruction oracle-exact end to end."""
        from lz4jpeg_tpu.formats.jpeg_container import (
            pack_container,
            unpack_container,
        )

        img = noise(rng, 64, 64)
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        enc = exact_pipeline.encode(img)
        restored = unpack_container(pack_container(enc))
        np.testing.assert_array_equal(exact_pipeline.decode(restored), ref_rec)


class TestDevicePackOverflow:
    def test_total_bits_reports_overflow(self, rng):
        # The documented contract: a too-small pad_bits bucket yields a
        # truncated buffer, detectable because total_bits > pad_bits.
        from lz4jpeg_tpu.ops.huffman import (
            build_canonical_codebook,
            pack_symbols_device,
        )

        symbols = rng.integers(-40, 40, size=500).astype(np.int32)
        cb = build_canonical_codebook(symbols)
        packed, total = pack_symbols_device(symbols, cb, 64)
        assert int(total) > 64  # caller must re-pack with a larger bucket


class TestOverlappedEncode:
    def test_overlapped_container_is_byte_identical(self, rng):
        """The banded d2h + two-pass banded entropy path must produce byte-identical containers to the one-shot
        path — the per-band bitstreams concatenate at bit level."""
        from lz4jpeg_tpu.formats.jpeg_container import pack_container

        img = noise(rng, 48, 56)
        pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        ref = pipe.encode(img)
        pipe2 = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        pipe2._OVERLAP_MIN_BLOCKS = 1  # engage the overlap path
        got = pipe2.encode(img)
        assert pack_container(got) == pack_container(ref)
        for c in ("lum", "r", "b"):
            np.testing.assert_array_equal(got.rle[c], ref.rle[c])
            np.testing.assert_array_equal(
                got.rle_lengths[c], ref.rle_lengths[c]
            )
        np.testing.assert_array_equal(pipe.decode(got), pipe.decode(ref))
