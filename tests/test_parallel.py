"""Sharded paths on a virtual 8-device CPU mesh (conftest sets it up)."""

import jax
import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig, MeshConfig
from lz4jpeg_tpu.models.jpeg import JPEGPipeline
from lz4jpeg_tpu.oracle import jpeg_oracle as oracle
from lz4jpeg_tpu.ops.match import match_tables, greedy_parse, pad_blocks
from lz4jpeg_tpu.parallel import (
    ShardedJPEGForward,
    codec_mesh,
    pad_to_devices,
    sharded_block_parse,
)
from lz4jpeg_tpu.parallel.lz4 import sharded_compressed_sizes


@pytest.fixture(scope="module")
def mesh():
    return codec_mesh(MeshConfig())


class TestMesh:
    def test_uses_all_devices(self, mesh):
        assert mesh.devices.size == len(jax.devices()) == 8

    def test_subset(self):
        m = codec_mesh(MeshConfig(num_devices=4))
        assert m.devices.size == 4

    def test_too_many_devices_rejected(self):
        with pytest.raises(ValueError):
            codec_mesh(MeshConfig(num_devices=1000))

    def test_pad_to_devices(self):
        batch = np.ones((10, 3))
        padded, n = pad_to_devices(batch, 8)
        assert padded.shape == (16, 3) and n == 10
        exact, n2 = pad_to_devices(np.ones((16, 3)), 8)
        assert exact.shape == (16, 3) and n2 == 16


class TestShardedJPEG:
    @pytest.mark.parametrize("size", [16, 32])
    def test_matches_single_device_pipeline(self, rng, mesh, size):
        img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        sharded = ShardedJPEGForward(mesh, JPEGConfig(precision="exact"))
        stages, n = sharded(img)
        ref = oracle.jpeg_forward_oracle(img, snap_ties=True)
        np.testing.assert_array_equal(stages["lum"]["zz"][:n], ref["zz_lum"])
        np.testing.assert_array_equal(stages["r"]["zz"][:n], ref["zz_r"])
        for i in range(n):
            ln = int(stages["lum"]["rle_lengths"][i])
            assert list(stages["lum"]["rle"][i][:ln]) == ref["rle_lum"][i]

    def test_output_is_sharded(self, rng, mesh):
        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        sharded = ShardedJPEGForward(mesh, JPEGConfig(precision="exact"))
        # Peek at the on-device layout before device_get.
        y_cr_cb = sharded._mcu_stage.lower(
            jax.ShapeDtypeStruct((16, 8, 8), "uint8"),
            jax.ShapeDtypeStruct((16, 8, 4), "uint8"),
            jax.ShapeDtypeStruct((16, 8, 4), "uint8"),
        ).compile()
        shardings = y_cr_cb.output_shardings
        spec = shardings["lum"]["zz"].spec
        assert spec[0] == mesh.axis_names[0]


class TestShardedLZ4:
    def test_matches_unsharded_parse(self, mesh, text_corpus):
        text = text_corpus[:4800].replace(b"\r", b" ").replace(b"\n", b" ")
        padded, lengths = pad_blocks(text, 300)
        padded, n = pad_to_devices(padded, mesh.devices.size, pad_value=-1)
        is_match, emit_len, emit_dist = sharded_block_parse(padded, mesh)
        bl, bd = match_tables(jax.numpy.asarray(padded))
        ref_m, ref_l, ref_d = jax.device_get(greedy_parse(bl, bd))
        np.testing.assert_array_equal(is_match, ref_m.astype(bool))
        np.testing.assert_array_equal(emit_len, ref_l)
        np.testing.assert_array_equal(emit_dist, ref_d)

    def test_psum_counts(self, mesh, text_corpus):
        text = text_corpus[:4800].replace(b"\r", b" ").replace(b"\n", b" ")
        padded, _ = pad_blocks(text, 300)
        padded, _ = pad_to_devices(padded, mesh.devices.size, pad_value=-1)
        is_match, emit_len, _ = sharded_block_parse(padded, mesh)
        total = sharded_compressed_sizes(emit_len, is_match, mesh)
        assert int(total) == int(is_match.sum())
        assert int(total) > 0


class TestShardedEndToEnd:
    def test_full_encode_via_sharded_parse(self, mesh, golden_input, golden_compressed):
        """The sharded parse feeds the same serializer → bit-exact frame."""
        from lz4jpeg_tpu.models.lz4 import _build_sequences
        from lz4jpeg_tpu.formats import pack_frame

        padded, lengths = pad_blocks(golden_input, 300)
        padded_b, n = pad_to_devices(padded, mesh.devices.size, pad_value=-1)
        is_match, emit_len, emit_dist = sharded_block_parse(padded_b, mesh)
        blocks = []
        for bi in range(n):
            ln = int(lengths[bi])
            block_bytes = bytes(padded[bi, :ln].astype(np.uint8))
            blocks.append(
                _build_sequences(
                    block_bytes, is_match[bi], emit_len[bi], emit_dist[bi], ln
                )
            )
        assert pack_frame(blocks) == golden_compressed


class TestMultihost:
    def test_initialize_single_process(self):
        from lz4jpeg_tpu.parallel.multihost import initialize

        assert initialize() == 1

    def test_ordered_gather_single_process(self):
        from lz4jpeg_tpu.parallel.multihost import ordered_allgather_payloads

        payloads = [b"bb", b"a", b"cccc"]
        out = ordered_allgather_payloads(payloads, [1, 0, 2], 3)
        assert out == [b"a", b"bb", b"cccc"]

    def test_missing_block_detected(self):
        from lz4jpeg_tpu.parallel.multihost import ordered_allgather_payloads

        with pytest.raises(ValueError):
            ordered_allgather_payloads([b"x"], [0], 2)


class TestShardedFastMode:
    def test_fast_matches_unsharded_fast(self, rng, mesh):
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        sharded = ShardedJPEGForward(mesh, JPEGConfig(precision="fast"))
        stages, n = sharded(img)
        ref = JPEGPipeline(JPEGConfig(precision="fast")).forward_stages(img)
        np.testing.assert_array_equal(stages["lum"]["zz"][:n], ref["lum"]["zz"])
        np.testing.assert_array_equal(stages["r"]["rle"][:n], ref["r"]["rle"])


class TestShardedInverse:
    @pytest.mark.parametrize("precision", ["exact", "fast"])
    def test_matches_single_device_decode(self, rng, mesh, precision):
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        pipe = JPEGPipeline(JPEGConfig(precision=precision))
        enc = pipe.encode(img, entropy=False)
        single = pipe.decode(enc, from_entropy=False)
        sharded = ShardedJPEGForward(mesh, JPEGConfig(precision=precision))
        rec = sharded.inverse(
            enc.rle, enc.rle_lengths,
            enc.blocks_per_col, enc.blocks_per_row, enc.height, enc.width,
            layout="sparse16" if enc.rle_sparse16 else None,
        )
        if enc.rle_sparse16:
            # single-device sparse16 uses the folded suffix-basis einsum,
            # the sharded stage the staged tile path: same fast-path
            # contract, ±1 at the round-half boundary on ~1e-4 of pixels
            # (ops/fused.py::fused_inverse_plane_sparse_jnp docstring).
            diff = np.abs(rec.astype(np.int32) - single.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 2e-3
        else:
            np.testing.assert_array_equal(rec, single)


class TestShardedFastLZ4:
    def test_matches_unsharded(self, mesh, text_corpus):
        from lz4jpeg_tpu.ops.lz4_fast import fast_match_blocks, pad_blocks_fast
        from lz4jpeg_tpu.parallel.lz4 import sharded_fast_parse
        import jax.numpy as jnp

        data = text_corpus[: 8 * 16384]  # 8 blocks, one per device
        padded, lengths = pad_blocks_fast(data)
        s_match, s_len, s_dist = sharded_fast_parse(padded, lengths, mesh)
        r_match, r_len, r_dist = map(
            np.asarray,
            fast_match_blocks(jnp.asarray(padded), jnp.asarray(lengths)),
        )
        np.testing.assert_array_equal(s_match, r_match.astype(bool))
        np.testing.assert_array_equal(s_len, r_len)
        np.testing.assert_array_equal(s_dist, r_dist)

    def test_roundtrip_through_emitter(self, mesh, text_corpus):
        from lz4jpeg_tpu.formats.fast_frame import (
            assemble_frame,
            decode_fast,
            emit_block_from_parse,
        )
        from lz4jpeg_tpu.ops.lz4_fast import DEVICE_BLOCK_LOG, pad_blocks_fast
        from lz4jpeg_tpu.parallel.lz4 import sharded_fast_parse

        data = text_corpus[: 8 * 16384]
        padded, lengths = pad_blocks_fast(data)
        is_match, emit_len, emit_dist = sharded_fast_parse(
            padded, lengths, mesh
        )
        payloads, raws = [], []
        for bi in range(padded.shape[0]):
            n = int(lengths[bi])
            raw = bytes(padded[bi, :n].astype(np.uint8))
            payloads.append(
                emit_block_from_parse(
                    raw, is_match[bi, :n], emit_len[bi, :n], emit_dist[bi, :n]
                )
            )
            raws.append(raw)
        enc = assemble_frame(payloads, raws, len(data), DEVICE_BLOCK_LOG)
        assert decode_fast(enc) == data
        assert len(enc) < len(data)


class TestShardedQuality:
    def test_sharded_respects_quality(self, rng, mesh):
        """Regression: the sharded path must scale quant tables exactly
        like JPEGPipeline (it previously hardcoded reference tables)."""
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        cfg = JPEGConfig(precision="exact", quality=40)
        stages, n = ShardedJPEGForward(mesh, cfg)(img)
        ref = JPEGPipeline(cfg).forward_stages(img)
        np.testing.assert_array_equal(stages["lum"]["zz"][:n], ref["lum"]["zz"])


class TestShardedSparseJPEG:
    """Round-5 production multi-chip paths: band-sharded sparse16
    forward + folded inverse must be BIT-identical to the single-device
    pipeline (bands are row-local at 8-px granularity)."""

    @pytest.mark.parametrize("shape", [(64, 64), (40, 24), (96, 160)])
    def test_forward_matches_unsharded(self, rng, mesh, shape):
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline
        from lz4jpeg_tpu.parallel.jpeg import ShardedSparseJPEG

        h, w = shape
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        sharded = ShardedSparseJPEG(mesh)
        got = sharded.forward(img)
        ref = JPEGPipeline(sharded.config).encode(img, entropy=False)
        np.testing.assert_array_equal(got, ref.rle_combined)

    def test_roundtrip_matches_unsharded(self, rng, mesh):
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline
        from lz4jpeg_tpu.parallel.jpeg import ShardedSparseJPEG

        h, w = 72, 88
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        sharded = ShardedSparseJPEG(mesh)
        comb = sharded.forward(img)
        bpc, bpr = -(-h // 8), -(-w // 8)
        got = sharded.inverse(comb, bpc, bpr, h, w)
        pipe = JPEGPipeline(sharded.config)
        ref = pipe.decode(pipe.encode(img, entropy=False), from_entropy=False)
        np.testing.assert_array_equal(got, ref)

    def test_rejects_non_sparse_config(self, mesh):
        from lz4jpeg_tpu.parallel.jpeg import ShardedSparseJPEG

        with pytest.raises(ValueError):
            ShardedSparseJPEG(mesh, JPEGConfig(precision="exact"))

    def test_ragged_shapes_delegate_and_match(self, rng, mesh):
        """Non-8-multiple shapes must NOT go through the band shard (RGB
        zero-padding would run the color transform over padding, which
        differs from the plane-domain padding the pipeline uses — the
        16x20 counterexample)."""
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline
        from lz4jpeg_tpu.parallel.jpeg import ShardedSparseJPEG

        img = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)
        sharded = ShardedSparseJPEG(mesh)
        got = sharded.forward(img)
        ref = JPEGPipeline(sharded.config).encode(img, entropy=False)
        np.testing.assert_array_equal(got, ref.rle_combined)
