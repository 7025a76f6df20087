"""Device-parallel LZ4T decode: copy program, pointer doubling, sharding.

Capability match for the reference's block-parallel decode
(``Algorithms/parallel/LZ4/LZ4.c:1105-1222``), built on the LZ4T format's
up-front size table (prefix-sum framing) instead of the reference's serial
block-header walk.
"""

import numpy as np
import pytest

from lz4jpeg_tpu.config import LZ4Config
from lz4jpeg_tpu.formats.fast_frame import FastFormatError, decode_fast, encode_fast
from lz4jpeg_tpu.models.lz4 import LZ4Codec
from lz4jpeg_tpu.ops.lz4t_decode import (
    _trim_rows,
    build_copy_program_fast,
    decode_fast_device,
    resolve_blocks,
)


def mixed_payload(rng) -> bytes:
    """Compressible text + incompressible noise (raw-stored) + ragged tail."""
    text = (b"the quick brown fox jumps over the lazy dog. " * 3000)[:130000]
    noise = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    return text + noise + text[:12345]


class TestCopyProgram:
    def test_literals_and_matches_cover_output(self, rng):
        frame = encode_fast(mixed_payload(rng))
        lit, src, raw_sizes, p, max_depth = build_copy_program_fast(frame)
        assert max_depth == 1
        assert lit.shape == src.shape == (len(raw_sizes), p)
        # Valid region: every position is a literal (src -1) or an
        # in-block backward reference.
        for b, n in enumerate(raw_sizes):
            s = src[b, : int(n)]
            idx = np.arange(int(n))
            assert ((s == -1) | ((s >= 0) & (s < idx))).all()

    def test_python_fallback_matches_native(self, rng, monkeypatch):
        frame = encode_fast(mixed_payload(rng))
        lit_n, src_n, sz_n, _, d_n = build_copy_program_fast(frame)
        import lz4jpeg_tpu.ops.lz4t_decode as mod

        monkeypatch.setattr(
            "lz4jpeg_tpu.native.native_available", lambda *a, **k: False
        )
        lit_p, src_p, sz_p, _, d_p = mod.build_copy_program_fast(frame)
        np.testing.assert_array_equal(lit_n, lit_p)
        np.testing.assert_array_equal(src_n, src_p)
        np.testing.assert_array_equal(sz_n, sz_p)
        assert d_n == d_p

    def test_malformed_frame_raises(self):
        with pytest.raises(FastFormatError):
            build_copy_program_fast(b"LZ4Tgarbage")


class TestDeviceDecode:
    def test_roundtrip_mixed(self, rng):
        data = mixed_payload(rng)
        assert decode_fast_device(encode_fast(data)) == data

    def test_overlapping_match_chains(self):
        # offset-1 / offset-2 / offset-3 runs: the deepest doubling chains.
        data = b"A" * 70000 + b"BC" * 40000 + b"xyz" * 11111
        assert decode_fast_device(encode_fast(data)) == data

    def test_single_short_block(self):
        data = b"hello hello hello hello hello!"
        assert decode_fast_device(encode_fast(data)) == data

    def test_empty(self):
        assert decode_fast_device(encode_fast(b"")) == b""

    def test_matches_host_decoder(self, text_corpus):
        frame = encode_fast(text_corpus)
        assert decode_fast_device(frame) == decode_fast(frame)

    def test_codec_engine_dispatch(self, text_corpus, golden_input):
        fast = LZ4Codec(LZ4Config(mode="fast"))
        frame = fast.encode(text_corpus)
        assert fast.decode(frame, engine="device") == text_corpus
        parity = LZ4Codec(LZ4Config(mode="parity"))
        pframe = parity.encode(golden_input)
        assert parity.decode(pframe, engine="device") == golden_input


class TestShardedDecode:
    def test_sharded_equals_host(self, rng):
        from lz4jpeg_tpu.config import MeshConfig
        from lz4jpeg_tpu.parallel.lz4 import sharded_fast_decode
        from lz4jpeg_tpu.parallel.mesh import codec_mesh

        mesh = codec_mesh(MeshConfig(num_devices=8))
        # 11 one-KiB blocks (ragged vs the 8-device mesh → padding rows).
        data = mixed_payload(rng)[: 11 * 1024 + 17]
        frame = encode_fast(data, block_log=10)
        assert sharded_fast_decode(frame, mesh) == data

    def test_sharded_full_size_blocks(self, text_corpus):
        from lz4jpeg_tpu.config import MeshConfig
        from lz4jpeg_tpu.parallel.lz4 import sharded_fast_decode
        from lz4jpeg_tpu.parallel.mesh import codec_mesh

        mesh = codec_mesh(MeshConfig(num_devices=4))
        frame = encode_fast(text_corpus)  # 64 KiB blocks
        assert sharded_fast_decode(frame, mesh) == text_corpus


def _pointer_doubling(lit, src, max_depth):
    """Plain reference: root every chain of a depth-capped copy program by
    pointer doubling, then read the literals."""
    idx = np.arange(src.shape[1])[None, :]
    root = np.where(src < 0, idx, src)
    for _ in range(max(0, max_depth - 1).bit_length()):
        root = np.take_along_axis(root, root, axis=1)
    return np.take_along_axis(lit, root, axis=1)


class TestGatherResolve:
    """The fully rooted program (``depth_cap=1``) resolves with one gather;
    it must equal pointer doubling over programs of deeper chains."""

    @pytest.mark.parametrize("cap", [2, 4, 64])
    def test_matches_pointer_doubling(self, rng, cap):
        import jax.numpy as jnp

        frame = encode_fast(mixed_payload(rng))
        lit1, src1, raw_sizes, _, depth1 = build_copy_program_fast(frame)
        assert depth1 <= 1
        one_gather = np.asarray(
            resolve_blocks(jnp.asarray(lit1), jnp.asarray(src1))
        )
        lit, src, _, _, depth = build_copy_program_fast(frame, depth_cap=cap)
        assert depth > 1
        np.testing.assert_array_equal(
            one_gather, _pointer_doubling(lit, src, depth)
        )
        assert _trim_rows(one_gather, raw_sizes) == decode_fast(frame)
