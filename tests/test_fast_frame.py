"""Fast-mode LZ4 frame: Python spec ↔ native C++ cross-parity."""

import numpy as np
import pytest

from lz4jpeg_tpu.config import LZ4Config
from lz4jpeg_tpu.formats import fast_frame
from lz4jpeg_tpu.models.lz4 import LZ4Codec
from lz4jpeg_tpu.native import native_available, native_backend

needs_native = pytest.mark.skipif(
    not native_available(), reason="native backend not built"
)


def corpus_sample(text_corpus, rng, size):
    start = int(rng.integers(0, len(text_corpus) - size))
    return text_corpus[start : start + size]


CASES = [
    b"",
    b"a",
    b"abcd" * 1000,
    bytes(range(256)) * 10,
]


class TestPythonSpec:
    @pytest.mark.parametrize("data", CASES, ids=["empty", "one", "rep", "cycle"])
    def test_roundtrip(self, data):
        assert fast_frame.decode_fast(fast_frame.encode_fast(data)) == data

    def test_roundtrip_corpus(self, text_corpus):
        enc = fast_frame.encode_fast(text_corpus)
        assert fast_frame.decode_fast(enc) == text_corpus
        assert len(enc) < len(text_corpus)  # actually compresses text

    def test_roundtrip_noise_stored_raw(self, rng):
        data = bytes(rng.integers(0, 256, size=70000, dtype=np.uint8))
        enc = fast_frame.encode_fast(data)
        assert fast_frame.decode_fast(enc) == data
        # Incompressible blocks are stored raw: bounded expansion.
        assert len(enc) <= len(data) + 20 + 4 * 2 + 16

    def test_multi_block_ragged(self, text_corpus):
        data = text_corpus  # 118 KB → 2 blocks, ragged tail
        enc = fast_frame.encode_fast(data)
        assert fast_frame.decode_fast(enc) == data


@needs_native
class TestNativeParity:
    @pytest.mark.parametrize("data", CASES, ids=["empty", "one", "rep", "cycle"])
    def test_encode_byte_identical(self, data):
        assert native_backend().encode_fast(data) == fast_frame.encode_fast(data)

    def test_encode_byte_identical_corpus(self, text_corpus):
        assert (
            native_backend().encode_fast(text_corpus)
            == fast_frame.encode_fast(text_corpus)
        )

    def test_cross_decode(self, text_corpus, rng):
        sample = corpus_sample(text_corpus, rng, 50000)
        py_enc = fast_frame.encode_fast(sample)
        assert native_backend().decode_fast(py_enc, len(sample)) == sample
        nat_enc = native_backend().encode_fast(sample)
        assert fast_frame.decode_fast(nat_enc) == sample

    def test_native_parity_encoder_bit_exact(
        self, golden_input, golden_compressed
    ):
        assert (
            native_backend().encode_parity(golden_input) == golden_compressed
        )

    def test_native_rejects_bad_frame(self):
        with pytest.raises(RuntimeError):
            native_backend().decode_fast(b"\x00" * 24, 100)


class TestCodecFastMode:
    def test_roundtrip(self, text_corpus):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        assert codec.roundtrip(text_corpus) == text_corpus

    def test_binary_roundtrip(self, rng):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        data = bytes(rng.integers(0, 256, size=200000, dtype=np.uint8))
        assert codec.roundtrip(data) == data

    def test_decode_dispatches_on_magic(self, golden_input, golden_compressed):
        # One decode() entry point handles both wire formats.
        codec = LZ4Codec(LZ4Config(mode="fast"))
        assert codec.decode(golden_compressed) == golden_input
        assert codec.decode(codec.encode(golden_input * 2)) == golden_input * 2


class TestFileStreaming:
    def test_file_roundtrip(self, tmp_path, text_corpus):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "in.txt"
        src.write_bytes(text_corpus * 3)  # ~355 KB, 6 blocks
        comp = tmp_path / "out.lz4t"
        n = codec.encode_file(str(src), str(comp), chunk_blocks=2)
        assert n == comp.stat().st_size < src.stat().st_size
        out = tmp_path / "dec.txt"
        assert codec.decode_file(str(comp), str(out)) == src.stat().st_size
        assert out.read_bytes() == src.read_bytes()

    def test_file_frame_matches_inmemory(self, tmp_path, text_corpus):
        # The streamed frame must be byte-identical to the one-shot frame.
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "in.txt"
        src.write_bytes(text_corpus)
        comp = tmp_path / "out.lz4t"
        codec.encode_file(str(src), str(comp))
        assert comp.read_bytes() == codec.encode(text_corpus)

    def test_file_with_incompressible_blocks(self, tmp_path, rng):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        data = bytes(rng.integers(0, 256, size=100_000, dtype=np.uint8))
        src = tmp_path / "noise.bin"
        src.write_bytes(data)
        comp = tmp_path / "noise.lz4t"
        codec.encode_file(str(src), str(comp))
        out = tmp_path / "noise.out"
        codec.decode_file(str(comp), str(out))
        assert out.read_bytes() == data

    def test_parity_mode_refused(self, tmp_path):
        codec = LZ4Codec(LZ4Config(mode="parity"))
        with pytest.raises(ValueError):
            codec.encode_file("x", "y")

    def test_empty_file(self, tmp_path):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "empty"
        src.write_bytes(b"")
        comp = tmp_path / "empty.lz4t"
        codec.encode_file(str(src), str(comp))
        out = tmp_path / "empty.out"
        assert codec.decode_file(str(comp), str(out)) == 0
        assert out.read_bytes() == b""

    def test_python_engine_matches_spec_frame(self, tmp_path, text_corpus):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "in.txt"
        src.write_bytes(text_corpus)
        comp = tmp_path / "out.lz4t"
        codec.encode_file(str(src), str(comp), engine="python")
        assert comp.read_bytes() == fast_frame.encode_fast(text_corpus)

    def test_device_engine_file_roundtrip(self, tmp_path, text_corpus):
        # The device matcher at streaming-chunk granularity (16 KiB blocks).
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "in.txt"
        src.write_bytes(text_corpus)
        comp = tmp_path / "out.lz4t"
        n = codec.encode_file(str(src), str(comp), chunk_blocks=4, engine="device")
        assert n < src.stat().st_size
        out = tmp_path / "dec.txt"
        assert codec.decode_file(str(comp), str(out)) == len(text_corpus)
        assert out.read_bytes() == text_corpus

    def test_corrupt_file_raises_typed(self, tmp_path, text_corpus):
        codec = LZ4Codec(LZ4Config(mode="fast"))
        src = tmp_path / "in.txt"
        src.write_bytes(text_corpus)
        comp = tmp_path / "out.lz4t"
        codec.encode_file(str(src), str(comp))
        blob = bytearray(comp.read_bytes())
        blob[len(blob) // 2] ^= 1  # payload content flip
        bad = tmp_path / "bad.lz4t"
        bad.write_bytes(bytes(blob))
        with pytest.raises(fast_frame.FastFormatError):
            codec.decode_file(str(bad), str(tmp_path / "bad.out"))


@needs_native
class TestNativeChunkAPI:
    def test_encode_chunk_matches_spec(self, text_corpus):
        # One-call chunk compression must emit the same block payloads and
        # size records as the per-block spec walk.
        nb = native_backend()
        body, recs = nb.encode_chunk(text_corpus, 16)
        frame = fast_frame.encode_fast(text_corpus)
        assert frame[20 + 4 * len(recs) :] == body
        import struct

        assert list(recs) == list(
            struct.unpack_from(f"<{len(recs)}I", frame, 20)
        )

    def test_decode_chunk_roundtrip(self, text_corpus):
        nb = native_backend()
        body, recs = nb.encode_chunk(text_corpus, 16)
        assert nb.decode_chunk(body, recs, 16, len(text_corpus)) == (
            text_corpus
        )

    def test_decode_chunk_rejects_bad_sizes(self, text_corpus):
        nb = native_backend()
        body, recs = nb.encode_chunk(text_corpus, 16)
        recs = recs.copy()
        recs[0] += 1
        with pytest.raises(RuntimeError):
            nb.decode_chunk(body, recs, 16, len(text_corpus))


class TestContentChecksum:
    def test_checksum_field_written(self, text_corpus):
        enc = fast_frame.encode_fast(text_corpus)
        import struct

        (csum,) = struct.unpack_from("<H", enc, 6)
        assert csum == fast_frame.content_checksum16(text_corpus) != 0

    def test_zero_checksum_frames_still_decode(self, text_corpus):
        # Frames from older writers carry 0 → verification is skipped.
        enc = bytearray(fast_frame.encode_fast(text_corpus))
        enc[6] = enc[7] = 0
        assert fast_frame.decode_fast(bytes(enc)) == text_corpus
        if native_available():
            assert (
                native_backend().decode_fast(bytes(enc), len(text_corpus))
                == text_corpus
            )

    def test_streaming_checksum_matches_oneshot(self):
        import zlib

        data = b"stream me " * 5000
        whole = fast_frame.content_checksum16(data)
        crc = 0
        for i in range(0, len(data), 7777):
            crc = zlib.crc32(data[i : i + 7777], crc)
        assert fast_frame.fold_checksum16(crc) == whole
