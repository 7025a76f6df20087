"""Parity of the device-batched LZ4 codec against the oracle and golden files."""

import numpy as np
import pytest

from lz4jpeg_tpu.config import LZ4Config
from lz4jpeg_tpu.models.lz4 import LZ4Codec
from lz4jpeg_tpu.oracle import lz4_encode_oracle


@pytest.fixture(scope="module")
def codec():
    return LZ4Codec(LZ4Config(mode="parity"))


def extract(corpus: bytes, rng, size: int) -> bytes:
    """Printable random passage, mirroring ``extract_random_passage``
    (Experiment/random_extract.c:8-71): newlines → spaces."""
    start = int(rng.integers(0, len(corpus) - size))
    return corpus[start : start + size].replace(b"\r", b" ").replace(b"\n", b" ")


class TestParityEncode:
    def test_golden_bit_exact(self, codec, golden_input, golden_compressed):
        assert codec.encode(golden_input) == golden_compressed

    def test_golden_roundtrip(self, codec, golden_input):
        assert codec.roundtrip(golden_input) == golden_input

    @pytest.mark.parametrize("size", [350, 1000, 5000])
    def test_matches_oracle_on_random_extracts(
        self, codec, text_corpus, rng, size
    ):
        text = extract(text_corpus, rng, size)
        assert codec.encode(text) == lz4_encode_oracle(text)

    def test_roundtrip_20k(self, codec, text_corpus, rng):
        text = extract(text_corpus, rng, 20000)
        enc = codec.encode(text)
        assert codec.decode(enc) == text

    def test_binary_bytes_roundtrip(self, codec, rng):
        # The frame layer (unlike the reference's text-output path) is
        # byte-clean: arbitrary byte *values* round-trip as long as literal
        # runs stay representable (some repetition so matches break up runs).
        base = bytes(rng.integers(0, 256, size=128, dtype=np.uint8))
        data = (base + base[:64]) * 12
        assert codec.roundtrip(data) == data

    def test_incompressible_run_refused(self, codec, rng):
        # A 300-B block of pure noise yields a >270-byte literal run, which
        # the reference's u8-truncated format cannot represent (its own
        # decoder would desync, LZ4.c:371-386).  We refuse loudly instead
        # of emitting a corrupt stream.
        from lz4jpeg_tpu.formats.lz4_frame import FormatError

        data = bytes(rng.integers(0, 256, size=2048, dtype=np.uint8))
        with pytest.raises(FormatError):
            codec.encode(data)

    def test_highly_compressible(self, codec):
        data = b"abcd" * 500
        enc = codec.encode(data)
        assert codec.decode(enc) == data
        assert len(enc) < len(data)

    def test_input_shorter_than_block_rejected(self, codec):
        # LZ4.c:694-699: inputs below the block length are refused.
        with pytest.raises(ValueError):
            codec.encode(b"short")
