"""Device-path LZ4 decode (scatter + pointer doubling) vs host decode."""

import numpy as np
import pytest

from lz4jpeg_tpu.config import LZ4Config
from lz4jpeg_tpu.formats import decode_frame_bytes
from lz4jpeg_tpu.models.lz4 import LZ4Codec
from lz4jpeg_tpu.ops.lz4_decode import decode_frame_device


@pytest.fixture(scope="module")
def codec():
    return LZ4Codec(LZ4Config(mode="parity"))


class TestDeviceDecode:
    def test_golden(self, golden_compressed, golden_input):
        assert decode_frame_device(golden_compressed) == golden_input

    @pytest.mark.parametrize("size", [350, 2000, 20000])
    def test_matches_host_on_corpus(self, codec, text_corpus, rng, size):
        start = int(rng.integers(0, len(text_corpus) - size))
        text = (
            text_corpus[start : start + size]
            .replace(b"\r", b" ")
            .replace(b"\n", b" ")
        )
        enc = codec.encode(text)
        assert decode_frame_device(enc) == decode_frame_bytes(enc) == text

    def test_overlapping_offset_one_run(self, codec):
        # 'aaaa...' encodes as offset-1 matches: the worst-case chain for
        # the serial decoder, log-depth for pointer doubling.
        data = b"x" + b"a" * 899
        enc = codec.encode(data)
        assert decode_frame_device(enc) == data

    def test_chain_across_blocks(self, codec):
        # A pattern periodic at the 300-B block length: later blocks match
        # content positioned in earlier blocks through the global buffer.
        data = (b"abcdefgh" * 75)[:600]
        enc = codec.encode(data)
        assert decode_frame_device(enc) == data
