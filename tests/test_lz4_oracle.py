"""Golden-file and property tests for the LZ4 oracle.

The committed golden pair (``input.txt`` ↔ ``compressed.bin`` ↔
``uncompressed.txt``) is the only executable specification the reference
ships (SURVEY.md §4); these tests pin the oracle to it bit-for-bit.
"""

import numpy as np
import pytest

from lz4jpeg_tpu.oracle import (
    lz4_encode_oracle,
    lz4_decode_oracle,
    lz4_decode_to_text,
)
from lz4jpeg_tpu.oracle.lz4_oracle import (
    ParityError,
    block_encode_oracle,
    find_longest_match_oracle,
)


class TestGolden:
    def test_encode_matches_reference_bytes(self, golden_input, golden_compressed):
        assert lz4_encode_oracle(golden_input) == golden_compressed

    def test_decode_golden_roundtrip(self, golden_input, golden_compressed):
        assert lz4_decode_oracle(golden_compressed) == golden_input

    def test_decode_text_matches_reference_output(
        self, golden_compressed, golden_uncompressed
    ):
        assert lz4_decode_to_text(golden_compressed) == golden_uncompressed

    def test_compressed_size_bound(self, golden_input, golden_compressed):
        # BASELINE.md: our compressed size must be <= the reference's 377 B.
        assert len(lz4_encode_oracle(golden_input)) <= len(golden_compressed)


class TestMatchFinder:
    def test_no_match_below_min_length(self):
        assert find_longest_match_oracle(b"abcabc", 3) == (0, 0)

    def test_simple_match(self):
        # "abcd" recurs at distance 4 with length 4 (plus whatever follows).
        block = b"abcdabcd"
        length, dist = find_longest_match_oracle(block, 4)
        assert (length, dist) == (4, 4)

    def test_tie_prefers_earliest_candidate(self):
        # Two equally long candidates: the strict > comparison keeps the
        # earliest i, i.e. the larger offset (LZ4.c:307-311).
        block = b"wxyz" + b"0123" + b"wxyz" + b"4567" + b"wxyz"
        length, dist = find_longest_match_oracle(block, 16)
        assert length == 4
        assert dist == 16  # earliest occurrence at index 0

    def test_match_capped_at_block_end(self):
        block = b"abcde" + b"abcde"
        length, dist = find_longest_match_oracle(block, 5)
        assert (length, dist) == (5, 5)

    def test_uint8_truncation(self):
        # A 260-byte true match truncates to 4 (mod 256) — LZ4.c:317.
        block = b"x" * 600
        length, dist = find_longest_match_oracle(block, 1)
        # True length = min(MAX_MATCH_LENGTH, 599) capped at block end = 599
        # ... capped: idx+m < 600 -> m <= 598; best at i=0 -> 598? No:
        # earliest i=0, m runs while idx+m < 600 -> m=599 is stopped by
        # bounds at m=599; truncation: 599 & 0xFF == 87.
        assert dist == 1
        assert length == 599 & 0xFF


def harness_passage(text_corpus: bytes, size: int, seed: int) -> bytes:
    """Random passage with newlines replaced by spaces, mirroring the
    harness generator (Experiment/random_extract.c:8-71)."""
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text_corpus) - size))
    passage = bytearray(text_corpus[start : start + size])
    for i, b in enumerate(passage):
        if b in (0x0A, 0x0D):
            passage[i] = 0x20
    return bytes(passage)


class TestRoundTrip:
    @pytest.mark.parametrize("size", [350, 500, 1000, 2000, 5000])
    def test_random_printable_roundtrip(self, text_corpus, size):
        # The robust format decoder round-trips every encoder output the
        # wire format can represent (the C-faithful decoder additionally
        # inherits the reference's signed-char UB on some of these).
        from lz4jpeg_tpu.formats import decode_frame_bytes

        data = harness_passage(text_corpus, size, seed=size)
        assert decode_frame_bytes(lz4_encode_oracle(data)) == data

    @pytest.mark.parametrize("size", [350, 500, 1000])
    def test_c_faithful_decoder_on_reference_safe_inputs(self, text_corpus, size):
        # Streams whose length fields stay below the signed-char UB
        # thresholds decode identically through the bug-compatible path.
        data = harness_passage(text_corpus, size, seed=7 * size)
        compressed = lz4_encode_oracle(data)
        try:
            assert lz4_decode_oracle(compressed) == data
        except ParityError:
            pytest.skip("input drives the reference decoder into UB")

    def test_repetitive_input(self):
        data = (b"abcdefgh" * 50)[:350]
        assert lz4_decode_oracle(lz4_encode_oracle(data)) == data

    def test_long_literal_run_within_signed_decode_range(self):
        # 127 unique bytes (no 4-byte match) then repetition: the literal
        # extension byte stays <= 0x7F so the signed decoder reads it back
        # correctly (litcount <= 142).
        head = bytes(range(32, 127)) + bytes(range(32, 79))  # 142 literals
        data = (head + b"abcdabcdabcd") * 3
        data = data + b"?" * (350 - len(data) % 350)
        assert lz4_decode_oracle(lz4_encode_oracle(data)) == data

    def test_compression_shrinks_redundant_input(self):
        data = b"the quick brown fox " * 30  # 600 B, highly redundant
        compressed = lz4_encode_oracle(data)
        assert len(compressed) < len(data)
        assert lz4_decode_oracle(compressed) == data


class TestGuards:
    def test_block_length_500_rejected(self):
        with pytest.raises(ParityError):
            lz4_encode_oracle(b"x" * 1000, block_length=500)

    def test_input_shorter_than_block_rejected(self):
        with pytest.raises(ParityError):
            lz4_encode_oracle(b"tiny")

    def test_block_encode_structure(self):
        block = block_encode_oracle(b"abcdabcdXYZW" + b"Q" * 20)
        assert block.token == len(block.sequences)
        assert block.byte_size == sum(s.byte_size for s in block.sequences) + 3
