"""Tests for the LZ4 frame pack/unpack layer."""

import pytest

from lz4jpeg_tpu.formats import (
    Block,
    Sequence,
    decode_frame_bytes,
    pack_frame,
    unpack_frame,
)
from lz4jpeg_tpu.formats.lz4_frame import FormatError
from lz4jpeg_tpu.oracle import lz4_encode_oracle, lz4_decode_oracle


def test_unpack_golden_frame(golden_input, golden_compressed):
    blocks = unpack_frame(golden_compressed)
    assert len(blocks) == 2  # 350 B input / 300 B blocks
    assert blocks[0].sequences  # 13 sequences in block 0 (token 0x0d)
    assert len(blocks[0].sequences) == 13
    assert decode_frame_bytes(golden_compressed) == golden_input


def test_pack_is_inverse_of_unpack(golden_compressed):
    assert pack_frame(unpack_frame(golden_compressed)) == golden_compressed


def test_robust_decoder_agrees_with_c_faithful_on_golden(golden_compressed):
    assert decode_frame_bytes(golden_compressed) == lz4_decode_oracle(
        golden_compressed
    )


def test_pack_roundtrip_synthetic():
    blocks = [
        Block([
            Sequence(b"hello world, this is a literal run", 0, 0),
        ]),
        Block([
            Sequence(b"abcd", 4, 8),
            Sequence(b"", 2, 25),  # match-only sequence with extension byte
        ]),
    ]
    packed = pack_frame(blocks)
    unpacked = unpack_frame(packed)
    assert [len(b.sequences) for b in unpacked] == [1, 2]
    assert unpacked[1].sequences[1].match_length == 25
    assert pack_frame(unpacked) == packed


def test_long_literal_extension_boundary():
    # litcount 270 serializes as ext bytes [255, 0]; unsigned unpack
    # reconstructs it (the reference's signed decoder cannot).
    lits = bytes((i % 95) + 32 for i in range(270))
    blocks = [Block([Sequence(lits, 0, 0)])]
    out = unpack_frame(pack_frame(blocks))
    assert out[0].sequences[0].literals == lits


def test_truncated_frame_raises():
    blocks = [Block([Sequence(b"abcdef", 0, 0)])]
    packed = pack_frame(blocks)
    with pytest.raises(FormatError):
        unpack_frame(packed[:-2])


def test_wire_compat_with_oracle_encoder(text_corpus):
    data = text_corpus[:1200]
    data = bytes(b if b not in (0x0A, 0x0D) else 0x20 for b in data)
    compressed = lz4_encode_oracle(data)
    # unpack → repack must be byte-identical (no information loss).
    assert pack_frame(unpack_frame(compressed)) == compressed
