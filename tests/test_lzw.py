"""LZW codec: reference-faithful encoding + framework decoder."""

import pytest

from lz4jpeg_tpu.models.lzw import lzw_decode, lzw_encode


class TestEncode:
    def test_known_small_case(self):
        # 'a'=14+(97-32)=79, 'b'=80; "abab": emit a(79), b(80), then "ab"
        # hits the freshly added entry 128.
        assert lzw_encode(b"abab") == "79 80 128 "

    def test_repeated_char(self):
        # "aaaa": emit a(79), add "aa"=128; w="a"→"aa"(128)→"aaa" miss:
        # emit 128, add "aaa"=129; tail "a" → 79.
        assert lzw_encode(b"aaaa") == "79 128 79 "

    def test_out_of_alphabet_byte(self):
        # Bytes 14-31 are not in the base dictionary (the reference's
        # 110-initializer array quirk, LZW.c:228-235): the miss emits the
        # initial empty w, which the linear scan resolves to index 0 (the
        # '\0' pattern is the empty C string), then the tail emits the
        # entry just added at 128.
        assert lzw_encode(b"\x1b") == "0 128 "

    def test_reference_lorem_compresses(self):
        # The reference's hardcoded input (LZW.c:137-139 style lorem text).
        lorem = (
            b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed "
            b"do eiusmod tempor incididunt ut labore et dolore magna aliqua."
        ) * 4
        codes = lzw_encode(lorem).split()
        assert len(codes) < len(lorem)


class TestDecode:
    @pytest.mark.parametrize(
        "data",
        [b"abab", b"aaaa", b"to be or not to be that is the question",
         b"Lorem ipsum dolor sit amet " * 20],
    )
    def test_roundtrip(self, data):
        assert lzw_decode(lzw_encode(data)) == data

    def test_roundtrip_corpus(self, text_corpus):
        sample = text_corpus[:5000].replace(b"\r", b" ").replace(b"\n", b" ")
        assert lzw_decode(lzw_encode(sample)) == sample

    def test_cscsc_corner_case(self):
        # Code referring to the entry being defined.
        data = b"ababa" * 3
        assert lzw_decode(lzw_encode(data)) == data

    def test_empty(self):
        assert lzw_encode(b"") == ""
        assert lzw_decode("") == b""
