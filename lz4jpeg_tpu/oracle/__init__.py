"""Exact NumPy/Python transcriptions of the reference codec semantics.

These are the oracles (ground truth) that every device kernel in ``ops/`` and
every pipeline in ``models/`` is verified against, including every
quirk of the reference C code — uint8 length truncation, signed-``char``
decode arithmetic, truncating quantization — because bit-exactness against
the committed golden artifacts is a correctness gate (SURVEY.md §2.1, §6).
"""

from lz4jpeg_tpu.oracle.lz4_oracle import (  # noqa: F401
    lz4_encode_oracle,
    lz4_decode_oracle,
    lz4_decode_to_text,
    block_encode_oracle,
    find_longest_match_oracle,
)
from lz4jpeg_tpu.oracle.jpeg_oracle import (  # noqa: F401
    jpeg_forward_oracle,
    jpeg_roundtrip_oracle,
)
