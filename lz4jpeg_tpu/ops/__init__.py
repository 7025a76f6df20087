"""Batched device ops for the codec pipelines.

Each op is an XLA-fused jnp formulation verified coefficient-exactly
against ``oracle/``.  The one hand-written kernel is the fused JPEG
forward (``pallas_fwd.py``), tested against the XLA chain it replaces.
"""

from lz4jpeg_tpu.ops.color import (  # noqa: F401
    rgb_to_ycbcr,
    chroma_subsample_422,
    ycbcr_to_rgb_mcus,
)
from lz4jpeg_tpu.ops.dct import (  # noqa: F401
    dct_basis,
    dct2_batched,
    idct2_batched,
)
from lz4jpeg_tpu.ops.quantize import quantize, dequantize  # noqa: F401
from lz4jpeg_tpu.ops.zigzag import zigzag, reverse_zigzag  # noqa: F401
from lz4jpeg_tpu.ops.rle import rle_encode_batched, rle_decode_batched  # noqa: F401
from lz4jpeg_tpu.ops.fused import (  # noqa: F401
    fused_forward_jnp,
    fused_inverse_jnp,
)
from lz4jpeg_tpu.ops.huffman import (  # noqa: F401
    CanonicalCodebook,
    build_canonical_codebook,
    pack_symbols,
    pack_symbols_device,
    unpack_symbols,
)
from lz4jpeg_tpu.ops.match import match_tables, greedy_parse, pad_blocks  # noqa: F401
from lz4jpeg_tpu.ops.lz4_decode import decode_frame_device  # noqa: F401
from lz4jpeg_tpu.ops.lz4_fast import fast_match_blocks, pad_blocks_fast  # noqa: F401
