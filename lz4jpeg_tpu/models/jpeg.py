"""The JPEG-style pipeline.

Where the reference runs one Win32 thread per 8×8 MCU through a scalar
DCT→quant→zigzag→RLE→Huffman chain (``process``,
``Algorithms/parallel/JPEG/JPEG.c:1103-1252``), this pipeline batches *all*
MCUs of an image and runs the forward chain (color → fused DCT basis
matmul → sparse-delta RLE) as one jitted function, shipping a single
(N, 128) uint16 combined stream.  Decode folds the RLE expansion into the
inverse DCT einsum (``ops/fused.py::inverse_suffix_basis``) — no
expansion stage exists.  The staged einsum/quant/zigzag/pair-RLE ops
remain as the exact-mode and compat paths, with a host entropy stage
either way.

Everything up to (and including) RLE is jit-compiled; the Huffman stage has
two modes (see ``ops/huffman.py``):

* ``per_block`` — parity with the reference: a tree per block per channel,
  built with the reference's exact heap quirks;
* ``shared``    — one canonical codebook per channel, serializable, with
  vectorized pack/unpack; the codebook is replicated (broadcast) across
  devices in the sharded path, mirroring the reference's shared in-memory
  tables.

The decode half inverts each stage and is also batched/jittable down to the
RLE expansion.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lz4jpeg_tpu.config import JPEGConfig
from lz4jpeg_tpu.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
    ycbcr_to_rgb_mcus,
)
from lz4jpeg_tpu.ops.dct import dct2_batched, idct2_batched
from lz4jpeg_tpu.ops.fused import fused_forward_jnp, fused_inverse_jnp
from lz4jpeg_tpu.ops.huffman import (
    CanonicalCodebook,
    build_canonical_codebook,
    build_canonical_codebook_from_counts,
    pack_symbols,
    unpack_symbols,
)
from lz4jpeg_tpu.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    dequantize,
    quantize,
    scale_table,
)
from lz4jpeg_tpu.ops.rle import (
    CHANNEL_SLICES,
    COMBINED_LANES,
    SPARSE16_DELTA_BIAS,
    rle_decode_batched,
    rle_decode_packed16,
    rle_decode_sparse16,
    rle_encode_batched,
    rle_encode_packed16,
    rle_encode_sparse16,
)
from lz4jpeg_tpu.ops.zigzag import reverse_zigzag, zigzag
from lz4jpeg_tpu.oracle import jpeg_oracle

CHANNELS = ("lum", "r", "b")
_CHANNEL_SHAPES = {"lum": (8, 8), "r": (8, 4), "b": (8, 4)}


def scaled_tables(quality):
    """Per-channel quant tables for a quality setting (None = reference)."""
    lum_t = scale_table(LUMINANCE_QUANTIZATION_TABLE, quality)
    chr_t = scale_table(CHROMINANCE_QUANTIZATION_TABLE, quality)
    return {"lum": lum_t, "r": chr_t, "b": chr_t}


def forward_channel(tiles, name, tables, dtype, fused):
    """One channel's MCU batch → quantized zigzag stream.

    The single source of truth for the fused-vs-staged dispatch, shared by
    the pipeline's three forward variants and the sharded path."""
    h, w = _CHANNEL_SHAPES[name]
    if fused:
        return fused_forward_jnp(tiles, tables[name], w, h, dtype)
    coeff = dct2_batched(tiles, dtype)
    q = quantize(coeff, tables[name].reshape(h, w))
    return zigzag(q, w, h)


def inverse_channel(zz, name, tables, dtype, fused):
    """One channel's zigzag stream → pixel tiles (inverse of
    ``forward_channel``)."""
    h, w = _CHANNEL_SHAPES[name]
    if fused:
        return fused_inverse_jnp(zz, tables[name], w, h, dtype)
    blocks = reverse_zigzag(zz.astype(dtype), w, h)
    deq = dequantize(blocks.reshape(-1, h, w), tables[name].reshape(h, w))
    return idct2_batched(deq, dtype)


@dataclasses.dataclass
class JPEGEncoded:
    """Encoded image: RLE streams (always) + optional entropy bitstreams."""

    height: int
    width: int
    blocks_per_col: int
    blocks_per_row: int
    # Padded (N, 2L) RLE [count, value] pairs + (N,) valid lengths — or,
    # in the sparse16 layout, per-channel (N, K) uint16 sparse-delta
    # views into ``rle_combined`` and lazily-populated lengths.
    rle: Dict[str, np.ndarray]
    rle_lengths: Optional[Dict[str, np.ndarray]]
    entropy_mode: Optional[str] = None
    # True: rle holds the packed-u16 pair layout ((count-1)<<10 | value+512,
    # one uint16 per pair, ops/rle.py) — half the transfer bytes of the
    # int32 pair layout.  Set when the quant tables bound |value| ≤ 511.
    rle_packed16: bool = False
    # True: rle holds the sparse-delta uint16 layout
    # (ops/rle.py::rle_encode_sparse16) — run value-deltas at start
    # positions, zero elsewhere.  The production interchange: same bytes
    # as packed16, no device-side compaction, and decode folds into the
    # inverse einsum.  ``rle_lengths`` may be None until
    # the entropy pass computes it (the native walk gets it for free).
    rle_sparse16: bool = False
    # sparse16: the single (N, 128) device buffer the per-channel views
    # slice (64 luma + 32 Cr + 32 Cb lanes, ops/rle.py::CHANNEL_SLICES).
    rle_combined: Optional[np.ndarray] = None
    # shared mode: per-channel (codebook, packed bytes, bit count).
    shared_streams: Optional[Dict[str, Tuple[CanonicalCodebook, bytes, int]]] = None
    # per_block mode: per-channel list of '0'/'1' strings (parity artifact).
    per_block_bits: Optional[Dict[str, List[str]]] = None
    # Quality setting the quant tables were scaled with (None = reference
    # tables); decode must use a pipeline with the same quality.
    quality: Optional[int] = None

    @property
    def num_blocks(self) -> int:
        return self.blocks_per_col * self.blocks_per_row

    def compressed_bytes(self) -> int:
        """Size of the entropy-coded representation in bytes."""
        if self.entropy_mode == "shared":
            return sum(
                len(cb.serialize()) + len(packed)
                for cb, packed, _ in self.shared_streams.values()
            )
        if self.entropy_mode == "per_block":
            return sum(
                (len(bits) + 7) // 8
                for ch in self.per_block_bits.values()
                for bits in ch
            )
        raise ValueError("no entropy stage was run")


class JPEGPipeline:
    """Batched encode/decode with jit-compiled transform stages."""

    def __init__(self, config: JPEGConfig = JPEGConfig()):
        self._forward_rle = jax.jit(self._forward_rle_impl)
        # Bucketed two-stage forward: the cheap image→tiles stage compiles
        # per image shape, the expensive fused+RLE stage per power-of-two
        # MCU-count bucket — bounded recompiles when serving many sizes.
        self._split_stage = jax.jit(self._split_impl)
        self._mcu_forward = jax.jit(self._mcu_forward_impl)
        self._mcu_inverse = jax.jit(
            self._mcu_inverse_impl, static_argnames=("layout",)
        )
        if config.precision == "exact" and not jax.config.jax_enable_x64:
            # Without x64, float64 silently degrades to f32 and the pipeline
            # loses coefficient-exact parity — fail loudly instead.  Exact
            # mode is the CPU verification path; precision="fast" is the
            # accelerator compute path.
            raise RuntimeError(
                'precision="exact" requires jax_enable_x64 '
                "(jax.config.update('jax_enable_x64', True)); "
                'use precision="fast" on an accelerator'
            )
        self.config = config
        self._tables = scaled_tables(config.quality)
        # Packed-u16 RLE transfer layout: |quantized value| ≤
        # ⌊sqrt(HW)·128 / min(table)⌋ must fit 10 bits signed, i.e.
        # min(table) ≥ 3.  True for the reference tables (min 6 / 17);
        # extreme quality settings fall back to int16 pairs.  Halves the
        # dominant device→host transfer.  Fast-precision only: exact mode
        # is the CPU verification path, whose public RLE artifacts stay
        # oracle-comparable int pairs.
        self._pack16 = (
            config.precision == "fast"
            and config.entropy == "shared"
            and all(int(np.min(t)) >= 3 for t in self._tables.values())
        )
        # The u16-eligible interchange is the SPARSE-DELTA layout
        # (ops/rle.py::rle_encode_sparse16) — same bytes as packed16, no
        # device-side compaction, and decode folds into the inverse einsum.
        self._sparse16 = self._pack16
        self._forward = jax.jit(self._forward_impl)
        self._inverse = jax.jit(
            self._inverse_impl,
            static_argnames=("bpc", "bpr", "height", "width", "layout"),
        )
        # sparse16 decode entry: ships the (N, 128) combined buffer once
        # and slices channels on device (host views are strided; copying
        # them on the throttled host would dominate decode).
        self._inverse_sparse = jax.jit(
            self._inverse_sparse_impl,
            static_argnames=("bpc", "bpr", "height", "width"),
        )
        self._batch_inverse_sparse = jax.jit(
            lambda comb, bpc, bpr, h, w: jax.vmap(
                lambda cc: self._inverse_sparse_impl(
                    cc, bpc=bpc, bpr=bpr, height=h, width=w
                )
            )(comb),
            static_argnums=(1, 2, 3, 4),
        )
        self._batch_inverse = jax.jit(
            lambda rle, lens, bpc, bpr, h, w, layout: jax.vmap(
                lambda r, l: self._inverse_impl(
                    r, l, bpc=bpc, bpr=bpr, height=h, width=w,
                    layout=layout,
                )
            )(rle, lens),
            static_argnums=(2, 3, 4, 5, 6),
        )

    # ------------------------------------------------------------------
    # Jitted transform stages
    # ------------------------------------------------------------------

    def _forward_impl(self, rgb: jnp.ndarray):
        """RGB (H, W, 3) uint8 → per-channel quantized zigzag streams and
        padded RLE pairs.  Mirrors JPEG.c main():1103-1220.

        Fast mode runs the per-MCU chain as the single fused matmul of
        ``ops/fused.py`` (DCT+quant+zigzag in one matmul); exact mode
        keeps the staged f64 path that is oracle-exact stage by stage.
        """
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        y, cr, cb = rgb_to_ycbcr(rgb, dtype)
        cr_sub = chroma_subsample_422(cr)
        cb_sub = chroma_subsample_422(cb)
        lum, r, b = split_mcus(y, cr_sub, cb_sub)
        out = {}
        for name, tiles in (("lum", lum), ("r", r), ("b", b)):
            zz = forward_channel(tiles, name, self._tables, dtype, fused)
            pairs, lengths = rle_encode_batched(zz.astype(jnp.int16))
            out[name] = {"zz": zz, "rle": pairs, "rle_lengths": lengths}
        return out

    def _split_impl(self, rgb: jnp.ndarray):
        """Image → MCU tile batches (cheap per-shape compile)."""
        dtype = self.config.dtype
        y, cr, cb = rgb_to_ycbcr(rgb, dtype)
        return split_mcus(
            y, chroma_subsample_422(cr), chroma_subsample_422(cb)
        )

    def _mcu_forward_impl(self, lum, r, b):
        """MCU batches → per-channel RLE streams (per-bucket compile)."""
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        if self._sparse16:
            parts = []
            for name, tiles in (("lum", lum), ("r", r), ("b", b)):
                zz = forward_channel(tiles, name, self._tables, dtype, fused)
                sp, _ = rle_encode_sparse16(zz.astype(jnp.int16))
                parts.append(sp)
            return jnp.concatenate(parts, axis=1)
        out = {}
        for name, tiles in (("lum", lum), ("r", r), ("b", b)):
            zz = forward_channel(tiles, name, self._tables, dtype, fused)
            pairs, lengths = rle_encode_batched(zz.astype(jnp.int16))
            out[name] = (
                pairs.astype(jnp.int16), lengths.astype(jnp.int32)
            )
        return out

    def encode_bucketed(self, rgb: np.ndarray, entropy: bool = True) -> "JPEGEncoded":
        """Like ``encode`` but with power-of-two MCU-count bucketing, so a
        stream of mixed image sizes triggers at most ⌈log₂ N⌉ compiles of
        the heavy stage instead of one per distinct size."""
        h, w = rgb.shape[:2]
        bpc, bpr = -(-h // 8), -(-w // 8)
        n = bpc * bpr
        lum, r, b = self._split_stage(jnp.asarray(rgb))
        bucket = 1 << (n - 1).bit_length() if n > 1 else 1
        pad = bucket - n

        def padded(tiles):
            return jnp.pad(tiles, ((0, pad), (0, 0), (0, 0)))

        streams = jax.device_get(
            self._mcu_forward(padded(lum), padded(r), padded(b))
        )
        if self._sparse16:
            enc = self._wrap_sparse(streams[:n], h, w, bpc, bpr)
        else:
            enc = JPEGEncoded(
                height=h,
                width=w,
                blocks_per_col=bpc,
                blocks_per_row=bpr,
                rle={
                    c: np.asarray(streams[c][0][:n], np.int32)
                    for c in CHANNELS
                },
                rle_lengths={
                    c: np.asarray(streams[c][1][:n]) for c in CHANNELS
                },
                quality=self.config.quality,
            )
        if entropy:
            self.entropy_encode(enc)
        return enc

    def _forward_rle_impl(self, rgb: jnp.ndarray):
        """Forward returning only what ``encode`` ships to the host.

        sparse16 mode (the production fast path): ONE (N, 128) uint16
        combined sparse-delta buffer (64 luma + 32 Cr + 32 Cb lanes per
        block).  When this is lowered for a CUDA device and the shape is
        8-aligned, it is the fused Pallas kernel
        (``ops/pallas_fwd.py::forward_kernel``); every other platform and
        shape runs the XLA tile chain + sparse epilogue below, which the
        kernel is tested against.  No lengths side channel: the host
        entropy walk derives lengths for free.

        Pair mode returns int16 interleaved pairs + lengths."""
        if self._sparse16:
            h, w = rgb.shape[:2]
            if h % 8 == 0 and w % 8 == 0:
                from lz4jpeg_tpu.ops.pallas_fwd import forward_kernel

                return jax.lax.platform_dependent(
                    rgb,
                    cuda=lambda x: forward_kernel(
                        x, self._tables["lum"], self._tables["r"]
                    ),
                    default=self._forward_sparse16_xla,
                )
            return self._forward_sparse16_xla(rgb)
        out = self._forward_impl(rgb)
        return {
            c: (v["rle"].astype(jnp.int16), v["rle_lengths"].astype(jnp.int32))
            for c, v in out.items()
        }

    def _forward_sparse16_xla(self, rgb: jnp.ndarray) -> jnp.ndarray:
        """The XLA forward chain of the sparse16 layout: color → tile
        relayout → fused basis matmul per channel → sparse epilogue."""
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        y, cr, cb = rgb_to_ycbcr(rgb, dtype)
        lum, r, b = split_mcus(
            y, chroma_subsample_422(cr), chroma_subsample_422(cb)
        )
        parts = []
        for name, tiles in (("lum", lum), ("r", r), ("b", b)):
            zz = forward_channel(tiles, name, self._tables, dtype, fused)
            sp, _ = rle_encode_sparse16(zz.astype(jnp.int16))
            parts.append(sp)
        return jnp.concatenate(parts, axis=1)

    def _inverse_impl(
        self,
        rle: Dict[str, jnp.ndarray],
        rle_lengths: Dict[str, jnp.ndarray],
        *,
        bpc: int,
        bpr: int,
        height: int,
        width: int,
        layout: str = "pairs",
    ) -> jnp.ndarray:
        """Padded RLE streams → reconstructed RGB.  Mirrors the inverse
        chain JPEG.c:1348-1428.

        sparse16 (the production fast path): the RLE expansion FOLDS into
        the inverse einsum — deltas contract against the suffix-summed
        basis (``ops/fused.py::inverse_suffix_basis``) in plane view with
        the 4:2:2 upsample also folded, so the chain is one einsum + the
        color merge per channel (no expansion stage, any bpr works).

        packed16 / pairs: the staged tile path (membership einsum →
        IDCT → MCU merge)."""
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        if layout == "sparse16" and fused:
            from lz4jpeg_tpu.ops.color import ycbcr_planes_to_rgb
            from lz4jpeg_tpu.ops.fused import fused_inverse_plane_sparse_jnp

            planes = {}
            for name in CHANNELS:
                tw = _CHANNEL_SHAPES[name][1]
                k = 8 * tw
                w16 = rle[name].astype(jnp.int32)
                # i16 deltas (exact: |Δ| ≤ 1022): halves the transposed
                # intermediate's bytes against int32.
                d = jnp.where(
                    w16 != 0, w16 - SPARSE16_DELTA_BIAS, 0
                ).astype(jnp.int16)
                d_kt = jnp.transpose(d.reshape(bpc, bpr, k), (0, 2, 1))
                plane = fused_inverse_plane_sparse_jnp(
                    d_kt, self._tables[name], tw, dtype,
                    upsample_cols=(name != "lum"),
                )
                planes[name] = plane
            return ycbcr_planes_to_rgb(
                planes["lum"], planes["r"], planes["b"],
                height, width, dtype, chroma_upsampled=True,
            )
        rec = {}
        for name in CHANNELS:
            h, w = _CHANNEL_SHAPES[name]
            zz = self._rle_decode_fn(
                rle[name], rle_lengths[name], h * w, layout
            )
            rec[name] = inverse_channel(zz, name, self._tables, dtype, fused)
        return ycbcr_to_rgb_mcus(
            rec["lum"], rec["r"], rec["b"], bpc, bpr, height, width, dtype
        )

    def _inverse_sparse_impl(
        self, combined: jnp.ndarray, *, bpc: int, bpr: int,
        height: int, width: int,
    ) -> jnp.ndarray:
        """(N, 128) combined sparse buffer → RGB (channel slicing on
        device, then the folded-einsum inverse of ``_inverse_impl``)."""

        rle = {c: combined[:, CHANNEL_SLICES[c]] for c in CHANNELS}
        dummy = {c: jnp.zeros(combined.shape[0], jnp.int32) for c in CHANNELS}
        return self._inverse_impl(
            rle, dummy, bpc=bpc, bpr=bpr, height=height, width=width,
            layout="sparse16",
        )

    def _rle_decode_fn(self, pairs, lengths, out_size: int, layout: str):
        """Staged-path RLE expansion (pairs / packed16 / exact-mode
        sparse16): the XLA formulations — the production sparse16 fast
        path never calls this (the expansion folds into the einsum)."""
        if layout == "sparse16":
            return rle_decode_sparse16(pairs)
        if layout == "packed16":
            return rle_decode_packed16(pairs, lengths, out_size)
        return rle_decode_batched(pairs, lengths, out_size)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def _wrap_sparse(
        self, combined: np.ndarray, h: int, w: int, bpc: int, bpr: int
    ) -> JPEGEncoded:
        """(N, 128) combined sparse buffer → JPEGEncoded with per-channel
        views (no copies; lengths stay lazy until the entropy walk)."""

        combined = np.asarray(combined)
        return JPEGEncoded(
            height=h,
            width=w,
            blocks_per_col=bpc,
            blocks_per_row=bpr,
            rle={c: combined[:, CHANNEL_SLICES[c]] for c in CHANNELS},
            rle_lengths=None,
            rle_sparse16=True,
            rle_combined=combined,
            quality=self.config.quality,
        )

    # Minimum blocks before the overlapped encode path engages (below
    # this the banding/threading overhead beats the overlap win).
    _OVERLAP_MIN_BLOCKS = 16384
    _OVERLAP_BANDS = 4

    def _encode_overlapped(self, rgb, h, w, bpc, bpr) -> JPEGEncoded:
        """Encode with the device→host transfer double-buffered against
        the host entropy walk: the device forward is dispatched async, the
        combined buffer comes down in row bands on a worker thread, and
        the native histogram walk of band i runs while band i+1
        transfers.  The pack pass then re-walks the host-resident bands and the
        per-band bitstreams concatenate at bit level — byte-identical
        containers to the one-shot path (the multihost band machinery's
        guarantee, asserted in tests/test_jpeg_pipeline.py)."""
        from concurrent.futures import ThreadPoolExecutor

        from lz4jpeg_tpu.native import native_backend
        from lz4jpeg_tpu.ops.huffman import concat_bitstreams

        native = native_backend()
        out_dev = self._forward_rle(jnp.asarray(rgb))  # async dispatch
        n = bpc * bpr
        k = self._OVERLAP_BANDS
        edges = [n * i // k for i in range(k + 1)]
        combined = np.empty((n, COMBINED_LANES), np.uint16)
        offset = 2048
        slices = CHANNEL_SLICES
        hists = {c: np.zeros(2 * offset, np.int64) for c in CHANNELS}
        lens = {c: [] for c in CHANNELS}
        totals = {c: [] for c in CHANNELS}
        with ThreadPoolExecutor(max_workers=1) as ex:
            futs = [
                ex.submit(jax.device_get, out_dev[a:b])
                for a, b in zip(edges, edges[1:])
            ]
            for (a, b), fut in zip(zip(edges, edges[1:]), futs):
                combined[a:b] = fut.result()
                for c in CHANNELS:
                    row_len = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                    counts, lens_c, total = native.rle_symbol_hist_sparse16(
                        combined[a:b], slices[c].start, row_len,
                        offset, 2 * offset,
                    )
                    hists[c] += counts
                    lens[c].append(lens_c)
                    totals[c].append(total)
        enc = self._wrap_sparse(combined, h, w, bpc, bpr)
        enc.entropy_mode = "shared"
        enc.shared_streams = {}
        enc.rle_lengths = {}
        for c in CHANNELS:
            row_len = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
            (bins,) = np.nonzero(hists[c])
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - offset, hists[c][bins]
            )
            pieces = []
            for (a, b), total in zip(zip(edges, edges[1:]), totals[c]):
                packed, nbits = native.huff_pack_sparse16(
                    combined[a:b], slices[c].start, row_len, codebook, total
                )
                pieces.append((packed, nbits))
            merged, total_bits = concat_bitstreams(pieces)
            enc.shared_streams[c] = (codebook, merged, total_bits)
            enc.rle_lengths[c] = np.concatenate(lens[c])
        return enc

    def encode(self, rgb: np.ndarray, entropy: Optional[bool] = True) -> JPEGEncoded:
        h, w = rgb.shape[:2]
        bpc, bpr = -(-h // 8), -(-w // 8)
        if (
            self._sparse16
            and entropy
            and self.config.entropy == "shared"
            and bpc * bpr >= self._OVERLAP_MIN_BLOCKS
        ):
            from lz4jpeg_tpu.native import native_available

            if native_available():
                return self._encode_overlapped(rgb, h, w, bpc, bpr)
        slim = jax.device_get(self._forward_rle(jnp.asarray(rgb)))
        if self._sparse16:
            enc = self._wrap_sparse(slim, h, w, bpc, bpr)
        else:
            enc = JPEGEncoded(
                height=h,
                width=w,
                blocks_per_col=bpc,
                blocks_per_row=bpr,
                rle={c: np.asarray(slim[c][0], np.int32) for c in CHANNELS},
                rle_lengths={c: np.asarray(slim[c][1]) for c in CHANNELS},
                quality=self.config.quality,
            )
        if entropy:
            self.entropy_encode(enc)
        return enc

    def encode_batch(
        self, rgbs: np.ndarray, entropy: Optional[bool] = True
    ) -> List["JPEGEncoded"]:
        """Encode a (B, H, W, 3) batch of same-size images in one dispatch.

        The batch axis vmaps over the jitted forward — one device round
        trip for the whole batch, which is what amortizes dispatch latency
        in serving (see bench.py's 16-frame batches)."""
        b, h, w = rgbs.shape[:3]
        bpc, bpr = -(-h // 8), -(-w // 8)
        slim = jax.device_get(
            jax.vmap(self._forward_rle)(jnp.asarray(rgbs))
        )
        out = []
        for i in range(b):
            if self._sparse16:
                enc = self._wrap_sparse(slim[i], h, w, bpc, bpr)
            else:
                enc = JPEGEncoded(
                    height=h,
                    width=w,
                    blocks_per_col=bpc,
                    blocks_per_row=bpr,
                    rle={
                        c: np.asarray(slim[c][0][i], np.int32)
                        for c in CHANNELS
                    },
                    rle_lengths={
                        c: np.asarray(slim[c][1][i]) for c in CHANNELS
                    },
                    quality=self.config.quality,
                )
            if entropy:
                self.entropy_encode(enc)
            out.append(enc)
        return out

    def warmup(self, shapes: List[Tuple[int, int]]) -> None:
        """Pre-compile the forward path for the given (H, W) image shapes
        (serving cold-start control; pairs with the persistent XLA
        compilation cache)."""
        for h, w in shapes:
            dummy = jnp.zeros((h, w, 3), jnp.uint8)
            jax.block_until_ready(self._forward_rle(dummy))

    def entropy_encode(self, enc: JPEGEncoded) -> JPEGEncoded:
        mode = self.config.entropy
        enc.entropy_mode = mode
        if mode == "shared" and enc.rle_sparse16:
            from lz4jpeg_tpu.native import native_available, native_backend
            from lz4jpeg_tpu.ops.huffman import (
                build_canonical_codebook,
                pack_symbols,
            )

            native = native_backend() if native_available() else None
            enc.shared_streams = {}
            lengths = {}
            comb = enc.rle_combined
            cols = {c: sl.start for c, sl in CHANNEL_SLICES.items()}
            offset = 2048
            for c in CHANNELS:
                row_len = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                if native is not None:
                    # Native walk over the combined buffer in place: the
                    # histogram pass also yields the per-block symbol
                    # lengths (the device never ships a lengths side
                    # channel in this layout).
                    if comb is not None:
                        buf, col = comb, cols[c]
                    else:
                        buf, col = np.ascontiguousarray(enc.rle[c]), 0
                    counts, lens_c, total = native.rle_symbol_hist_sparse16(
                        buf, col, row_len, offset, 2 * offset
                    )
                    (bins,) = np.nonzero(counts)
                    codebook = build_canonical_codebook_from_counts(
                        bins.astype(np.int64) - offset, counts[bins]
                    )
                    packed, nbits = native.huff_pack_sparse16(
                        buf, col, row_len, codebook, total
                    )
                else:
                    symbols, lens_c = _sparse_symbols_host(
                        np.asarray(enc.rle[c])
                    )
                    codebook = build_canonical_codebook(symbols)
                    packed, nbits = pack_symbols(symbols, codebook)
                enc.shared_streams[c] = (codebook, packed, nbits)
                lengths[c] = lens_c
            enc.rle_lengths = lengths
            return enc
        if mode == "shared":
            from lz4jpeg_tpu.native import native_available, native_backend

            native = native_backend() if native_available() else None
            enc.shared_streams = {}
            for c in CHANNELS:
                if native is not None:
                    # Two C++ passes over the padded pairs (histogram, then
                    # map+pack) — the numpy mask-compact + np.unique route
                    # below costs seconds per channel on a throttled host.
                    # The packed-u16 layout is consumed directly (the int32
                    # pairs never materialize on the host).
                    offset = 2048  # symbols are counts ≤128 or coeffs |v|<2047
                    hist = (
                        native.rle_symbol_hist16
                        if enc.rle_packed16
                        else native.rle_symbol_hist
                    )
                    counts, _ = hist(
                        enc.rle[c], enc.rle_lengths[c], offset, 2 * offset
                    )
                    (bins,) = np.nonzero(counts)
                    codebook = build_canonical_codebook_from_counts(
                        bins.astype(np.int64) - offset, counts[bins]
                    )
                    pack = (
                        native.huff_pack_pairs16
                        if enc.rle_packed16
                        else native.huff_pack_pairs
                    )
                    packed, nbits = pack(
                        enc.rle[c], enc.rle_lengths[c], codebook
                    )
                else:
                    pairs = (
                        _unpack16_host(enc.rle[c])
                        if enc.rle_packed16
                        else enc.rle[c]
                    )
                    symbols = _valid_symbols(pairs, enc.rle_lengths[c])
                    codebook = build_canonical_codebook(symbols)
                    packed, nbits = pack_symbols(symbols, codebook)
                enc.shared_streams[c] = (codebook, packed, nbits)
        else:  # per_block parity mode
            from lz4jpeg_tpu.native import native_available, native_backend

            native = native_backend() if native_available() else None
            enc.per_block_bits = {}
            for c in CHANNELS:
                bits_list = None
                if native is not None:
                    # One C++ pass over all blocks (quirk-exact twin of the
                    # oracle heap; tested bitstring-identical) — the Python
                    # loop below runs the interpreted heap ~49k times at
                    # 2048² and cannot reach the reference's largest sizes.
                    bits_list = native.huff_per_block(
                        np.asarray(enc.rle[c], np.int32),
                        np.asarray(enc.rle_lengths[c], np.int32),
                    )
                if bits_list is None:
                    bits_list = []
                    for i in range(enc.num_blocks):
                        n = int(enc.rle_lengths[c][i])
                        rle_ints = [int(v) for v in enc.rle[c][i, :n]]
                        bits, _root, _codes = (
                            jpeg_oracle.encode_huffman_oracle(rle_ints)
                        )
                        bits_list.append(bits)
                enc.per_block_bits[c] = bits_list
        return enc

    def entropy_decode(self, enc: JPEGEncoded) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Recover padded RLE streams from the entropy bitstreams (the
        enc's own layout: sparse16 rebuilds the combined buffer in place
        and refreshes ``enc.rle_combined``)."""
        if enc.entropy_mode == "shared" and enc.rle_sparse16:
            from lz4jpeg_tpu.native import native_available, native_backend
            from lz4jpeg_tpu.ops.huffman import unpack_symbols

            native = native_backend() if native_available() else None
            combined = np.zeros(
                (enc.num_blocks, COMBINED_LANES), np.uint16
            )
            slices = CHANNEL_SLICES
            lengths = {}
            for c in CHANNELS:
                codebook, packed, nbits = enc.shared_streams[c]
                block_size = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                got = None
                if native is not None:
                    got = native.huff_unpack_sparse16(
                        packed, nbits, codebook, block_size,
                        enc.num_blocks, out_sparse=combined,
                        col_off=slices[c].start,
                    )
                if got is None:
                    symbols = unpack_symbols(packed, nbits, codebook)
                    pairs, lens = _split_symbols(
                        symbols, enc.num_blocks, 2 * block_size, block_size
                    )
                    sp, lens = _pairs_to_sparse_host(pairs, lens, block_size)
                    combined[:, slices[c]] = sp
                    lengths[c] = lens
                else:
                    lengths[c] = got[1]
            enc.rle_combined = combined
            enc.rle = {c: combined[:, slices[c]] for c in CHANNELS}
            enc.rle_lengths = lengths
            return enc.rle, lengths
        if enc.entropy_mode == "shared":
            from lz4jpeg_tpu.native import native_available, native_backend

            native = native_backend() if native_available() else None
            rle, lengths = {}, {}
            for c in CHANNELS:
                codebook, packed, nbits = enc.shared_streams[c]
                pad_width = enc.rle[c].shape[1]
                block_size = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                got = None
                if native is not None and enc.rle_packed16:
                    got = native.huff_unpack_pairs16(
                        packed, nbits, codebook,
                        block_size, enc.num_blocks, pad_width,
                    )
                elif native is not None:
                    got = native.huff_unpack_pairs(
                        packed, nbits, codebook,
                        block_size, enc.num_blocks, pad_width,
                    )
                if got is None:
                    # Pure-Python spec path; also the quirk-compatible
                    # handler for streams the strict native walker rejects.
                    symbols = unpack_symbols(packed, nbits, codebook)
                    sym_pad = (
                        2 * pad_width if enc.rle_packed16 else pad_width
                    )
                    pairs, lens = _split_symbols(
                        symbols, enc.num_blocks, sym_pad, block_size
                    )
                    got = (
                        (_pack16_host(pairs), lens)
                        if enc.rle_packed16
                        else (pairs, lens)
                    )
                rle[c], lengths[c] = got
            return rle, lengths
        if enc.entropy_mode == "per_block":
            # Per-block trees are in-memory only (like the reference, which
            # never serializes them, SURVEY.md §2.2.8) — the RLE arrays on
            # ``enc`` are authoritative.
            return enc.rle, enc.rle_lengths
        return enc.rle, enc.rle_lengths

    @staticmethod
    def _layout_of(enc: JPEGEncoded) -> str:
        if enc.rle_sparse16:
            return "sparse16"
        return "packed16" if enc.rle_packed16 else "pairs"

    @staticmethod
    def _lengths_or_dummy(rle, lengths):
        """sparse16 needs no lengths side channel; feed zeros so the jit
        signature stays uniform (tiny arrays, validity is implicit)."""
        if lengths is not None:
            return {c: jnp.asarray(lengths[c]) for c in CHANNELS}
        return {
            c: jnp.zeros(np.asarray(rle[c]).shape[0], jnp.int32)
            for c in CHANNELS
        }

    def decode(self, enc: JPEGEncoded, from_entropy: bool = True) -> np.ndarray:
        if from_entropy and enc.entropy_mode is not None:
            rle, lengths = self.entropy_decode(enc)
        else:
            rle, lengths = enc.rle, enc.rle_lengths
        if self._layout_of(enc) == "sparse16" and enc.rle_combined is not None:
            rgb = self._inverse_sparse(
                jnp.asarray(enc.rle_combined),
                bpc=enc.blocks_per_col,
                bpr=enc.blocks_per_row,
                height=enc.height,
                width=enc.width,
            )
            return np.asarray(jax.device_get(rgb))
        rgb = self._inverse(
            {c: jnp.asarray(np.ascontiguousarray(rle[c])) for c in CHANNELS},
            self._lengths_or_dummy(rle, lengths),
            bpc=enc.blocks_per_col,
            bpr=enc.blocks_per_row,
            height=enc.height,
            width=enc.width,
            layout=self._layout_of(enc),
        )
        return np.asarray(jax.device_get(rgb))

    def decode_batch(
        self, encs: List["JPEGEncoded"], from_entropy: bool = True
    ) -> List[np.ndarray]:
        """Decode same-size encodes in one vmapped dispatch (the inverse
        of ``encode_batch`` — one device round trip for the whole batch)."""
        if not encs:
            return []
        e0 = encs[0]
        key = (e0.height, e0.width, self._layout_of(e0))
        for e in encs[1:]:
            if (e.height, e.width, self._layout_of(e)) != key:
                raise ValueError(
                    "decode_batch requires same-size encodes with one RLE "
                    "layout; decode() them individually instead"
                )
        streams = []
        for e in encs:
            if from_entropy and e.entropy_mode is not None:
                streams.append(self.entropy_decode(e))
            else:
                streams.append((e.rle, e.rle_lengths))
        if key[2] == "sparse16" and all(
            e.rle_combined is not None for e in encs
        ):
            comb = jnp.asarray(np.stack([e.rle_combined for e in encs]))
            rgb = self._batch_inverse_sparse(
                comb, e0.blocks_per_col, e0.blocks_per_row,
                e0.height, e0.width,
            )
            rgb = np.asarray(jax.device_get(rgb))
            return [rgb[i] for i in range(len(encs))]
        rle_b = {
            c: jnp.asarray(
                np.stack([np.ascontiguousarray(s[0][c]) for s in streams])
            )
            for c in CHANNELS
        }
        len_b = {
            c: jnp.asarray(np.stack([
                np.asarray(s[1][c]) if s[1] is not None
                else np.zeros(np.asarray(s[0][c]).shape[0], np.int32)
                for s in streams
            ]))
            for c in CHANNELS
        }
        rgb = self._batch_inverse(
            rle_b, len_b, e0.blocks_per_col, e0.blocks_per_row,
            e0.height, e0.width, key[2],
        )
        rgb = np.asarray(jax.device_get(rgb))
        return [rgb[i] for i in range(len(encs))]

    def _mcu_inverse_impl(self, rle, rle_lengths, layout: str = "pairs"):
        """Padded RLE → per-channel pixel tiles (per-bucket compile)."""
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        rec = {}
        for name in CHANNELS:
            h, w = _CHANNEL_SHAPES[name]
            zz = self._rle_decode_fn(
                rle[name], rle_lengths[name], h * w, layout
            )
            rec[name] = inverse_channel(zz, name, self._tables, dtype, fused)
        return rec

    def decode_bucketed(
        self, enc: JPEGEncoded, from_entropy: bool = True
    ) -> np.ndarray:
        """Like ``decode`` but the heavy MCU inverse compiles per
        power-of-two MCU bucket (see ``encode_bucketed``)."""
        if from_entropy and enc.entropy_mode is not None:
            rle, lengths = self.entropy_decode(enc)
        else:
            rle, lengths = enc.rle, enc.rle_lengths
        n = enc.num_blocks
        bucket = 1 << (n - 1).bit_length() if n > 1 else 1
        pad = bucket - n
        rle_j = {
            c: jnp.pad(
                jnp.asarray(np.ascontiguousarray(rle[c])), ((0, pad), (0, 0))
            )
            for c in CHANNELS
        }
        len_j = {
            c: jnp.pad(v, (0, pad))
            for c, v in self._lengths_or_dummy(rle, lengths).items()
        }
        rec = self._mcu_inverse(rle_j, len_j, layout=self._layout_of(enc))
        rgb = ycbcr_to_rgb_mcus(
            rec["lum"][:n], rec["r"][:n], rec["b"][:n],
            enc.blocks_per_col, enc.blocks_per_row, enc.height, enc.width,
            self.config.dtype,
        )
        return np.asarray(jax.device_get(rgb))

    def roundtrip(self, rgb: np.ndarray) -> np.ndarray:
        """Full encode→decode, the reference's self-verification pattern
        (SURVEY.md §4)."""
        return self.decode(self.encode(rgb))

    def forward_stages(self, rgb: np.ndarray) -> Dict[str, Dict[str, np.ndarray]]:
        """All jitted forward intermediates (for stage-by-stage parity
        tests against the oracle)."""
        return jax.device_get(self._forward(jnp.asarray(rgb)))


def _unpack16_host(packed: np.ndarray) -> np.ndarray:
    """(N, L) packed uint16 → (N, 2L) interleaved int32 pairs (numpy,
    fallback paths only — the native passes consume packed directly)."""
    p = packed.astype(np.int32)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (p >> 10) + 1
    out[:, 1::2] = (p & 0x3FF) - 512
    return out


def _pack16_host(pairs: np.ndarray) -> np.ndarray:
    """(N, 2L) interleaved int32 pairs → (N, L) packed uint16 (padding
    slots stay 0, mirroring ``ops.rle.pack16_pairs``)."""
    counts = pairs[:, 0::2].astype(np.int32)
    vals = pairs[:, 1::2].astype(np.int32)
    packed = (np.maximum(counts - 1, 0) << 10) | (vals + 512)
    return np.where(counts > 0, packed, 0).astype(np.uint16)


def _sparse_symbols_host(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, K) sparse-delta uint16 → (flat [count, value, ...] symbol
    stream, (N,) per-block symbol lengths) — the vectorized numpy twin of
    the native walk (fallback paths only)."""
    w = np.asarray(w).astype(np.int64)
    n, k = w.shape
    d = np.where(w != 0, w - SPARSE16_DELTA_BIAS, 0)
    vals_full = np.cumsum(d, axis=1)
    starts = w != 0
    rows, colidx = np.nonzero(starts)
    nxt = np.empty_like(colidx)
    if len(colidx):
        same = rows[1:] == rows[:-1]
        nxt[:-1] = np.where(same, colidx[1:], k)
        nxt[-1] = k
    counts = nxt - colidx
    values = vals_full[rows, colidx]
    out = np.empty(2 * len(colidx), np.int64)
    out[0::2] = counts
    out[1::2] = values
    return out, 2 * starts.sum(axis=1).astype(np.int32)


def _pairs_to_sparse_host(
    pairs: np.ndarray, lengths: np.ndarray, block_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 2K) int pairs + lengths → ((N, block_size) sparse-delta uint16,
    lengths) — numpy fallback for the quirk-compatible decode path."""
    pairs = np.asarray(pairs, np.int64)
    counts = pairs[:, 0::2]
    vals = pairs[:, 1::2]
    k = counts.shape[1]
    valid = np.arange(k)[None, :] < (np.asarray(lengths) // 2)[:, None]
    counts = np.where(valid, counts, 0)
    starts_pos = np.cumsum(counts, axis=1) - counts  # run start positions
    prev_vals = np.zeros_like(vals)
    prev_vals[:, 1:] = vals[:, :-1]
    deltas = np.where(valid, vals - prev_vals, 0)
    sp = np.zeros((pairs.shape[0], block_size), np.uint16)
    rows, slots = np.nonzero(valid)
    sp[rows, starts_pos[rows, slots]] = (
        deltas[rows, slots] + SPARSE16_DELTA_BIAS
    ).astype(np.uint16)
    return sp, np.asarray(lengths, np.int32)


def _valid_symbols(pairs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flatten padded (N, 2L) RLE pairs into one symbol stream."""
    mask = np.arange(pairs.shape[1])[None, :] < lengths[:, None]
    return pairs[mask].astype(np.int32)


def _split_symbols(
    symbols: np.ndarray, num_blocks: int, pad_width: int, block_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-block a flat symbol stream: each block's pairs end once their
    counts sum to ``block_size`` (RLE of a full block always covers it).
    Fully vectorized: ``block_of_pair`` is nondecreasing, so block
    boundaries come from two searchsorteds and the scatter targets from a
    running offset."""
    pairs = np.zeros((num_blocks, pad_width), np.int32)
    lengths = np.zeros(num_blocks, np.int32)
    counts = symbols[0::2].astype(np.int64)
    values = symbols[1::2].astype(np.int64)
    ends = np.cumsum(counts)
    # Pair j belongs to block (ends[j]-1) // block_size.
    block_of_pair = (ends - 1) // block_size
    starts = np.searchsorted(block_of_pair, np.arange(num_blocks), "left")
    stops = np.searchsorted(block_of_pair, np.arange(num_blocks), "right")
    lengths[:] = 2 * (stops - starts)
    slot = np.arange(len(counts)) - starts[block_of_pair]
    flat_idx = block_of_pair * pad_width + 2 * slot
    pairs.reshape(-1)[flat_idx] = counts
    pairs.reshape(-1)[flat_idx + 1] = values
    return pairs, lengths


@functools.lru_cache(maxsize=None)
def default_pipeline(precision: str = "fast", entropy: str = "shared") -> JPEGPipeline:
    return JPEGPipeline(JPEGConfig(precision=precision, entropy=entropy))
