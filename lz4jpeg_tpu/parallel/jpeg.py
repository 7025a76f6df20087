"""Sharded JPEG forward: the MCU axis distributed over the device mesh.

The reference spawns one thread per 8×8 MCU, each running the whole
DCT→quant→zigzag→RLE chain (``process``,
``Algorithms/parallel/JPEG/JPEG.c:1103-1252``), then gathers by index — and
loses the results to a pass-by-value bug (:1300).  Here the MCU batch is a
sharded array: ``jit`` with sharding constraints lets XLA partition the
batched einsum/VPU kernels across devices, and the "gather" is simply the
output sharding — order is positional, a bug of this class cannot exist.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lz4jpeg_tpu.config import JPEGConfig
from lz4jpeg_tpu.models.jpeg import (
    forward_channel,
    inverse_channel,
    scaled_tables,
)
from lz4jpeg_tpu.ops.color import chroma_subsample_422, rgb_to_ycbcr, split_mcus
from lz4jpeg_tpu.ops.rle import rle_encode_batched
from lz4jpeg_tpu.parallel.mesh import pad_to_devices

_CHANNEL_SHAPES = {"lum": (8, 8), "r": (8, 4), "b": (8, 4)}


class ShardedJPEGForward:
    """Forward transform with the MCU axis sharded over a mesh.

    The color transform + MCU split run replicated (cheap, bandwidth-bound,
    and dependent on full image rows); the per-MCU compute — DCT matmuls,
    quantization, zigzag gather, RLE compaction — runs sharded.  Quant
    tables are replicated constants (the reference's shared in-memory
    tables, SURVEY.md §2.3).
    """

    def __init__(self, mesh: Mesh, config: JPEGConfig = JPEGConfig()):
        self.mesh = mesh
        self.config = config
        self._tables = scaled_tables(config.quality)
        axis = mesh.axis_names[0]
        self._shard = NamedSharding(mesh, P(axis))
        self._mcu_stage = jax.jit(
            self._mcu_stage_impl,
            in_shardings=(self._shard, self._shard, self._shard),
            out_shardings=self._shard,
        )

    def _mcu_stage_impl(self, lum, r, b):
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        out = {}
        for name, tiles in (("lum", lum), ("r", r), ("b", b)):
            zz = forward_channel(tiles, name, self._tables, dtype, fused)
            pairs, lengths = rle_encode_batched(zz.astype(jnp.int16))
            out[name] = {"zz": zz, "rle": pairs, "rle_lengths": lengths}
        return out

    def inverse(
        self,
        rle: Dict[str, np.ndarray],
        rle_lengths: Dict[str, np.ndarray],
        bpc: int,
        bpr: int,
        height: int,
        width: int,
        layout: Optional[str] = None,
    ) -> np.ndarray:
        """Sharded inverse chain: RLE → IDCT per MCU shard, then merge.

        The reference's parallel variant runs the whole inverse per MCU
        thread too (``process``, Algorithms/parallel/JPEG/JPEG.c:1103-1252)
        — and then loses the results to its by-value bug; here the shard is
        the unit and the merge is the output sharding."""
        from lz4jpeg_tpu.ops.color import ycbcr_to_rgb_mcus
        from lz4jpeg_tpu.ops.rle import (
            rle_decode_batched,
            rle_decode_packed16,
            rle_decode_sparse16,
        )

        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        n_dev = self.mesh.devices.size
        n_mcus = bpc * bpr
        if layout is None:
            if np.asarray(rle["lum"]).dtype == np.uint16:
                # uint16 is AMBIGUOUS (packed16 pairs vs
                # sparse16 deltas carry the same dtype); decoding sparse
                # words as pairs would silently corrupt the image, so
                # demand an explicit layout instead of guessing.
                raise ValueError(
                    "uint16 RLE streams are ambiguous: pass "
                    'layout="packed16" or layout="sparse16"'
                )
            layout = "pairs"

        def stage(rle_j, len_j):
            rec = {}
            for name in ("lum", "r", "b"):
                h, w = _CHANNEL_SHAPES[name]
                if layout == "sparse16":
                    zz = rle_decode_sparse16(rle_j[name])
                elif layout == "packed16":
                    zz = rle_decode_packed16(rle_j[name], len_j[name], h * w)
                else:
                    zz = rle_decode_batched(rle_j[name], len_j[name], h * w)
                rec[name] = inverse_channel(
                    zz, name, self._tables, dtype, fused
                )
            return rec

        padded_rle, padded_len = {}, {}
        for c in ("lum", "r", "b"):
            padded_rle[c], _ = pad_to_devices(
                np.ascontiguousarray(rle[c]), n_dev
            )
            lens_c = (
                np.asarray(rle_lengths[c])
                if rle_lengths is not None
                # sparse16 needs no lengths side channel
                else np.zeros(np.asarray(rle[c]).shape[0], np.int32)
            )
            padded_len[c], _ = pad_to_devices(lens_c, n_dev)
        put = functools.partial(jax.device_put, device=self._shard)
        rec = jax.jit(
            stage,
            in_shardings=(self._shard, self._shard),
            out_shardings=self._shard,
        )(
            {c: put(v) for c, v in padded_rle.items()},
            {c: put(v) for c, v in padded_len.items()},
        )
        rec = jax.device_get(rec)
        return np.asarray(
            ycbcr_to_rgb_mcus(
                jnp.asarray(rec["lum"][:n_mcus]),
                jnp.asarray(rec["r"][:n_mcus]),
                jnp.asarray(rec["b"][:n_mcus]),
                bpc, bpr, height, width, dtype,
            )
        )

    def __call__(self, rgb: np.ndarray) -> Tuple[Dict[str, Dict[str, np.ndarray]], int]:
        """RGB image → per-channel sharded forward results.

        Returns ``(stages, num_mcus)`` with padding rows (beyond
        ``num_mcus``) still present in the arrays.
        """
        y, cr, cb = rgb_to_ycbcr(jnp.asarray(rgb), self.config.dtype)
        lum, r, b = split_mcus(
            y, chroma_subsample_422(cr), chroma_subsample_422(cb)
        )
        n_dev = self.mesh.devices.size
        lum, n = pad_to_devices(np.asarray(lum), n_dev)
        r, _ = pad_to_devices(np.asarray(r), n_dev)
        b, _ = pad_to_devices(np.asarray(b), n_dev)
        put = functools.partial(jax.device_put, device=self._shard)
        stages = self._mcu_stage(put(lum), put(r), put(b))
        return jax.device_get(stages), n


class ShardedSparseJPEG:
    """Production multi-device JPEG: the sparse16 forward and the folded
    inverse, band-sharded over the mesh with ``shard_map``.

    Every forward and inverse op is row-local at 8-pixel-band
    granularity (color, 4:2:2, the per-block basis matmuls, the plane
    merges), so a contiguous band of block-rows per
    device needs NO cross-device communication until the output
    sharding itself — the collective equivalent of the reference's
    thread-per-MCU fan-out (JPEG.c:1297-1304) with the gather done by
    layout.  Outputs are bit-identical to the single-device pipeline
    (asserted in tests/test_parallel.py and the driver dryrun)."""

    def __init__(self, mesh: Mesh, config: Optional[JPEGConfig] = None):
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        self.mesh = mesh
        self.config = config or JPEGConfig(
            precision="fast", entropy="shared"
        )
        self.pipeline = JPEGPipeline(self.config)
        if not self.pipeline._sparse16:
            raise ValueError(
                "ShardedSparseJPEG requires a sparse16-eligible config "
                "(precision='fast', entropy='shared', moderate quality)"
            )
        self._axis = mesh.axis_names[0]
        self._fwd = None
        self._inv = {}

    def forward(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 → (N, 128) uint16 combined sparse streams,
        computed band-parallel over the mesh (block-rows padded to a
        mesh multiple with zero rows, sliced off after).

        Requires H % 8 == 0 and W % 8 == 0; ragged shapes delegate to
        the single-device pipeline.  Zero-padding raggedness at the RGB
        level would run the color transform over the padding (padded
        chroma becomes 128, not the plane-domain zeros ``split_mcus``
        pads with) and silently break the bit-identity guarantee —
        whole padded block-ROWS are safe (forward ops are block-local
        and the fake blocks are sliced off), partial blocks are not."""
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        h, w = rgb.shape[:2]
        bpc, bpr = -(-h // 8), -(-w // 8)
        if h % 8 or w % 8:
            enc = self.pipeline.encode(np.asarray(rgb), entropy=False)
            return np.asarray(enc.rle_combined)
        n_dev = self.mesh.devices.size
        bpc_pad = -(-bpc // n_dev) * n_dev
        img = np.zeros((8 * bpc_pad, 8 * bpr, 3), np.uint8)
        img[:h, :w] = rgb

        if self._fwd is None:
            impl = self.pipeline._forward_rle_impl

            @jax.jit
            def fwd(x):
                # check_vma=False: the shard is purely data-parallel (no
                # collectives), so the varying-mesh-axes check adds
                # nothing here.
                return shard_map(
                    impl, mesh=self.mesh,
                    in_specs=P(self._axis),
                    out_specs=P(self._axis),
                    check_vma=False,
                )(x)

            self._fwd = fwd
        combined = jax.device_get(self._fwd(jnp.asarray(img)))
        return np.asarray(combined)[: bpc * bpr]

    def inverse(
        self, combined: np.ndarray, bpc: int, bpr: int,
        height: int, width: int,
    ) -> np.ndarray:
        """(N, 128) combined sparse streams → (height, width, 3) uint8,
        the folded-einsum decode band-parallel over the mesh."""
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        n_dev = self.mesh.devices.size
        bpc_pad = -(-bpc // n_dev) * n_dev
        comb = np.zeros((bpc_pad * bpr, combined.shape[1]), np.uint16)
        comb[: bpc * bpr] = combined
        band_bpc = bpc_pad // n_dev
        key = (band_bpc, bpr)
        if key not in self._inv:
            impl = self.pipeline._inverse_sparse_impl

            def band(x):
                return impl(
                    x, bpc=band_bpc, bpr=bpr,
                    height=8 * band_bpc, width=8 * bpr,
                )

            @jax.jit
            def inv(x):
                return shard_map(
                    band, mesh=self.mesh,
                    in_specs=P(self._axis),
                    out_specs=P(self._axis),
                    check_vma=False,
                )(x)

            self._inv[key] = inv
        rgb = jax.device_get(self._inv[key](jnp.asarray(comb)))
        return np.asarray(rgb)[:height, :width]


def multihost_jpeg_encode(rgb: np.ndarray, config: JPEGConfig = None) -> bytes:
    """Cross-host JPEG encode → TJPG container bytes, identical on every
    process and byte-equal to a single-process encode.

    The multi-host shape of the reference's MCU fan-out
    (``Algorithms/parallel/JPEG/JPEG.c:1297-1304``) plus its shared
    in-memory Huffman tables (SURVEY.md §2.2.8), done the collective way:

    * each process transforms its contiguous band of 8-pixel MCU rows
      (color transform and 4:2:2 subsampling are row-local, so bands are
      independent);
    * per-channel symbol histograms all-reduce across processes, so every
      process builds the *identical* canonical codebook — the broadcast
      shared-tables pattern across hosts;
    * each process entropy-packs its own band and the bitstreams gather in
      band order (``ordered_allgather_payloads``) with a host-side bit
      concatenation, since substreams end at arbitrary bit offsets.

    Call under an initialized ``jax.distributed`` runtime; in a single
    process it degrades to a local encode.
    """
    import jax
    from jax.experimental import multihost_utils

    from lz4jpeg_tpu.formats.jpeg_container import pack_container
    from lz4jpeg_tpu.models.jpeg import (
        CHANNELS,
        JPEGEncoded,
        JPEGPipeline,
        _valid_symbols,
    )
    from lz4jpeg_tpu.native import native_available, native_backend
    from lz4jpeg_tpu.ops.huffman import (
        build_canonical_codebook_from_counts,
        concat_bitstreams,
        pack_symbols,
    )
    from lz4jpeg_tpu.parallel.multihost import ordered_allgather_payloads

    config = config or JPEGConfig(precision="fast", entropy="shared")
    if config.entropy != "shared":
        raise ValueError("multihost encode requires the shared entropy mode")
    pid, nproc = jax.process_index(), jax.process_count()
    h, w = rgb.shape[:2]
    bpc = -(-h // 8)
    splits = np.array_split(np.arange(bpc), nproc)
    my_rows = splits[pid]
    pipeline = JPEGPipeline(config)

    OFFSET, NBINS = 2048, 4096
    native = native_backend() if native_available() else None
    local = {}
    hists = np.zeros((len(CHANNELS), NBINS), np.int64)
    if len(my_rows):
        band = rgb[my_rows[0] * 8 : min((my_rows[-1] + 1) * 8, h)]
        import jax.numpy as jnp

        slim = jax.device_get(pipeline._forward_rle(jnp.asarray(band)))
        if pipeline._sparse16:
            # sparse-delta combined buffer: the native hist
            # walk also yields the symbol totals the pack pass sizes by.
            from lz4jpeg_tpu.models.jpeg import _sparse_symbols_host

            comb = np.asarray(slim)
            cols = {"lum": (0, 64), "r": (64, 32), "b": (96, 32)}
            for ci, c in enumerate(CHANNELS):
                col, row_len = cols[c]
                if native is not None:
                    counts, _, total = native.rle_symbol_hist_sparse16(
                        comb, col, row_len, OFFSET, NBINS
                    )
                    local[c] = ("sparse_native", comb, col, row_len, total)
                else:
                    symbols, _ = _sparse_symbols_host(
                        comb[:, col : col + row_len]
                    )
                    vals, cnt = np.unique(symbols, return_counts=True)
                    counts = np.zeros(NBINS, np.int64)
                    counts[vals + OFFSET] = cnt
                    local[c] = ("sparse_py", symbols, None, None, None)
                hists[ci] = counts
        else:
            for ci, c in enumerate(CHANNELS):
                pairs = np.asarray(slim[c][0], np.int32)
                lengths = np.asarray(slim[c][1], np.int32)
                local[c] = ("pairs", pairs, lengths, None, None)
                if native is not None:
                    counts, _ = native.rle_symbol_hist(
                        pairs, lengths, OFFSET, NBINS
                    )
                else:
                    vals, cnt = np.unique(
                        _valid_symbols(pairs, lengths), return_counts=True
                    )
                    counts = np.zeros(NBINS, np.int64)
                    counts[vals + OFFSET] = cnt
                hists[ci] = counts

    global_hists = hists
    if nproc > 1:
        global_hists = multihost_utils.process_allgather(hists).sum(axis=0)

    shared = {}
    for ci, c in enumerate(CHANNELS):
        (bins,) = np.nonzero(global_hists[ci])
        codebook = build_canonical_codebook_from_counts(
            bins.astype(np.int64) - OFFSET, global_hists[ci][bins]
        )
        if c in local:
            kind, a, b_, row_len, total = local[c]
            if kind == "sparse_native":
                packed, nbits = native.huff_pack_sparse16(
                    a, b_, row_len, codebook, total
                )
            elif kind == "sparse_py":
                packed, nbits = pack_symbols(a, codebook)
            elif native is not None:
                packed, nbits = native.huff_pack_pairs(a, b_, codebook)
            else:
                packed, nbits = pack_symbols(
                    _valid_symbols(a, b_), codebook
                )
        else:
            packed, nbits = b"", 0
        pieces = ordered_allgather_payloads([packed], [pid], nproc)
        all_nbits = np.asarray([nbits], np.int64)
        if nproc > 1:
            all_nbits = multihost_utils.process_allgather(
                np.asarray([nbits], np.int64)
            ).reshape(-1)
        merged, total_bits = concat_bitstreams(
            list(zip(pieces, all_nbits.tolist()))
        )
        shared[c] = (codebook, merged, total_bits)

    enc = JPEGEncoded(
        height=h,
        width=w,
        blocks_per_col=bpc,
        blocks_per_row=-(-w // 8),
        rle={c: np.zeros((0, 0), np.int32) for c in CHANNELS},
        rle_lengths={c: np.zeros(0, np.int32) for c in CHANNELS},
        entropy_mode="shared",
        shared_streams=shared,
        quality=config.quality,
    )
    return pack_container(enc)


def multihost_jpeg_decode(
    container: bytes, config: JPEGConfig = None
) -> np.ndarray:
    """Cross-host TJPG decode → the full RGB image, identical on every
    process and bit-equal to a single-process ``JPEGPipeline.decode``.

    The decode-side mirror of ``multihost_jpeg_encode``: every process
    entropy-decodes the (replicated) container, takes its contiguous band
    of 8-pixel MCU rows — bands are independent because the 4:2:2
    subsampling is horizontal-only — runs the device inverse chain
    (RLE → dequant → IDCT → YCbCr merge) on its band, and the
    reconstructed bands gather in band order over the interconnect.  The
    reference's parallel decode ran per-MCU threads through the same
    inverse chain and lost the results to its by-value bug
    (``Algorithms/parallel/JPEG/JPEG.c:1103-1252,1300``).
    """
    import jax.numpy as jnp

    from lz4jpeg_tpu.formats.jpeg_container import unpack_container
    from lz4jpeg_tpu.models.jpeg import CHANNELS, JPEGPipeline
    from lz4jpeg_tpu.parallel.multihost import ordered_allgather_payloads

    pid, nproc = jax.process_index(), jax.process_count()
    enc = unpack_container(container)
    config = config or JPEGConfig(
        precision="fast", entropy="shared", quality=enc.quality
    )
    pipeline = JPEGPipeline(config)
    rle, lengths = pipeline.entropy_decode(enc)
    bpc, bpr = enc.blocks_per_col, enc.blocks_per_row
    splits = np.array_split(np.arange(bpc), nproc)
    my_rows = splits[pid]
    # Band ids are dense over the processes that actually got rows (tiny
    # images can leave trailing processes idle).
    band_count = sum(1 for s in splits if len(s))
    my_band = sum(1 for s in splits[:pid] if len(s))
    payload = b""
    if len(my_rows):
        r0, r1 = int(my_rows[0]), int(my_rows[-1])
        band_h = min((r1 + 1) * 8, enc.height) - r0 * 8
        sl = slice(r0 * bpr, (r1 + 1) * bpr)
        layout = pipeline._layout_of(enc)
        if layout == "sparse16" and enc.rle_combined is not None:
            # Band rows of the combined buffer are contiguous — ship the
            # slice and let the device split channels (models/jpeg.py
            # ``_inverse_sparse``).
            band = pipeline._inverse_sparse(
                jnp.asarray(enc.rle_combined[sl]),
                bpc=r1 - r0 + 1,
                bpr=bpr,
                height=band_h,
                width=enc.width,
            )
        else:
            band = pipeline._inverse(
                {
                    c: jnp.asarray(
                        np.ascontiguousarray(np.asarray(rle[c])[sl])
                    )
                    for c in CHANNELS
                },
                {
                    c: jnp.asarray(np.asarray(lengths[c])[sl])
                    if lengths is not None
                    else jnp.zeros(
                        np.asarray(rle[c])[sl].shape[0], jnp.int32
                    )
                    for c in CHANNELS
                },
                bpc=r1 - r0 + 1,
                bpr=bpr,
                height=band_h,
                width=enc.width,
                layout=layout,
            )
        payload = np.asarray(jax.device_get(band)).tobytes()
    bands = ordered_allgather_payloads(
        [payload] if len(my_rows) else [],
        [my_band] if len(my_rows) else [],
        band_count,
    )
    rows = [
        np.frombuffer(b, np.uint8).reshape(-1, enc.width, 3) for b in bands
    ]
    return np.concatenate(rows, axis=0)
