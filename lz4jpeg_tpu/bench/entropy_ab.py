"""Entropy-stage placement A/B: host C++ pack vs on-device pack.

Whether the production entropy stage should run on the device: this
sweep measures both placements of the bit packing on one platform and
writes the numbers to a JSON artifact.

The trade under test (container path ``encode → pack_container``):

* **host** (production today): pull the padded int16 RLE pairs down the
  device→host link, then single-pass C++ histogram + pack
  (``native.rle_symbol_hist`` / ``huff_pack_pairs``).
* **device**: keep symbols in HBM, histogram via sort + bin-edge
  searchsorted, build the (tiny) canonical codebook on host, pack with
  ``ops.huffman.pack_symbols_device``, and pull only the packed bits
  (~8× smaller than the pairs).

The device numbers are deliberately *best-case*: the flat valid-symbol
stream is staged to the device untimed (in a real integration the forward
would still have to compact the padded pairs on device first), so if the
device path loses here it loses, full stop.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np

from lz4jpeg_tpu.bench.harness import trimmed_mean

SYMBOL_OFFSET = 2048  # |RLE counts| ≤ 128, |quantized coeffs| < 2047


def _device_hist(symbols):
    """Sort-based histogram over [-SYMBOL_OFFSET, SYMBOL_OFFSET): the
    scatter-add formulation serializes on this platform (ops/rle.py), a
    sort plus 2·4096 searchsorted lookups does not."""
    import jax.numpy as jnp

    s = jnp.sort(symbols)
    edges = jnp.arange(-SYMBOL_OFFSET, SYMBOL_OFFSET + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(s, edges)
    return idx[1:] - idx[:-1]


def run_entropy_ab(
    image_size: int = 1024,
    runs: int = 5,
    output: Optional[str] = None,
) -> Dict:
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import CHANNELS, JPEGPipeline, _valid_symbols
    from lz4jpeg_tpu.native import native_available, native_backend
    from lz4jpeg_tpu.ops.huffman import (
        build_canonical_codebook_from_counts,
        pack_symbols_device,
    )
    from lz4jpeg_tpu.utils.inputs import generate_noise_image
    from lz4jpeg_tpu.utils.profiling import time_device

    if not native_available():
        raise RuntimeError("entropy A/B needs the native backend built")
    native = native_backend()
    rng = np.random.default_rng(0)
    img = generate_noise_image(image_size, image_size, rng)
    pipe = JPEGPipeline(JPEGConfig())
    # This A/B deliberately measures the int32/int16 PAIR layout (the
    # decision artifact predates pack16 and stays comparable to it);
    # disable the u16 transfer layouts before the first trace.
    pipe._pack16 = pipe._sparse16 = False
    slim = pipe._forward_rle(jnp.asarray(img))
    jax.block_until_ready(slim)

    artifact: Dict = {
        "image_size": image_size,
        "platform": jax.devices()[0].platform,
        "runs": runs,
        "channels": {},
    }
    host_total = 0.0
    device_total = 0.0
    for c in CHANNELS:
        pairs_dev, lengths_dev = slim[c]

        # -- host path: d2h of the pairs, then C++ hist + codebook + pack.
        # jax caches the host copy on an array after its first device_get,
        # so each run must fetch a FRESH device array to time a real
        # transfer.
        pairs_h, lengths_h = jax.device_get((pairs_dev, lengths_dev))
        d2h_times: List[float] = []
        for _ in range(runs):
            fresh = jax.block_until_ready(
                (jax.device_put(pairs_h), jax.device_put(lengths_h))
            )
            t0 = time.perf_counter()
            jax.device_get(fresh)
            d2h_times.append(time.perf_counter() - t0)
        pairs_h = np.asarray(pairs_h, np.int32)
        lengths_h = np.asarray(lengths_h)
        host_times: List[float] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            counts, _ = native.rle_symbol_hist(
                pairs_h, lengths_h, SYMBOL_OFFSET, 2 * SYMBOL_OFFSET
            )
            (bins,) = np.nonzero(counts)
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - SYMBOL_OFFSET, counts[bins]
            )
            packed, nbits = native.huff_pack_pairs(
                pairs_h, lengths_h, codebook
            )
            host_times.append(time.perf_counter() - t0)

        # -- device path: symbols staged untimed (best case), then fenced
        #    hist, host codebook build, fenced pack, d2h of packed bits.
        symbols = _valid_symbols(pairs_h, lengths_h)
        sym_dev = jnp.asarray(symbols, jnp.int32)
        hist_times = time_device(_device_hist, sym_dev, runs=runs, warmup=1)
        pad_bits = -(-int(nbits) // 64) * 64
        pack_times = time_device(
            lambda s: pack_symbols_device(s, codebook, pad_bits),
            sym_dev,
            runs=runs,
            warmup=1,
        )
        packed_dev, nbits_dev = jax.jit(
            lambda s: pack_symbols_device(s, codebook, pad_bits)
        )(sym_dev)
        d2h_packed: List[float] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            packed_bytes = bytes(np.asarray(jax.device_get(packed_dev)))
            d2h_packed.append(time.perf_counter() - t0)
        assert int(nbits_dev) == int(nbits)
        assert packed_bytes[: (int(nbits) + 7) // 8] == packed[: (int(nbits) + 7) // 8]

        entry = {
            "symbols": int(symbols.size),
            "pairs_bytes_d2h": int(pairs_h.size * 2 + lengths_h.size * 4),
            "packed_bytes_d2h": len(packed_bytes),
            "host_d2h_pairs_s": trimmed_mean(d2h_times),
            "host_hist_codebook_pack_s": trimmed_mean(host_times),
            "device_hist_s": trimmed_mean(hist_times),
            "device_pack_s": trimmed_mean(pack_times),
            "device_d2h_packed_s": trimmed_mean(d2h_packed),
        }
        entry["host_path_s"] = (
            entry["host_d2h_pairs_s"] + entry["host_hist_codebook_pack_s"]
        )
        entry["device_path_s"] = (
            entry["device_hist_s"]
            + entry["device_pack_s"]
            + entry["device_d2h_packed_s"]
        )
        artifact["channels"][c] = entry
        host_total += entry["host_path_s"]
        device_total += entry["device_path_s"]
        print(
            f"{c:>3}: host {entry['host_path_s']*1e3:8.2f} ms "
            f"(d2h {entry['host_d2h_pairs_s']*1e3:.2f} + pack "
            f"{entry['host_hist_codebook_pack_s']*1e3:.2f})  |  device "
            f"{entry['device_path_s']*1e3:8.2f} ms "
            f"(hist {entry['device_hist_s']*1e3:.2f} + pack "
            f"{entry['device_pack_s']*1e3:.2f} + d2h "
            f"{entry['device_d2h_packed_s']*1e3:.2f})"
        )

    artifact["host_total_s"] = host_total
    artifact["device_total_s"] = device_total
    artifact["decision"] = (
        "device" if device_total < host_total else "host"
    )
    print(
        f"total: host {host_total*1e3:.2f} ms, device {device_total*1e3:.2f} "
        f"ms -> production entropy stage: {artifact['decision']}"
    )
    if output:
        with open(output, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {output}")
    return artifact
