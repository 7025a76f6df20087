"""Full experiment sweeps mirroring the reference harness (SURVEY.md §3.5).

* LZ4: text sizes {350, 500, 1k, 2k, 5k, 10k, 15k, 20k, 25k, 30k}
  (``Experiment/LZ4_sequential_experiment.c:60``), random passages of the
  seeded text corpus (``utils/inputs.py``), 10 runs each, trimmed mean +
  median → JSON shaped like
  ``Experiment/results/LZ4_seq.exe_execution_times.json``.
* JPEG: square noise images 2^0 … 2^11 per side
  (``Experiment/JPEG_sequential_experiment.c:7-8``), full encode→decode
  round trip per run.

Unlike the reference, which timed whole child processes (~48 ms launch
floor in every number), these time the library calls directly; the JSON
keeps the reference's field names (``text`` / ``image_size``,
``execution_times``, ``mean``, ``median``) plus derived throughput.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from lz4jpeg_tpu.bench.harness import BenchResult, run_timed
from lz4jpeg_tpu.utils.inputs import (
    extract_random_passage,
    generate_noise_image,
    generate_text_corpus,
)

CORPUS_BYTES = 120_000  # passages are drawn from a corpus of this size
LZ4_SIZES = [350, 500, 1000, 2000, 5000, 10000, 15000, 20000, 25000, 30000]
JPEG_SIZES = [2 ** i for i in range(12)]


def run_lz4_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    mode: str = "parity",
    output: Optional[str] = None,
    seed: int = 0,
) -> List[BenchResult]:
    from lz4jpeg_tpu.config import LZ4Config
    from lz4jpeg_tpu.models.lz4 import LZ4Codec

    corpus = generate_text_corpus(CORPUS_BYTES, seed=seed)
    rng = np.random.default_rng(seed)
    codec = LZ4Codec(LZ4Config(mode=mode))
    results = []
    for size in sizes or LZ4_SIZES:
        text = extract_random_passage(corpus, size, rng)

        def step():
            assert codec.decode(codec.encode(text)) == text

        r = run_timed(
            f"lz4_{mode}", step, scale=size, runs=runs,
            work=size / 1e6, work_unit="MB",
        )
        results.append(r)
        print(
            f"lz4 {mode} {size:>6} B: mean {r.mean_s*1e3:.2f} ms "
            f"({r.throughput:.2f} MB/s)"
        )
    if output:
        _write_reference_schema(output, results, "text")
    return results


def run_jpeg_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    precision: str = "fast",
    output: Optional[str] = None,
    seed: int = 0,
) -> List[BenchResult]:
    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline

    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(JPEGConfig(precision=precision, entropy="shared"))
    results = []
    for size in sizes or JPEG_SIZES:
        img = generate_noise_image(size, size, rng)

        def step():
            pipeline.decode(pipeline.encode(img))

        r = run_timed(
            f"jpeg_{precision}", step, scale=size, runs=runs,
            work=size * size / 1e6, work_unit="MPix",
        )
        results.append(r)
        print(
            f"jpeg {precision} {size:>5}²: mean {r.mean_s*1e3:.2f} ms "
            f"({r.throughput:.3f} MPix/s)"
        )
    if output:
        _write_reference_schema(output, results, "image_size")
    return results


def _write_reference_schema(
    path: str, results: List[BenchResult], scale_key: str
) -> None:
    """The reference's results-file shape
    (``Experiment/results/*.json``), one entry per scale."""
    payload = [
        {
            "name": r.name,
            scale_key: r.scale,
            "runs": len(r.times_s),
            "mean_method": "trimmed (drop min+max)",
            "execution_times": r.times_s,
            "mean": r.mean_s,
            "median": r.median_s,
            "throughput": r.throughput,
            "throughput_unit": r.throughput_unit,
        }
        for r in results
    ]
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def run_lz4_file_experiment(
    size_mb: int = 256,
    runs: int = 10,
    output: Optional[str] = None,
) -> dict:
    """File-level streaming encode+decode throughput at ≥256 MB
    (``encode_file``/``decode_file``, chunk-granular native calls).

    Host-bound by design (the C++ codec): the number says what the
    streaming layer itself sustains on the host.
    """
    import json as _json
    import os
    import tempfile
    import time as _time

    from lz4jpeg_tpu.config import LZ4Config
    from lz4jpeg_tpu.models.lz4 import LZ4Codec

    data = generate_text_corpus(size_mb << 20, seed=0)
    codec = LZ4Codec(LZ4Config(mode="fast"))
    d = tempfile.mkdtemp(prefix="lz4file_")
    src = os.path.join(d, "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    comp = os.path.join(d, "out.lz4t")
    dec = os.path.join(d, "dec.bin")
    enc_times, dec_times = [], []
    for _ in range(runs):
        t0 = _time.perf_counter()
        comp_size = codec.encode_file(src, comp)
        enc_times.append(_time.perf_counter() - t0)
        t0 = _time.perf_counter()
        raw = codec.decode_file(comp, dec)
        dec_times.append(_time.perf_counter() - t0)
        assert raw == len(data)
    with open(dec, "rb") as f:
        assert f.read(1 << 20) == data[: 1 << 20]
    mb = len(data) / 1e6
    result = {
        "size_mb": size_mb,
        "compressed_bytes": comp_size,
        "ratio": comp_size / len(data),
        "encode_times_s": enc_times,
        "decode_times_s": dec_times,
        "encode_mb_s": mb / min(enc_times),
        "decode_mb_s": mb / min(dec_times),
        "engine": "native (chunk-granular lz4t_encode_chunk/decode_chunk)",
    }
    print(
        f"lz4 file streaming {size_mb} MB: encode {result['encode_mb_s']:.1f} "
        f"MB/s, decode {result['decode_mb_s']:.1f} MB/s, ratio "
        f"{result['ratio']:.3f}"
    )
    for p in (src, comp, dec):
        os.unlink(p)
    if output:
        with open(output, "w") as f:
            _json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def run_jpeg_perblock_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    output: Optional[str] = None,
    seed: int = 0,
) -> List[BenchResult]:
    """Parity-mode (exact f64 + per-block Huffman) roundtrip at experiment
    scale — the reference's actual configuration, which rebuilds a Huffman
    tree for every MCU and channel (JPEG.c:844-1097, driven at
    :1242-1253).  Requires x64 (run via ``bench jpeg-perblock``, which
    enables it before JAX initializes arrays).

    The entropy stage runs the native C++ oracle twin
    (``lz4core.cpp::huff_per_block_ascii``); the interpreted Python heap
    cannot realistically reach 512²+ (~49 k trees per channel at 2048²).
    """
    import time as _time

    import jax

    jax.config.update("jax_enable_x64", True)

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline

    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(
        JPEGConfig(precision="exact", entropy="per_block")
    )
    results = []
    for size in sizes or [64, 128, 256, 512, 1024, 2048]:
        img = generate_noise_image(size, size, rng)
        entropy_s = {"t": 0.0}

        def step():
            enc = pipeline.encode(img, entropy=False)
            t0 = _time.perf_counter()
            pipeline.entropy_encode(enc)
            entropy_s["t"] = _time.perf_counter() - t0
            rec = pipeline.decode(enc)
            assert rec.shape == img.shape

        r = run_timed(
            "jpeg_perblock", step, scale=size, runs=runs, warmup=1,
            work=size * size / 1e6, work_unit="MPix",
        )
        results.append(r)
        print(
            f"jpeg per_block {size:>5}²: mean {r.mean_s*1e3:9.2f} ms "
            f"({r.throughput:.3f} MPix/s; entropy stage "
            f"{entropy_s['t']*1e3:.1f} ms)"
        )
    if output:
        _write_reference_schema(output, results, "image_size")
    return results


def run_lz4t_decode_device_experiment(
    sizes_mb: Optional[List[int]] = None,
    runs: int = 10,
    output: Optional[str] = None,
) -> List[BenchResult]:
    """Device-parallel LZ4T decode throughput: the host builds the fully
    rooted copy program, the device resolves it with one gather
    (``ops/lz4t_decode.py``).  Reports the device resolve (program already
    on the device), the host program build, and the native C++ host
    decode as the reference point.
    """
    import json as _json
    import time as _time

    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.formats.fast_frame import encode_fast
    from lz4jpeg_tpu.native import native_available, native_backend
    from lz4jpeg_tpu.ops.lz4t_decode import (
        build_copy_program_fast,
        resolve_blocks,
    )

    results = []
    artifact = {"entries": []}
    for mb in sizes_mb or [1, 4, 16, 64]:
        data = generate_text_corpus(mb << 20, seed=0)
        frame = encode_fast(data)
        t0 = _time.perf_counter()
        lit, src, _, _, _ = build_copy_program_fast(frame)
        program_s = _time.perf_counter() - t0
        litj, srcj = jnp.asarray(lit), jnp.asarray(src)

        def step():
            jax.block_until_ready(resolve_blocks(litj, srcj))

        r = run_timed(
            "lz4t_decode_device", step, scale=mb, runs=runs, warmup=1,
            work=len(data) / 1e6, work_unit="MB",
        )
        results.append(r)
        entry = {
            "mb": mb,
            "host_program_s": program_s,
            "device_resolve_mean_s": r.mean_s,
            "device_resolve_mb_s": r.throughput,
        }
        if native_available():
            t0 = _time.perf_counter()
            native_backend().decode_fast(frame, len(data))
            entry["host_native_decode_mb_s"] = (
                len(data) / 1e6 / (_time.perf_counter() - t0)
            )
        artifact["entries"].append(entry)
        print(
            f"lz4t device decode {mb:3d} MB: resolve {r.mean_s*1e3:8.2f} ms "
            f"({r.throughput:8.1f} MB/s), program {program_s*1e3:7.1f} ms"
        )
    if output:
        with open(output, "w") as f_:
            _json.dump(artifact, f_, indent=1)
        print(f"wrote {output}")
    return results


def run_jpeg_inverse_device_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    seed: int = 0,
    output: Optional[str] = None,
) -> List[BenchResult]:
    """Batched device-side JPEG decode throughput: device-resident packed16
    RLE pairs → RLE expansion → fused IDCT chain → YCbCr→RGB reassembly.

    The decode-side twin of ``bench.py``'s forward headline: per-size
    batches of up to 1 GiPix per dispatch, capped at 256 frames.
    """
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline

    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    results = []
    for size in sizes or [512, 1024, 2048]:
        batch = min(256, max(1, (1024 << 20) // (size * size)))
        img = generate_noise_image(size, size, rng)
        slim = jax.block_until_ready(pipeline._forward_rle(jnp.asarray(img)))
        bpc = bpr = size // 8
        assert pipeline._sparse16, (
            "device inverse sweep measures the production sparse16 chain"
        )
        comb = jnp.tile(slim, (batch, 1, 1))

        f = jax.jit(jax.vmap(
            lambda cc: pipeline._inverse_sparse_impl(
                cc, bpc=bpc, bpr=bpr, height=size, width=size
            )
        ))

        def step():
            jax.block_until_ready(f(comb))

        r = run_timed(
            f"jpeg_inverse_device_{size}", step, scale=size, runs=runs,
            warmup=2, work=batch * size * size / 1e6, work_unit="MPix",
        )
        results.append(r)
        print(
            f"jpeg device inverse {size:>5}² b{batch}: mean "
            f"{r.mean_s*1e3:8.1f} ms ({r.throughput:7.1f} MPix/s)"
        )
    if output:
        _write_reference_schema(output, results, "image_size")
    return results


def run_lz4_device_experiment(
    batches: Optional[List[int]] = None,
    runs: int = 10,
    seed: int = 0,
    output: Optional[str] = None,
    lcp_words_list: Optional[List[int]] = None,
) -> List[BenchResult]:
    """Device-resident LZ4 match+parse throughput (data already on the
    device, parse fields staying there), one series per carried-suffix
    width (``LZ4Config.match_lcp_words``)."""
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.ops.lz4_fast import fast_match_blocks

    p = 16384
    nb_max = max(batches or [64, 256, 1024, 4096, 8192])
    corpus = np.frombuffer(
        generate_text_corpus(nb_max * p, seed=seed), np.uint8
    )
    results = []
    for lcp in lcp_words_list or [4, 2]:
        fn = jax.jit(
            lambda b, l, lcp=lcp: fast_match_blocks(b, l, lcp_words=lcp)
        )
        for nblocks in batches or [64, 256, 1024, 4096, 8192]:
            blocks = jnp.asarray(corpus[: nblocks * p].reshape(nblocks, p))
            lengths = jnp.full((nblocks,), p, jnp.int32)

            def step():
                jax.block_until_ready(fn(blocks, lengths))

            mb = nblocks * p / 1e6
            r = run_timed(
                f"lz4_device_match_lcp{lcp}", step, scale=nblocks,
                runs=runs, work=mb, work_unit="MB",
            )
            results.append(r)
            print(
                f"lz4_device_match_lcp{lcp} {mb:7.1f} MB/batch: mean "
                f"{r.mean_s*1e3:8.2f} ms ({r.throughput:7.1f} MB/s)"
            )
    if output:
        _write_reference_schema(output, results, "batch_blocks")
    return results
