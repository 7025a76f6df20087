"""Smoke test of the codec's main paths on an NVIDIA GPU.

    python chip_smoke.py [--seed N]        # one GPU, every phase
    python chip_smoke.py --devices 4       # four GPUs, the sharded paths only

Each phase drives a path through the entry points a user calls, at the
sizes users run, checks the result by the repository's own references,
and prints one JSON line with its wall times after warm-up.  Inputs are
generated from ``--seed``; nothing is read from outside the checkout.

Phases on one GPU:

* ``device``     — the first device is a GPU; prints its kind and count
  and ``nvidia-smi``'s name and power limit;
* ``jpeg_photo`` — a 4032×3024 photo-like frame through ``JPEGPipeline``
  (the overlapped encode), the TJPG container and back; compared with
  the same forward on the CPU, the float64 oracle on a 1024² crop, and
  a decode of the device output that skips the entropy stage;
* ``jpeg_batch`` — 64 noise frames of 2048² through the batched forward
  and inverse; the forward kernel against the XLA chain on the GPU, all
  frames against the CPU, and one frame's inverse against the CPU;
* ``lz4t``       — 64 MiB of seeded text through ``LZ4Codec`` with the
  device engine, decoded on the device and by the native C++ decoder;
* ``lz4_parity`` — a 30 kB passage through the parity codec (batched
  device parse) and the device decode, against the reference oracle.

Coefficient bound: quantized coefficients of the GPU forward differ from
the CPU run of the same program by at most 1, on at most 1e-5 of them
(float32 products summed in another order can cross a truncation
boundary).  The last line of output is the JSON result; any failed check
raises, and the script exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

COEFF_MAX_DIFF = 1
COEFF_MAX_SHARE = 1e-5
# Inverse DCT rounding: a ±1 plane flip at a round-half boundary becomes
# up to ±3 after the colour merge (ops/fused.py::fused_inverse_plane_jnp).
PIXEL_MAX_DIFF = 3
PIXEL_MAX_SHARE = 1e-3
ORACLE_MAX_DIFF = 2  # fast (float32) path vs the float64 oracle


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, runs: int = 3):
    """One untimed warm-up call, then ``runs`` timed calls; returns the
    last result and the timed seconds."""
    out = fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times


def ready(fn):
    import jax

    return lambda: jax.block_until_ready(fn())


def coefficients(combined: np.ndarray) -> np.ndarray:
    """(..., 128) combined sparse16 stream → (..., 128) int32 quantized
    zigzag coefficients (each channel's prefix sum of deltas)."""
    from lz4jpeg_tpu.ops.rle import CHANNEL_SLICES, SPARSE16_DELTA_BIAS

    w = np.asarray(combined).astype(np.int32)
    d = np.where(w != 0, w - SPARSE16_DELTA_BIAS, 0)
    return np.concatenate(
        [np.cumsum(d[..., sl], axis=-1) for sl in CHANNEL_SLICES.values()],
        axis=-1,
    )


def coeff_diff(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(coefficients(a) - coefficients(b))
    return {
        "coefficients": int(diff.size),
        "differ": int(np.count_nonzero(diff)),
        "max_abs": int(diff.max(initial=0)),
    }


def check_coeffs(d: dict, what: str) -> None:
    check(
        d["max_abs"] <= COEFF_MAX_DIFF
        and d["differ"] <= COEFF_MAX_SHARE * d["coefficients"],
        f"{what}: coefficients outside the bound: {d}",
    )


def pixel_diff(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {
        "pixels": int(diff.size),
        "differ": int(np.count_nonzero(diff)),
        "max_abs": int(diff.max(initial=0)),
    }


def phase_device(count: int) -> dict:
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform!r}")
    check(len(devices) >= count, f"{count} GPUs needed, {len(devices)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    check(bool(smi), "nvidia-smi printed no card")
    print(smi, flush=True)

    from lz4jpeg_tpu.native import native_available
    from lz4jpeg_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    check(native_available(), "native C++ library did not build")
    log(
        "device", kind=dev.device_kind, count=len(devices),
        nvidia_smi=smi.splitlines(), jax=jax.__version__, compile_cache=cache,
    )
    return {"platform": dev.platform, "kind": dev.device_kind, "count": count}


def phase_jpeg_photo(
    seed: int, shape=(3024, 4032), crop: int = 1024
) -> None:
    import jax

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.oracle.jpeg_oracle import jpeg_roundtrip_oracle
    from lz4jpeg_tpu.utils.inputs import generate_photo_image

    img = generate_photo_image(*shape, np.random.default_rng(seed))
    pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    enc, t_enc = timed(lambda: pipe.encode(img))
    blob, t_pack = timed(lambda: pack_container(enc))
    rec, t_dec = timed(lambda: pipe.decode(unpack_container(blob)))

    # Forward kernel vs the XLA chain, both on the GPU, and vs the CPU.
    x = jax.device_put(img)
    kernel = jax.jit(pipe._forward_rle_impl)
    xla = jax.jit(pipe._forward_sparse16_xla)
    k_out, t_kernel = timed(ready(lambda: kernel(x)), runs=10)
    x_out, t_xla = timed(ready(lambda: xla(x)), runs=10)
    cpu_out = kernel(jax.device_put(img, jax.devices("cpu")[0]))
    vs_xla = coeff_diff(np.asarray(k_out), np.asarray(x_out))
    vs_cpu = coeff_diff(enc.rle_combined, np.asarray(cpu_out))
    check_coeffs(vs_xla, "photo: kernel vs XLA chain on the GPU")
    check_coeffs(vs_cpu, "photo: GPU vs CPU forward")

    # Entropy stage is lossless: the container decodes to the device
    # output, and decoding that output directly gives the same pixels.
    unpacked = unpack_container(blob)
    direct = pipe.decode(enc, from_entropy=False)
    check(rec.shape == img.shape, f"decoded shape {rec.shape}")
    check(np.array_equal(direct, rec), "container decode != direct decode")
    pipe.entropy_decode(unpacked)
    check(
        np.array_equal(unpacked.rle_combined, enc.rle_combined),
        "container streams != device streams",
    )

    ref, _ = jpeg_roundtrip_oracle(img[:crop, :crop], snap_ties=True)
    vs_oracle = pixel_diff(rec[:crop, :crop], ref)
    check(
        vs_oracle["max_abs"] <= ORACLE_MAX_DIFF,
        f"photo crop vs float64 oracle: {vs_oracle}",
    )
    log(
        "jpeg_photo", shape=list(img.shape), container_bytes=len(blob),
        encode_s=t_enc, pack_s=t_pack, decode_s=t_dec,
        forward_kernel_s=t_kernel, forward_xla_s=t_xla,
        kernel_vs_xla=vs_xla, gpu_vs_cpu=vs_cpu, crop_vs_oracle=vs_oracle,
    )


def phase_jpeg_batch(seed: int, frames: int = 64, size: int = 2048) -> None:
    import jax

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline

    rng = np.random.default_rng(seed + 1)
    imgs = rng.integers(0, 256, size=(frames, size, size, 3), dtype=np.uint8)
    pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    bpc = bpr = size // 8
    x = jax.device_put(imgs)
    forward = jax.jit(jax.vmap(pipe._forward_rle_impl))
    xla = jax.jit(jax.vmap(pipe._forward_sparse16_xla))
    comb, t_fwd = timed(ready(lambda: forward(x)), runs=5)
    x_out, t_xla = timed(ready(lambda: xla(x)), runs=5)
    inv = lambda: pipe._batch_inverse_sparse(comb, bpc, bpr, size, size)
    rgb, t_inv = timed(ready(inv), runs=5)
    check(rgb.shape == imgs.shape, f"inverse shape {rgb.shape}")

    gpu = np.asarray(comb)
    vs_xla = coeff_diff(gpu, np.asarray(x_out))
    check_coeffs(vs_xla, "batch: kernel vs XLA chain on the GPU")
    del x_out
    cpu = jax.devices("cpu")[0]
    cpu_forward = jax.jit(jax.vmap(pipe._forward_rle_impl))
    totals = {"coefficients": 0, "differ": 0, "max_abs": 0}
    for a in range(0, frames, 8):
        d = coeff_diff(
            gpu[a : a + 8],
            np.asarray(cpu_forward(jax.device_put(imgs[a : a + 8], cpu))),
        )
        totals = {
            "coefficients": totals["coefficients"] + d["coefficients"],
            "differ": totals["differ"] + d["differ"],
            "max_abs": max(totals["max_abs"], d["max_abs"]),
        }
    check_coeffs(totals, "batch: GPU vs CPU forward")
    cpu_rgb = pipe._inverse_sparse(
        jax.device_put(gpu[0], cpu),
        bpc=bpc, bpr=bpr, height=size, width=size,
    )
    inv_diff = pixel_diff(np.asarray(rgb[0]), np.asarray(cpu_rgb))
    check(
        inv_diff["max_abs"] <= PIXEL_MAX_DIFF
        and inv_diff["differ"] <= PIXEL_MAX_SHARE * inv_diff["pixels"],
        f"batch: GPU vs CPU inverse of frame 0: {inv_diff}",
    )
    mpix = frames * size * size / 1e6
    log(
        "jpeg_batch", frames=frames, size=size, forward_s=t_fwd,
        forward_xla_s=t_xla, inverse_s=t_inv,
        forward_mpix_s=mpix / min(t_fwd), forward_xla_mpix_s=mpix / min(t_xla),
        inverse_mpix_s=mpix / min(t_inv), kernel_vs_xla=vs_xla,
        gpu_vs_cpu=totals, inverse_frame0_vs_cpu=inv_diff,
    )


def phase_lz4t(seed: int, size: int = 64 << 20) -> None:
    from lz4jpeg_tpu.config import LZ4Config
    from lz4jpeg_tpu.models.lz4 import LZ4Codec
    from lz4jpeg_tpu.native import native_backend
    from lz4jpeg_tpu.utils.inputs import generate_text_corpus

    data = generate_text_corpus(size, seed=seed)
    codec = LZ4Codec(LZ4Config(mode="fast"))
    frame, t_enc = timed(lambda: codec.encode(data, engine="device"), runs=2)
    out, t_dec = timed(lambda: codec.decode(frame, engine="device"), runs=2)
    check(out == data, "device decode of the device frame is not byte-exact")
    native = native_backend()
    check(
        native.decode_fast(frame, len(data)) == data,
        "native decoder rejects the device frame",
    )
    native_frame, t_native = timed(
        lambda: codec.encode(data, engine="native"), runs=2
    )

    mb = len(data) / 1e6
    log(
        "lz4t", bytes=len(data), device_frame_bytes=len(frame),
        native_frame_bytes=len(native_frame), device_encode_s=t_enc,
        device_decode_s=t_dec, native_encode_s=t_native,
        device_encode_mb_s=mb / min(t_enc),
        native_encode_mb_s=mb / min(t_native),
        device_decode_mb_s=mb / min(t_dec),
    )


def phase_lz4_parity(seed: int, size: int = 30_000) -> None:
    from lz4jpeg_tpu.config import LZ4Config
    from lz4jpeg_tpu.models.lz4 import LZ4Codec
    from lz4jpeg_tpu.oracle.lz4_oracle import lz4_encode_oracle
    from lz4jpeg_tpu.utils.inputs import (
        extract_random_passage,
        generate_text_corpus,
    )

    passage = extract_random_passage(
        generate_text_corpus(120_000, seed=seed), size,
        np.random.default_rng(seed),
    )
    codec = LZ4Codec(LZ4Config(mode="parity"))
    frame, t_enc = timed(lambda: codec.encode(passage))
    out, t_dec = timed(lambda: codec.decode(frame, engine="device"))
    check(out == passage, "parity device decode is not byte-exact")
    check(frame == lz4_encode_oracle(passage), "parity frame != oracle frame")
    log(
        "lz4_parity", bytes=len(passage), frame_bytes=len(frame),
        encode_s=t_enc, device_decode_s=t_dec,
    )


def phase_sharded(
    seed: int, devices: int, shape=(3024, 4032), text_bytes: int = 64 << 20
) -> None:
    """The sharded JPEG and LZ4T paths over ``devices`` GPUs, each equal
    to the single-device result."""
    import jax

    from lz4jpeg_tpu.config import JPEGConfig, LZ4Config, MeshConfig
    from lz4jpeg_tpu.formats.fast_frame import encode_fast
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.models.lz4 import LZ4Codec
    from lz4jpeg_tpu.ops.lz4_fast import fast_match_blocks, pad_blocks_fast
    from lz4jpeg_tpu.parallel.jpeg import ShardedSparseJPEG
    from lz4jpeg_tpu.parallel.lz4 import (
        sharded_fast_decode,
        sharded_fast_parse,
    )
    from lz4jpeg_tpu.parallel.mesh import codec_mesh
    from lz4jpeg_tpu.utils.inputs import (
        generate_photo_image,
        generate_text_corpus,
    )

    mesh = codec_mesh(MeshConfig(num_devices=devices))
    img = generate_photo_image(*shape, np.random.default_rng(seed))
    ssj = ShardedSparseJPEG(mesh)
    pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    enc = pipe.encode(img, entropy=False)
    single_rgb = pipe.decode(enc, from_entropy=False)
    comb, t_fwd = timed(lambda: ssj.forward(img))
    check(np.array_equal(comb, enc.rle_combined), "sharded forward != single")
    bpc, bpr = enc.blocks_per_col, enc.blocks_per_row
    rgb, t_inv = timed(lambda: ssj.inverse(comb, bpc, bpr, *img.shape[:2]))
    check(np.array_equal(rgb, single_rgb), "sharded inverse != single decode")

    data = generate_text_corpus(text_bytes, seed=seed)
    blocks, lengths = pad_blocks_fast(data)
    blocks = blocks.astype(np.uint8)
    parse, t_parse = timed(lambda: sharded_fast_parse(blocks, lengths, mesh))
    single = jax.device_get(jax.jit(fast_match_blocks)(blocks, lengths))
    for name, a, b in zip(("is_match", "emit_len", "emit_dist"), parse, single):
        check(
            np.array_equal(np.asarray(a, np.int32), b),
            f"sharded {name} != single",
        )
    frame = encode_fast(data)
    out, t_dec = timed(lambda: sharded_fast_decode(frame, mesh))
    check(out == data, "sharded decode is not byte-exact")
    check(
        out == LZ4Codec(LZ4Config(mode="fast")).decode(frame, engine="device"),
        "sharded decode != single-device decode",
    )
    log(
        "sharded", devices=devices, jpeg_forward_s=t_fwd,
        jpeg_inverse_s=t_inv, lz4_parse_s=t_parse, lz4t_decode_s=t_dec,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--devices", type=int, default=1, choices=[1, 4],
        help="4: run only the sharded paths, over four GPUs",
    )
    args = ap.parse_args(argv)
    # Outside a checkout this fails before anything is printed.
    import lz4jpeg_tpu  # noqa: F401

    device = phase_device(args.devices)
    if args.devices == 1:
        phase_jpeg_photo(args.seed)
        phase_jpeg_batch(args.seed)
        phase_lz4t(args.seed)
        phase_lz4_parity(args.seed)
    else:
        phase_sharded(args.seed, args.devices)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
