"""Per-stage roofline breakdown of the JPEG forward and inverse chains.

Answers "which stage limits the throughput and how far is it from speed
of light" — the framework's analogue of the reference's per-size timing
tables (``Experiment/results/*.json``).

Methodology
-----------
Each stage is chained CHAIN times inside one jit via ``lax.fori_loop``
with a data-dependent carry so executions serialize and cannot be CSE'd,
then waited on once; the per-iteration time amortizes dispatch.  Per
stage we state the *algorithmic* FLOPs and device-memory bytes (inputs
read once + outputs written once; internal passes XLA adds only lower the
achieved fraction) and compare against the device's published peaks,
``DEVICE_PEAKS[device_kind]``:

``speed_of_light_s = max(bytes/BW_peak, flops/FLOP_peak)`` and
``sol_fraction = speed_of_light_s / measured_s``.  The DCT products run
at ``Precision.HIGHEST`` (IEEE fp32), so FLOPs count against the fp32
rate outside the tensor cores.

The readback stage (device→host of the combined stream) is timed
separately — it is a real serving cost, not part of the device chain.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np

LANES_FOR_STREAM = 512  # wide rows so the stream probe trivially saturates

# Published peaks by ``jax.devices()[0].device_kind``: NVIDIA H200 SXM data
# sheet, dense rates without sparsity, at the 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H200": {
        "hbm_gbs": 4800.0,
        "fp32_tflops": 67.0,  # outside the tensor cores
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
    },
}


def device_peaks(kind: Optional[str] = None) -> Dict[str, float]:
    """Peaks of ``kind`` (default: the first device's ``device_kind``);
    a device missing from ``DEVICE_PEAKS`` is an error, not a default."""
    import jax

    kind = kind or jax.devices()[0].device_kind
    if kind not in DEVICE_PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add them to "
            "DEVICE_PEAKS with their source"
        )
    return DEVICE_PEAKS[kind]


def _make_chained(body, chain: int):
    import jax
    import jax.numpy as jnp

    def chained(x, c0):
        def step(_, carry):
            c, s = carry
            return body(x, c, s)

        _, s = jax.lax.fori_loop(0, chain, step, (c0, jnp.float32(0)))
        return s

    return jax.jit(chained)


def _chain_bench(body, data, chain: int, runs: int = 4) -> float:
    """Best per-iteration seconds of ``body(x, carry, acc) -> (carry', acc')``
    chained ``chain`` times in one dispatch."""
    import jax
    import jax.numpy as jnp

    f = _make_chained(body, chain)
    jax.block_until_ready(f(data, jnp.int16(0)))  # compile + warm
    best = 1e9
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(f(data, jnp.int16(0)))
        best = min(best, time.perf_counter() - t0)
    return best / chain


def measure_hbm_stream_ceiling(
    footprint_bytes: int = 512 << 20,
    chain: int = 32,
    runs: int = 4,
) -> Dict:
    """Measured achievable device-memory bandwidth at the production
    footprint.

    The published peak is not what a real kernel sustains through XLA;
    every roofline reports ``sol_fraction`` against both.  This probe
    times bare streaming loops — the cheapest possible kernels —
    fully fenced with the array itself as the ``fori_loop`` carry so every
    iteration must materialize its output to HBM:

    * ``stream_f32``: c' = c·a + b            — read N + write N per iter
    * ``triad_f32``:  c' = c + x·(1 + i)      — read 2N + write N
    * ``stream_u8``:  c' = c + 1 (int8)       — read N + write N

    The reported ceiling is the max achieved GB/s across variants; a value
    above the paper peak would prove the fence collapsed (asserted).
    """
    import jax
    import jax.numpy as jnp

    n_f32 = footprint_bytes // 4
    rows = n_f32 // LANES_FOR_STREAM
    rng = np.random.default_rng(7)
    x32 = jnp.asarray(
        rng.standard_normal((rows, LANES_FOR_STREAM)).astype(np.float32)
    )
    x8 = jnp.asarray(
        rng.integers(-100, 100, size=(4 * rows, LANES_FOR_STREAM)).astype(
            np.int8
        )
    )

    def bench(step, x0, aux, nbytes_per_iter):
        # aux rides as a jit ARGUMENT — a closure capture would inline a
        # footprint-sized constant into the HLO.
        def chained(c0, a):
            c = jax.lax.fori_loop(0, chain, lambda i, c: step(i, c, a), c0)
            return jnp.sum(c.astype(jnp.float32))

        f = jax.jit(chained)
        jax.block_until_ready(f(x0, aux))  # compile + warm
        best = 1e9
        for _ in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x0, aux))
            best = min(best, time.perf_counter() - t0)
        per_iter = best / chain
        return {
            "measured_s": per_iter,
            "bytes": nbytes_per_iter,
            "achieved_gbs": nbytes_per_iter / per_iter / 1e9,
        }

    zero = jnp.zeros((1, 1), jnp.float32)
    out = {
        "footprint_bytes": footprint_bytes,
        "chain": chain,
        "variants": {},
    }
    out["variants"]["stream_f32"] = bench(
        lambda i, c, a: c * jnp.float32(1.000001) + jnp.float32(0.5),
        x32,
        zero,
        2 * footprint_bytes,
    )
    out["variants"]["triad_f32"] = bench(
        lambda i, c, a: c + a * (jnp.float32(1.0) + i.astype(jnp.float32)),
        x32,
        x32,
        3 * footprint_bytes,
    )
    out["variants"]["stream_u8"] = bench(
        lambda i, c, a: c + jnp.int8(1), x8, zero, 2 * footprint_bytes
    )
    ceiling = max(v["achieved_gbs"] for v in out["variants"].values())
    peak = device_peaks()["hbm_gbs"]
    assert ceiling <= peak * 1.05, (
        f"stream probe reports {ceiling:.0f} GB/s > published peak "
        f"{peak} — the loop no longer forces its stores; fix the probe"
    )
    out["ceiling_gbs"] = ceiling
    return out


def _roofline_arith(stages: Dict[str, Dict], hbm_measured_gbs: float) -> Dict:
    """Fill each stage's achieved rates, speed of light and bound against
    the device's published peaks (and the measured stream ceiling)."""
    peaks = device_peaks()
    bw, fl = peaks["hbm_gbs"] * 1e9, peaks["fp32_tflops"] * 1e12
    for st in stages.values():
        t = st["measured_s"]
        st["achieved_gbs"] = st["bytes"] / t / 1e9
        st["achieved_tflops"] = st["flops"] / t / 1e12
        if not st.get("device", True):
            st["speed_of_light_s"] = st["sol_fraction"] = None
            continue
        sol = max(st["bytes"] / bw, st["flops"] / fl)
        st["speed_of_light_s"] = sol
        st["sol_fraction"] = sol / t
        st["sol_fraction_measured"] = max(
            st["bytes"] / (hbm_measured_gbs * 1e9), st["flops"] / fl
        ) / t
        memory_bound = st["bytes"] / bw >= st["flops"] / fl
        st["bound"] = "memory" if memory_bound else "compute"
    return peaks


def _print_table(stages: Dict[str, Dict], names) -> None:
    print(f"{'stage':18s} {'ms':>8s} {'GB/s':>7s} {'TFLOP/s':>8s} "
          f"{'SoL%':>6s} {'mSoL%':>6s}  bound")
    for name in names:
        st = stages[name]
        sol = st.get("sol_fraction")
        msol = st.get("sol_fraction_measured")
        print(
            f"{name:18s} {st['measured_s']*1e3:8.2f} {st['achieved_gbs']:7.1f} "
            f"{st['achieved_tflops']:8.2f} "
            f"{(f'{sol*100:5.1f}%') if sol else '     -'} "
            f"{(f'{msol*100:5.1f}%') if msol else '     -'}  "
            f"{st.get('bound', '-')}"
        )


def run_jpeg_forward_roofline(
    size: int = 2048,
    batch: int = 32,
    chain: int = 8,
    output: Optional[str] = None,
) -> Dict:
    """Fenced roofline of the production sparse16 forward
    (``JPEGPipeline._forward_rle_impl`` — on a CUDA device the fused
    Pallas kernel, ``ops/pallas_fwd.py``) beside the XLA chain it is
    tested against (``_forward_sparse16_xla``), plus the device→host
    readback of the combined stream.
    """
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.utils.inputs import generate_noise_image

    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    assert pipeline._sparse16, "forward roofline measures the sparse16 path"
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(
        np.stack([generate_noise_image(size, size, rng) for _ in range(batch)])
    )
    npix = batch * size * size  # pixels per chain iteration
    # Color (~10/px) + the basis matmuls: 64 luma coefficients per 64
    # pixels contracting 64, 2 × 32 chroma coefficients contracting 32.
    flops = 10 * npix + 2 * 64 * npix + 2 * 2 * 16 * npix
    io_bytes = 3 * npix + 4 * npix  # RGB u8 in, combined u16 out

    def body_of(fwd):
        def body(x, c, s):
            out = fwd(x + c.astype(jnp.uint8))
            s = s + jnp.sum(out.astype(jnp.float32))
            return (s.astype(jnp.int32) % 2).astype(jnp.int16), s

        return body

    stages: Dict[str, Dict] = {}
    for name, fn in (
        ("full_forward", pipeline._forward_rle_impl),
        ("xla_chain", pipeline._forward_sparse16_xla),
    ):
        print(f"timing {name} ...", flush=True)
        stages[name] = {
            "measured_s": _chain_bench(body_of(jax.vmap(fn)), imgs, chain),
            "flops": flops,
            "bytes": io_bytes,
        }

    slim = jax.block_until_ready(
        jax.jit(jax.vmap(pipeline._forward_rle_impl))(imgs)
    )
    t0 = time.perf_counter()
    jax.device_get(slim)
    stages["readback_d2h"] = {
        "measured_s": time.perf_counter() - t0,
        "flops": 0,
        "bytes": int(np.prod(slim.shape)) * 2,
        "device": False,
    }

    def floor_body(x, c, s):
        (xp,) = jax.lax.optimization_barrier((x + c.astype(jnp.uint8),))
        s = s + jnp.sum(xp.astype(jnp.float32))
        return (s.astype(jnp.int32) % 2).astype(jnp.int16), s

    print("timing fence_floor ...", flush=True)
    floor_s = _chain_bench(floor_body, imgs, chain)
    print("timing hbm_stream ceiling ...", flush=True)
    hbm_probe = measure_hbm_stream_ceiling(
        footprint_bytes=min(512 << 20, 4 * npix), chain=16
    )
    peaks = _roofline_arith(stages, hbm_probe["ceiling_gbs"])
    result = {
        "size": size,
        "batch": batch,
        "chain": chain,
        "device_kind": jax.devices()[0].device_kind,
        "peaks": peaks,
        "hbm_stream_ceiling": hbm_probe,
        "mpix_per_iter": npix / 1e6,
        "fence_floor": {
            "measured_s": floor_s,
            "note": "per-iteration input perturb + checksum, embedded in "
            "every stage's measured_s",
        },
        "stages": stages,
        "vs_xla_chain": stages["xla_chain"]["measured_s"]
        / stages["full_forward"]["measured_s"],
        "full_forward_mpix_s": npix / 1e6 / stages["full_forward"]["measured_s"],
    }
    print(f"\nJPEG forward roofline — {size}² × batch {batch} "
          f"({npix/1e6:.0f} MPix/iter) on {result['device_kind']}")
    print(f"measured stream ceiling: {hbm_probe['ceiling_gbs']:.0f} GB/s "
          f"(published {peaks['hbm_gbs']:.0f})")
    _print_table(stages, ("full_forward", "xla_chain", "readback_d2h"))
    print(f"{result['vs_xla_chain']:.2f}x the XLA chain; forward "
          f"{result['full_forward_mpix_s']:.0f} MPix/s")
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def run_jpeg_inverse_roofline(
    size: int = 2048,
    batch: int = 64,
    chain: int = 8,
    output: Optional[str] = None,
) -> Dict:
    """Per-stage fenced roofline of the device decode chain: combined
    sparse buffer → per-channel delta extraction + kt transpose → FOLDED
    suffix-basis einsum (the RLE expansion rides the same matmul,
    ``ops/fused.py::inverse_suffix_basis``) → plane YCbCr merge.

    Every stage is data-oblivious, so the chain carry XOR-perturbs the
    combined words — iterations cannot be CSE'd and the streams stay
    shape-valid.  Byte counts follow the read-once/write-once convention.
    """
    import jax
    import jax.numpy as jnp

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import (
        CHANNELS,
        _CHANNEL_SHAPES,
        JPEGPipeline,
    )
    from lz4jpeg_tpu.ops.color import ycbcr_planes_to_rgb
    from lz4jpeg_tpu.ops.fused import fused_inverse_plane_sparse_jnp
    from lz4jpeg_tpu.ops.rle import CHANNEL_SLICES, SPARSE16_DELTA_BIAS
    from lz4jpeg_tpu.utils.inputs import generate_noise_image

    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    assert pipeline._sparse16, "inverse roofline measures the sparse16 path"
    rng = np.random.default_rng(0)
    img = generate_noise_image(size, size, rng)
    slim = jax.block_until_ready(pipeline._forward_rle(jnp.asarray(img)))
    # One batch axis of real encoded streams (tiled — decode work is
    # content-oblivious, so tiling does not change it).
    comb = jnp.tile(slim[None], (batch, 1, 1))  # (B, N, 128) u16
    bpc = bpr = size // 8
    npix = batch * size * size
    slices = CHANNEL_SLICES

    stages: Dict[str, Dict] = {}

    def unbias_all(cb):
        out = {}
        for name in CHANNELS:
            tw = _CHANNEL_SHAPES[name][1]
            k = 8 * tw
            w16 = cb[..., slices[name]].astype(jnp.int32)
            d = jnp.where(w16 != 0, w16 - SPARSE16_DELTA_BIAS, 0)
            out[name] = jnp.transpose(
                d.reshape(batch, bpc, bpr, k), (0, 1, 3, 2)
            )
        return out

    # -- stage 1: channel slice + delta un-bias + kt transpose ------------
    def unbias_body(cb, c, s):
        d = unbias_all(cb ^ c.astype(jnp.uint16))
        s = s + sum(jnp.sum(v.astype(jnp.float32)) for v in d.values())
        return (s % 2).astype(jnp.uint16), s

    print("timing unbias_kt ...", flush=True)
    stages["unbias_kt"] = {
        "measured_s": _chain_bench_u16(unbias_body, comb, chain),
        "flops": 0,
        "bytes": 4 * npix + 8 * npix,  # u16 combined in, i32 kt deltas out
    }

    d0 = jax.jit(unbias_all)(comb)

    # -- stage 2: folded suffix-basis einsum (deltas → u8 planes) ---------
    def planes_all(d):
        out = {}
        for name in CHANNELS:
            tw = _CHANNEL_SHAPES[name][1]
            out[name] = jax.vmap(
                lambda dk, n=name, w=tw: fused_inverse_plane_sparse_jnp(
                    dk, pipeline._tables[n], w, jnp.float32,
                    upsample_cols=(n != "lum"),
                )
            )(d[name])
        return out

    def einsum_body(d, c, s):
        out = planes_all({k: v + c.astype(jnp.int32) for k, v in d.items()})
        s = s + sum(jnp.sum(o.astype(jnp.float32)) for o in out.values())
        return (s % 2).astype(jnp.uint16), s

    print("timing folded_einsum ...", flush=True)
    stages["folded_einsum"] = {
        "measured_s": _chain_bench_u16(einsum_body, d0, chain),
        # luma: npix outputs × 64-contraction; chroma: 2 channels × npix
        # full-width outputs (upsample folded) × 32-contraction.
        "flops": 2 * 64 * npix + 2 * 32 * 2 * npix,
        "bytes": 8 * npix + 3 * npix,  # i32 deltas in, u8 planes out
    }

    planes0 = jax.jit(planes_all)(d0)

    # -- stage 3: plane YCbCr merge (u8 planes → RGB) ---------------------
    def merge_body(planes, c, s):
        rgb = jax.vmap(
            lambda y, r, b: ycbcr_planes_to_rgb(
                y, r, b, size, size, jnp.float32, chroma_upsampled=True
            )
        )(
            planes["lum"] + c.astype(jnp.uint8),
            planes["r"],
            planes["b"],
        )
        # Full-RGB fence: a single channel would DCE the Cb chain.
        s = s + jnp.sum(rgb.astype(jnp.float32))
        return (s % 2).astype(jnp.uint16), s

    print("timing color_merge ...", flush=True)
    stages["color_merge"] = {
        "measured_s": _chain_bench_u16(merge_body, planes0, chain),
        "flops": 10 * npix,
        "bytes": 3 * npix + 3 * npix,  # u8 planes in, RGB u8 out
    }

    # -- whole inverse chain (what the device-decode bench times) ---------
    def full_body(cb, c, s):
        rgb = jax.vmap(
            lambda cc: pipeline._inverse_sparse_impl(
                cc, bpc=bpc, bpr=bpr, height=size, width=size
            )
        )(cb ^ c.astype(jnp.uint16))
        s = s + jnp.sum(rgb.astype(jnp.float32))
        return (s % 2).astype(jnp.uint16), s

    print("timing full_inverse ...", flush=True)
    stages["full_inverse"] = {
        "measured_s": _chain_bench_u16(full_body, comb, chain),
        "flops": sum(
            stages[k]["flops"]
            for k in ("unbias_kt", "folded_einsum", "color_merge")
        ),
        "bytes": 4 * npix + 3 * npix,  # combined u16 in, RGB u8 out
    }

    # Anti-DCE guard: the compiled chain must contain its contraction.
    f = _make_chained_u16(full_body, chain)
    hlo = f.lower(comb, jnp.uint16(0)).compile().as_text()
    if hlo.count("dot(") + hlo.count(" dot(") + hlo.count("fusion") == 0:
        raise RuntimeError(
            "DCE guard: compiled inverse chain contains no contraction — "
            "the fence collapsed; numbers would be hollow."
        )

    # -- fence floor: xor-perturb + checksum traffic per iteration --------
    def floor_body(cb, c, s):
        (x,) = jax.lax.optimization_barrier((cb ^ c.astype(jnp.uint16),))
        s = s + jnp.sum(x.astype(jnp.float32))
        return (s % 2).astype(jnp.uint16), s

    print("timing fence_floor ...", flush=True)
    floor_s = _chain_bench_u16(floor_body, comb, chain)

    print("timing hbm_stream ceiling ...", flush=True)
    hbm_probe = measure_hbm_stream_ceiling(
        footprint_bytes=min(512 << 20, 4 * npix), chain=16
    )
    hbm_measured_gbs = hbm_probe["ceiling_gbs"]

    peaks = _roofline_arith(stages, hbm_measured_gbs)

    device_stages = ("unbias_kt", "folded_einsum", "color_merge")
    stage_sum = sum(stages[k]["measured_s"] for k in device_stages)
    limiter = max(device_stages, key=lambda k: stages[k]["measured_s"])
    result = {
        "size": size,
        "batch": batch,
        "chain": chain,
        "device_kind": jax.devices()[0].device_kind,
        "formulation": "sparse16_folded",
        "peaks": peaks,
        "hbm_stream_ceiling": hbm_probe,
        "mpix_per_iter": npix / 1e6,
        "fence_floor": {
            "measured_s": floor_s,
            "note": (
                "per-iteration xor-perturb + checksum of the combined "
                "buffer (barriered); embedded in every stage's "
                "measured_s — subtract for kernel-marginal comparisons"
            ),
        },
        "stages": stages,
        "stage_sum_s": stage_sum,
        "fusion_gap_s": stages["full_inverse"]["measured_s"] - stage_sum,
        "limiting_stage": limiter,
        "full_inverse_mpix_s": npix / 1e6 / stages["full_inverse"]["measured_s"],
    }

    print(f"\nJPEG inverse roofline — {size}² × batch {batch} "
          f"({npix/1e6:.0f} MPix/iter) on {result['device_kind']}")
    print(f"measured stream ceiling: {hbm_measured_gbs:.0f} GB/s "
          f"(published {peaks['hbm_gbs']:.0f})")
    _print_table(stages, (*device_stages, "full_inverse"))
    print(f"limiting stage: {limiter}; "
          f"fusion gap {result['fusion_gap_s']*1e3:+.2f} ms; "
          f"inverse {result['full_inverse_mpix_s']:.0f} MPix/s")

    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def _make_chained_u16(body, chain: int):
    import jax
    import jax.numpy as jnp

    def chained(x, c0):
        def step(_, carry):
            c, s = carry
            return body(x, c, s)

        _, s = jax.lax.fori_loop(0, chain, step, (c0, jnp.float32(0)))
        return s

    return jax.jit(chained)


def _chain_bench_u16(body, data, chain: int, runs: int = 4) -> float:
    """``_chain_bench`` with a uint16 carry (XOR-compatible with the
    packed16 pair words)."""
    import jax
    import jax.numpy as jnp

    f = _make_chained_u16(body, chain)
    jax.block_until_ready(f(data, jnp.uint16(0)))
    best = 1e9
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(f(data, jnp.uint16(0)))
        best = min(best, time.perf_counter() - t0)
    return best / chain
