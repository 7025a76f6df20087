"""Headline benchmark: JPEG forward transform throughput on one device.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric: device-side MPix/s of the full batched forward transform (color →
4:2:2 → MCU split → DCT → quantize → zigzag → RLE) on a 2048×2048 noise
image — the reference's largest experiment size.  Methodology mirrors the
reference harness: 10 runs, trimmed mean dropping min and max
(``Experiment/JPEG_parallel_experiment.c``; see lz4jpeg_tpu/bench/).

Baseline: the reference's *parallel* JPEG at 2048×2048 took a trimmed-mean
26.7048 s on the author's machine (BASELINE.md) ≈ 0.157 MPix/s — and that
run measured the same forward work plus its inverse, but the parallel
reference's timing also included threads doing the inverse chain; we
compare against forward-only throughput conservatively by using their
whole-pipeline time.
"""

import json
import sys


def main() -> None:
    from lz4jpeg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lz4jpeg_tpu.bench import run_timed
    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.utils.inputs import generate_noise_image

    size = 2048
    batch = 256  # frames per dispatch (3.2 GB of RGB)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(
        np.stack(
            [generate_noise_image(size, size, rng) for _ in range(batch)]
        )
    )

    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
    # Exactly what encode ships to the host: one (N, 128) combined
    # sparse-delta buffer per frame.
    forward = jax.jit(jax.vmap(pipeline._forward_rle_impl))

    def step():
        jax.block_until_ready(forward(imgs))

    result = run_timed(
        f"jpeg_forward_2048_b{batch}",
        step,
        scale=size,
        runs=10,
        warmup=2,
        work=batch * size * size / 1e6,
        work_unit="MPix",
    )

    baseline_mpix_s = (size * size / 1e6) / 26.7048  # reference parallel 2048²
    print(
        json.dumps(
            {
                "metric": f"jpeg_forward_throughput_2048_b{batch}",
                "value": round(result.throughput, 2),
                "unit": "MPix/s",
                "vs_baseline": round(result.throughput / baseline_mpix_s, 1),
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
