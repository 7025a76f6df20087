"""Scaling-efficiency sweep over mesh sizes.

The reference's scaling story is a speedup table of thread-per-block wall
times (BASELINE.md: 4.7×–18.7× at 64–2048 px).  The device equivalent runs
the *same sharded program* over meshes of 1, 2, 4, … devices and reports
throughput + parallel efficiency.  On a CPU host with
``--xla_force_host_platform_device_count`` the numbers validate the harness
and the sharding, not a device; on several GPUs they measure the
interconnect's scaling.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from lz4jpeg_tpu.bench.harness import trimmed_mean
from lz4jpeg_tpu.utils.profiling import time_device


def jpeg_scaling_sweep(
    image_size: int = 512,
    mesh_sizes: Optional[List[int]] = None,
    runs: int = 5,
    output: Optional[str] = None,
) -> List[Dict]:
    import jax

    from lz4jpeg_tpu.config import JPEGConfig, MeshConfig
    from lz4jpeg_tpu.parallel import ShardedJPEGForward, codec_mesh

    n_dev = len(jax.devices())
    sizes = mesh_sizes or [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
    results = []
    base_mean = None
    for n in sizes:
        mesh = codec_mesh(MeshConfig(num_devices=n))
        fwd = ShardedJPEGForward(mesh, JPEGConfig(precision="fast"))

        import jax.numpy as jnp

        from lz4jpeg_tpu.ops.color import (
            chroma_subsample_422,
            rgb_to_ycbcr,
            split_mcus,
        )
        from lz4jpeg_tpu.parallel.mesh import pad_to_devices

        y, cr, cb = rgb_to_ycbcr(jnp.asarray(img), jnp.float32)
        lum, r, b = split_mcus(
            y, chroma_subsample_422(cr), chroma_subsample_422(cb)
        )
        lum, _ = pad_to_devices(np.asarray(lum), n)
        r, _ = pad_to_devices(np.asarray(r), n)
        b, _ = pad_to_devices(np.asarray(b), n)
        args = [
            jax.device_put(a, fwd._shard) for a in (lum, r, b)
        ]
        times = time_device(fwd._mcu_stage_impl, *args, runs=runs)
        mean = trimmed_mean(times)
        if base_mean is None:
            base_mean = mean
        speedup = base_mean / mean
        results.append(
            {
                "devices": n,
                "mean_s": mean,
                "speedup": speedup,
                "efficiency": speedup / (n / sizes[0]),
                "mpix_per_s": image_size * image_size / 1e6 / mean,
            }
        )
        print(
            f"{n} devices: {mean*1e3:.2f} ms  speedup {speedup:.2f}x  "
            f"efficiency {results[-1]['efficiency']:.2f}"
        )
    if output:
        import json

        payload = {
            "image_size": image_size,
            "platform": jax.devices()[0].platform,
            "runs": runs,
            "entries": results,
        }
        if payload["platform"] == "cpu":
            payload["note"] = (
                "virtual devices sharing ONE (throttled) host: wall-clock "
                "speedup/efficiency are not meaningful here — this sweep "
                "validates sharded correctness and collective overhead "
                "shape only; real scaling needs real chips"
            )
        with open(output, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {output}")
    return results
