"""Worker script for the two-process multihost gather test.

Launched by tests/test_multihost_distributed.py with:
    python multihost_worker.py <coordinator> <num_processes> <process_id>
Each process contributes payloads of *different* widths (exercising the
global max-length padding) and asserts the gathered, ordered result.
"""

import sys


def main() -> int:
    coordinator, num_processes, process_id = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from lz4jpeg_tpu.parallel.multihost import (
        initialize,
        ordered_allgather_payloads,
    )

    count = initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    assert count == num_processes, count

    # Process 0 holds short payloads of blocks {0, 2}; process 1 holds a
    # much longer payload of block {1} — widths differ across processes.
    if process_id == 0:
        local = [b"aa", b"cccc"]
        indices = [0, 2]
    else:
        local = [b"b" * 100]
        indices = [1]
    out = ordered_allgather_payloads(local, indices, 3)
    assert out == [b"aa", b"b" * 100, b"cccc"], [len(p) for p in out]
    print(f"process {process_id}: gather OK")

    # Full cross-process fast encode: strided block shards, ordered payload
    # gather, identical frame on every process, equal to the single-process
    # device-engine encode (asserted by the launcher).
    from lz4jpeg_tpu.formats.fast_frame import decode_fast
    from lz4jpeg_tpu.parallel.lz4 import multihost_fast_encode
    from lz4jpeg_tpu.utils.inputs import generate_text_corpus

    data = generate_text_corpus(120_000, seed=0)
    frame = multihost_fast_encode(data)
    assert decode_fast(frame) == data
    out_path = sys.argv[4]
    with open(f"{out_path}.{process_id}", "wb") as f:
        f.write(frame)
    print(f"process {process_id}: encode OK ({len(frame)} bytes)")

    # Cross-process JPEG encode: band shards, all-reduced histograms →
    # identical broadcast codebooks, ordered bitstream gather.
    import numpy as np

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.parallel.jpeg import multihost_jpeg_encode
    from lz4jpeg_tpu.utils.inputs import generate_noise_image

    img = generate_noise_image(96, 80, np.random.default_rng(7))
    container = multihost_jpeg_encode(
        img, JPEGConfig(precision="fast", entropy="shared")
    )
    with open(f"{out_path}.jpeg.{process_id}", "wb") as f:
        f.write(container)
    print(f"process {process_id}: jpeg OK ({len(container)} bytes)")

    # Cross-process decode, both codecs: strided block stripes (LZ4T) /
    # contiguous MCU-row bands (JPEG) resolve locally and gather in order;
    # every process must reconstruct bytes identical to a local decode.
    from lz4jpeg_tpu.parallel.lz4 import multihost_fast_decode

    assert multihost_fast_decode(frame) == data
    print(f"process {process_id}: decode OK")

    from lz4jpeg_tpu.formats.jpeg_container import unpack_container
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.parallel.jpeg import multihost_jpeg_decode

    cfg = JPEGConfig(precision="fast", entropy="shared")
    mh_img = multihost_jpeg_decode(container, cfg)
    local_img = JPEGPipeline(cfg).decode(unpack_container(container))
    assert mh_img.shape == local_img.shape
    assert (mh_img == local_img).all()
    print(f"process {process_id}: jpeg decode OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
