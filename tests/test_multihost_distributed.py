"""Two-process jax.distributed test of the cross-host ordered gather.

Spawns two real Python processes coordinated over localhost (the
CPU-simulated multi-host setup of SURVEY.md §7 step 7) and checks that
``ordered_allgather_payloads`` reassembles ragged per-process payloads in
original block order — including the differing-payload-width case that
requires the global max-length padding.
"""

import os
import socket
import subprocess
import sys
import tempfile

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_ordered_gather():
    # No pytest.mark.timeout here: pytest-timeout isn't installed (the
    # mark would be a silent no-op).  The real hang guard is the
    # ``communicate(timeout=200)`` + kill below — a deliberately hung
    # worker fails this test instead of hanging the suite.
    coordinator = f"127.0.0.1:{_free_port()}"
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one device per process is fine
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out_base = os.path.join(
        tempfile.mkdtemp(prefix="mh_frames_"), "frame.bin"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(i), out_base],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=repo_root,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outputs.append(out)
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert "gather OK" in out
        assert "encode OK" in out
        assert "decode OK" in out
        assert "jpeg decode OK" in out

    # Every process assembled the identical frame, byte-for-byte equal to
    # a local single-process device-engine encode of the same input.
    frames = [open(f"{out_base}.{i}", "rb").read() for i in range(2)]
    assert frames[0] == frames[1]
    from lz4jpeg_tpu.config import LZ4Config
    from lz4jpeg_tpu.models.lz4 import LZ4Codec

    from lz4jpeg_tpu.utils.inputs import generate_text_corpus

    data = generate_text_corpus(120_000, seed=0)
    local = LZ4Codec(LZ4Config(mode="fast")).encode(data, engine="device")
    assert frames[0] == local

    # JPEG: identical containers on both processes, byte-equal to the
    # single-process encode of the same image.
    import numpy as np

    from lz4jpeg_tpu.config import JPEGConfig
    from lz4jpeg_tpu.formats.jpeg_container import pack_container
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu.utils.inputs import generate_noise_image

    for i, out in enumerate(outputs):
        assert "jpeg OK" in out, f"process {i}:\n{out}"
    containers = [
        open(f"{out_base}.jpeg.{i}", "rb").read() for i in range(2)
    ]
    assert containers[0] == containers[1]
    cfg = JPEGConfig(precision="fast", entropy="shared")
    img = generate_noise_image(96, 80, np.random.default_rng(7))
    assert containers[0] == pack_container(JPEGPipeline(cfg).encode(img))
