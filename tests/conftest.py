"""Test configuration.

Tests run on CPU with a virtual 8-device mesh so that sharding paths compile
and execute without an accelerator (SURVEY.md §4's multi-host test
strategy), and with x64 enabled so the "exact" float64 pipelines are
available.  Kernels run here in Pallas interpret mode; ``python
chip_smoke.py`` runs them compiled on the GPU.
"""

import os

# Set before JAX initializes a backend; the config update below repeats the
# platform choice in case JAX was imported earlier in the process.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The reference's golden fixtures (its Output-Input directory) are not part
# of this repository; tests of bit-exactness against them skip without it.
REFERENCE_ROOT = os.environ.get("LZ4JPEG_REFERENCE_ROOT", "")
GOLDEN_INPUT = os.path.join(REFERENCE_ROOT, "Output-Input/input/input.txt")
GOLDEN_COMPRESSED = os.path.join(REFERENCE_ROOT, "Output-Input/out/compressed.bin")
GOLDEN_UNCOMPRESSED = os.path.join(REFERENCE_ROOT, "Output-Input/out/uncompressed.txt")

# Seeded stand-in for the reference's text corpus (about its size).
CORPUS_BYTES = 120_000


def _golden(path: str) -> bytes:
    if not REFERENCE_ROOT or not os.path.exists(path):
        pytest.skip(
            "reference golden fixtures not present "
            "(set LZ4JPEG_REFERENCE_ROOT to the reference checkout)"
        )
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def golden_input() -> bytes:
    return _golden(GOLDEN_INPUT)


@pytest.fixture(scope="session")
def golden_compressed() -> bytes:
    return _golden(GOLDEN_COMPRESSED)


@pytest.fixture(scope="session")
def golden_uncompressed() -> bytes:
    return _golden(GOLDEN_UNCOMPRESSED)


@pytest.fixture(scope="session")
def text_corpus() -> bytes:
    from lz4jpeg_tpu.utils.inputs import generate_text_corpus

    return generate_text_corpus(CORPUS_BYTES, seed=0)


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)

