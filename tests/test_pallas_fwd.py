"""Forward kernel (ops/pallas_fwd.py): interpret-mode parity with the XLA
chain, its shapes and padding, and where the pipeline chooses it.

The kernel must produce the combined sparse16 stream of the XLA chain —
color → 4:2:2 subsample → fused basis matmul → sparse-delta RLE —
bit for bit on the CPU interpreter.  On the card the same comparison is
made at full size by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from lz4jpeg_tpu.config import JPEGConfig
from lz4jpeg_tpu.models.jpeg import JPEGPipeline
from lz4jpeg_tpu.ops.pallas_fwd import TILE_BLOCKS, forward_kernel
from lz4jpeg_tpu.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    scale_table,
)

_TRITON_CALL = "__gpu$xla.gpu.triton"


def _runs_image(rng, shape):
    rgb = rng.integers(0, 256, size=shape, dtype=np.uint8)
    rgb[..., ::2, :] = rgb[..., 1::2, :]  # horizontal pairs → runs
    return rgb


def _kernel(rgb, lum_t=LUMINANCE_QUANTIZATION_TABLE,
            chr_t=CHROMINANCE_QUANTIZATION_TABLE):
    return np.asarray(
        forward_kernel(jnp.asarray(rgb), lum_t, chr_t, interpret=True)
    )


def _cuda_module_text(fn, shape) -> str:
    """``fn`` lowered for a CUDA device (no card needed to lower)."""
    exp = export.export(
        jax.jit(fn),
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(_TRITON_CALL)],
    )(jax.ShapeDtypeStruct(shape, jnp.uint8))
    return exp.mlir_module()


class TestForwardKernel:
    @pytest.mark.parametrize("shape", [(64, 64), (24, 72), (8, 8), (16, 1032)])
    def test_bit_identical_to_xla_chain(self, shape):
        rng = np.random.default_rng(sum(shape))
        rgb = _runs_image(rng, shape + (3,))
        pipe = JPEGPipeline(JPEGConfig())
        ref = np.asarray(jax.jit(pipe._forward_sparse16_xla)(rgb))
        got = _kernel(rgb)
        n = (shape[0] // 8) * (shape[1] // 8)
        assert got.shape == ref.shape == (n, 128)
        np.testing.assert_array_equal(got, ref)

    def test_padding_rows_sliced_off(self):
        """27 blocks is not a TILE_BLOCKS multiple: the last program's
        spare rows must neither reach the output nor disturb block 26."""
        rng = np.random.default_rng(2)
        rgb = rng.integers(0, 256, size=(24, 72, 3), dtype=np.uint8)
        assert (3 * 9) % TILE_BLOCKS
        got = _kernel(rgb)
        assert got.shape == (27, 128)
        pipe = JPEGPipeline(JPEGConfig())
        ref = np.asarray(jax.jit(pipe._forward_sparse16_xla)(rgb))
        np.testing.assert_array_equal(got[-1], ref[-1])

    def test_vmap_batches_frames(self):
        rng = np.random.default_rng(4)
        rgbs = _runs_image(rng, (3, 16, 40, 3))
        pipe = JPEGPipeline(JPEGConfig())
        got = np.asarray(jax.vmap(
            lambda x: forward_kernel(
                x, pipe._tables["lum"], pipe._tables["r"], interpret=True
            )
        )(jnp.asarray(rgbs)))
        ref = np.asarray(jax.vmap(pipe._forward_sparse16_xla)(rgbs))
        np.testing.assert_array_equal(got, ref)

    def test_quality_scaled_tables(self):
        rng = np.random.default_rng(3)
        rgb = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        pipe = JPEGPipeline(JPEGConfig(quality=80))
        ref = np.asarray(jax.jit(pipe._forward_sparse16_xla)(rgb))
        got = _kernel(
            rgb,
            scale_table(LUMINANCE_QUANTIZATION_TABLE, 80),
            scale_table(CHROMINANCE_QUANTIZATION_TABLE, 80),
        )
        np.testing.assert_array_equal(got, ref)

    def test_rejects_ragged_shapes(self):
        with pytest.raises(ValueError, match="8-aligned"):
            forward_kernel(
                jnp.zeros((12, 16, 3), jnp.uint8),
                LUMINANCE_QUANTIZATION_TABLE,
                CHROMINANCE_QUANTIZATION_TABLE,
            )


class TestKernelChoice:
    """The pipeline calls the kernel only when lowering for CUDA with an
    8-aligned shape; everything else is the XLA chain."""

    def test_cuda_aligned_shape_lowers_the_kernel(self):
        pipe = JPEGPipeline(JPEGConfig())
        text = _cuda_module_text(pipe._forward_rle_impl, (16, 64, 3))
        assert _TRITON_CALL in text

    def test_cuda_ragged_shape_runs_xla(self):
        pipe = JPEGPipeline(JPEGConfig())
        text = _cuda_module_text(pipe._forward_rle_impl, (12, 64, 3))
        assert _TRITON_CALL not in text

    def test_cpu_runs_xla(self):
        pipe = JPEGPipeline(JPEGConfig())
        rgb = jax.ShapeDtypeStruct((16, 64, 3), jnp.uint8)
        text = jax.jit(pipe._forward_rle_impl).lower(rgb).as_text()
        assert "triton" not in text
