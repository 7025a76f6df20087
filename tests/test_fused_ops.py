"""Fused single-matmul MCU transform vs the staged pipeline and oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from lz4jpeg_tpu.ops.dct import dct2_batched, idct2_batched
from lz4jpeg_tpu.ops.fused import fused_forward_jnp, fused_inverse_jnp
from lz4jpeg_tpu.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    dequantize,
    quantize,
)
from lz4jpeg_tpu.ops.zigzag import reverse_zigzag, zigzag


def _table(w):
    return (
        LUMINANCE_QUANTIZATION_TABLE
        if w == 8
        else CHROMINANCE_QUANTIZATION_TABLE
    )


def staged_forward(tiles, w, h, dtype):
    table = _table(w).reshape(h, w)
    q = quantize(dct2_batched(jnp.asarray(tiles), dtype), table)
    return np.asarray(zigzag(q, w, h))


class TestFusedForward:
    @pytest.mark.parametrize("w,h", [(8, 8), (4, 8)])
    def test_matches_staged_f64(self, rng, w, h):
        tiles = rng.integers(0, 256, size=(64, h, w), dtype=np.uint8)
        fused = np.asarray(
            fused_forward_jnp(jnp.asarray(tiles), _table(w), w, h, jnp.float64)
        )
        np.testing.assert_array_equal(
            fused, staged_forward(tiles, w, h, jnp.float64)
        )

    @pytest.mark.parametrize("w,h", [(8, 8), (4, 8)])
    def test_f32_matches_f64(self, rng, w, h):
        tiles = rng.integers(0, 256, size=(128, h, w), dtype=np.uint8)
        f32 = np.asarray(
            fused_forward_jnp(jnp.asarray(tiles), _table(w), w, h, jnp.float32)
        )
        f64 = np.asarray(
            fused_forward_jnp(jnp.asarray(tiles), _table(w), w, h, jnp.float64)
        )
        np.testing.assert_array_equal(f32, f64)

    def test_solid_blocks(self):
        tiles = np.full((4, 8, 8), 128, dtype=np.uint8)
        fused = np.asarray(
            fused_forward_jnp(jnp.asarray(tiles), _table(8), 8, 8)
        )
        np.testing.assert_array_equal(fused, 0)


class TestMatmulPrecision:
    """Guard against reduced-precision matmul defaults (TF32 on the GPU's
    tensor cores, bf16 passes elsewhere): all DCT-path matmuls must request
    HIGHEST precision, else quantized coefficients flip across trunc
    boundaries on the accelerator.  The CPU cannot reproduce the flip,
    but the lowered jaxpr can be inspected anywhere."""

    def test_forward_paths_request_highest(self):
        import jax

        fns = {
            "fused_forward": lambda t: fused_forward_jnp(
                t, LUMINANCE_QUANTIZATION_TABLE, 8, 8
            ),
            "fused_inverse": lambda t: fused_inverse_jnp(
                t.reshape(-1, 64).astype(jnp.float32),
                LUMINANCE_QUANTIZATION_TABLE, 8, 8,
            ),
            "dct2": lambda t: dct2_batched(t, jnp.float32),
            "idct2": lambda t: idct2_batched(
                t.astype(jnp.float32), jnp.float32
            ),
        }
        for name, fn in fns.items():
            jaxpr = str(
                jax.make_jaxpr(fn)(jnp.zeros((4, 8, 8), jnp.uint8))
            )
            assert "HIGHEST" in jaxpr, f"{name} lost HIGHEST precision"
            assert "Precision.DEFAULT" not in jaxpr, (
                f"{name} has a default-precision dot"
            )


class TestFusedInverse:
    @pytest.mark.parametrize("w,h", [(8, 8), (4, 8)])
    def test_matches_staged_f64(self, rng, w, h):
        tiles = rng.integers(0, 256, size=(32, h, w), dtype=np.uint8)
        zz = fused_forward_jnp(jnp.asarray(tiles), _table(w), w, h, jnp.float64)
        fused = np.asarray(
            fused_inverse_jnp(zz, _table(w), w, h, jnp.float64)
        )
        table = _table(w).reshape(h, w)
        staged = np.asarray(
            idct2_batched(
                dequantize(
                    reverse_zigzag(zz.astype(jnp.float64), w, h).reshape(
                        -1, h, w
                    ),
                    table,
                ),
                jnp.float64,
            )
        )
        np.testing.assert_array_equal(fused, staged)


class TestFusedWithScaledTables:
    @pytest.mark.parametrize("quality", [10, 75, 95])
    def test_fused_matches_staged_at_quality(self, rng, quality):
        from lz4jpeg_tpu.ops.quantize import scale_table

        table = scale_table(LUMINANCE_QUANTIZATION_TABLE, quality)
        tiles = rng.integers(0, 256, size=(32, 8, 8), dtype=np.uint8)
        fused = np.asarray(
            fused_forward_jnp(jnp.asarray(tiles), table, 8, 8, jnp.float64)
        )
        staged = np.asarray(
            zigzag(
                quantize(
                    dct2_batched(jnp.asarray(tiles), jnp.float64),
                    table.reshape(8, 8),
                ),
                8, 8,
            )
        )
        np.testing.assert_array_equal(fused, staged)
