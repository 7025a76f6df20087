"""Golden validation on the reference's committed images.

The reference ships four real images (``Assets/Images/``: og.png 1200×630
RGBA, jellyfish.png 1500×1267, switzerland-uot.png 1600×1060 palette,
Solid_red.png 200×200 palette) and commits the stage outputs its parallel
``main`` produced from og.png (``Output-Input/Images/``; generation code
``Algorithms/parallel/JPEG/JPEG.c:219-300,1121-1123,1254-1355``).

Provenance established here byte-for-byte:

* ``luminance.png``   = Y of og.png computed with **x87 80-bit extended
  intermediates** (the author's 32-bit Windows toolchain): on exact-integer
  gray ties the extended-precision expression lands an ulp BELOW the
  integer and truncates down — ``np.longdouble`` emulation matches all
  756,000 pixels, plain-double evaluation differs on exactly those ties.
* ``rChrominance.png`` / ``bChrominance.png`` = the visualization renders
  of the full-resolution (pre-subsampling) chroma planes — our
  ``utils.visualize`` functions reproduce them exactly (plain double; the
  +128 offset keeps those expressions off exact-integer ties).
* ``reconstructed.png`` = assemble(divide(Y, subsampled chroma)) with **no
  DCT/quant/entropy at all** — the committed proof of the reference's
  pass-by-value bug (JPEG.c:1299-1300): worker threads mutate private
  copies, so main reassembles the untouched pre-transform blocks.

Plus real-content pipeline parity: the exact pipeline is coefficient- and
RLE-exact against the oracle on crops of every committed image, and the
Solid_red degenerate (maximal zero-run distributions) round-trips through
both entropy modes.
"""

import os

import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig
from lz4jpeg_tpu.models import JPEGPipeline
from lz4jpeg_tpu.oracle import jpeg_oracle as oracle
from lz4jpeg_tpu.utils.io import read_png
from lz4jpeg_tpu.utils.visualize import (
    b_chrominance_image,
    luminance_image,
    r_chrominance_image,
)

_ROOT = os.environ.get("LZ4JPEG_REFERENCE_ROOT", "")
ASSETS = os.path.join(_ROOT, "Assets/Images")
STAGE_DIR = os.path.join(_ROOT, "Output-Input/Images")

pytestmark = pytest.mark.skipif(
    not _ROOT or not os.path.isdir(ASSETS),
    reason="reference assets not present (set LZ4JPEG_REFERENCE_ROOT)",
)


def _load_rgba(name):
    from PIL import Image

    with Image.open(os.path.join(ASSETS, name)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def _load_stage(name):
    from PIL import Image

    with Image.open(os.path.join(STAGE_DIR, name)) as im:
        return np.asarray(im, dtype=np.uint8)


@pytest.fixture(scope="module")
def og_rgb():
    return _load_rgba("og.png")[..., :3]


@pytest.fixture(scope="module")
def x87_luma(og_rgb):
    """Y plane with x87 80-bit extended-precision intermediates.

    ``build_luminance_matrix`` (JPEG.c:118-135) assigns the raw double
    expression to uint8_t; the author's compiler kept the subexpressions on
    the x87 stack, so exact-integer ties (gray pixels, where the three
    coefficients sum to exactly 1) evaluate an ulp below the integer."""
    ld = np.longdouble
    r = og_rgb[..., 0].astype(ld)
    g = og_rgb[..., 1].astype(ld)
    b = og_rgb[..., 2].astype(ld)
    y = ld(np.float64(0.299)) * r + ld(np.float64(0.587)) * g + ld(
        np.float64(0.114)
    ) * b
    return np.trunc(y).astype(np.uint8)


class TestCommittedStageProvenance:
    def test_luminance_is_x87_evaluated(self, og_rgb, x87_luma):
        committed = _load_stage("luminance.png")
        assert committed.shape == (630, 1200, 4)
        pred = np.concatenate(
            [luminance_image(x87_luma), np.full((630, 1200, 1), 255, np.uint8)],
            axis=-1,
        )
        np.testing.assert_array_equal(pred, committed)

    def test_luminance_double_path_differs_only_on_ties(self, og_rgb):
        """Our plain-double oracle Y is +1 on exact-integer ties and equal
        everywhere else — the measured extent of the x87 divergence."""
        committed = _load_stage("luminance.png")[..., 0]
        y_double, _, _ = oracle.build_ycbcr_planes(og_rgb, snap_ties=False)
        delta = y_double.astype(int) - committed.astype(int)
        assert set(np.unique(delta)) <= {0, 1}
        # Every +1 pixel is an exact-integer tie of the double expression.
        ties = delta == 1
        r = og_rgb[..., 0].astype(np.float64)
        g = og_rgb[..., 1].astype(np.float64)
        b = og_rgb[..., 2].astype(np.float64)
        expr = 0.299 * r + 0.587 * g + 0.114 * b
        assert (expr[ties] == np.round(expr[ties])).all()

    def test_chrominance_visualizations_exact(self, og_rgb):
        _, cr, cb = oracle.build_ycbcr_planes(og_rgb, snap_ties=False)
        alpha = np.full((*cr.shape, 1), 255, np.uint8)
        pred_r = np.concatenate([r_chrominance_image(cr), alpha], axis=-1)
        np.testing.assert_array_equal(pred_r, _load_stage("rChrominance.png"))
        pred_b = np.concatenate([b_chrominance_image(cb), alpha], axis=-1)
        np.testing.assert_array_equal(pred_b, _load_stage("bChrominance.png"))

    def test_original_is_og_rgba(self):
        committed = _load_stage("original.png")
        np.testing.assert_array_equal(committed, _load_rgba("og.png"))

    def test_reconstructed_proves_by_value_bug(self, og_rgb, x87_luma):
        """The committed reconstruction contains NO transform loss: it is
        exactly the color/subsample round trip of the untouched blocks —
        byte-level proof of the pass-by-value bug (JPEG.c:1299-1300)."""
        _, cr, cb = oracle.build_ycbcr_planes(og_rgb, snap_ties=False)
        planes = oracle.divide_image(
            x87_luma, oracle.chroma_subsample(cr), oracle.chroma_subsample(cb)
        )
        rec = oracle.assemble_image(planes)
        committed = _load_stage("reconstructed.png")
        np.testing.assert_array_equal(rec, committed[..., :3])
        assert (committed[..., 3] == 255).all()


class TestRealContentPipelineParity:
    """Exact pipeline vs oracle on real photographic content — long zero
    runs, smooth gradients, and saturated regions that RNG noise (the only
    prior JPEG fixture) never exercises."""

    CROPS = {
        "og.png": (np.s_[200:328, 500:628], None),
        "jellyfish.png": (np.s_[400:528, 600:728], None),
        "switzerland-uot.png": (np.s_[300:428, 700:828], None),
        "Solid_red.png": (np.s_[:, :], None),  # full 200×200 degenerate
    }

    @pytest.fixture(scope="class")
    def exact_pipeline(self):
        return JPEGPipeline(JPEGConfig(precision="exact", entropy="shared"))

    @pytest.mark.parametrize("name", list(CROPS))
    def test_zigzag_and_rle_match_oracle(self, name, exact_pipeline):
        img = _load_rgba(name)[..., :3][self.CROPS[name][0]]
        ref = oracle.jpeg_forward_oracle(img, snap_ties=True)
        stages = exact_pipeline.forward_stages(img)
        np.testing.assert_array_equal(stages["lum"]["zz"], ref["zz_lum"])
        np.testing.assert_array_equal(stages["r"]["zz"], ref["zz_r"])
        np.testing.assert_array_equal(stages["b"]["zz"], ref["zz_b"])
        enc = exact_pipeline.encode(img, entropy=False)
        for c, key in (("lum", "rle_lum"), ("r", "rle_r"), ("b", "rle_b")):
            for i in range(enc.num_blocks):
                n = int(enc.rle_lengths[c][i])
                assert list(enc.rle[c][i, :n]) == ref[key][i], (name, c, i)

    @pytest.mark.parametrize("name", list(CROPS))
    def test_reconstruction_matches_oracle(self, name, exact_pipeline):
        img = _load_rgba(name)[..., :3][self.CROPS[name][0]]
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        np.testing.assert_array_equal(exact_pipeline.roundtrip(img), ref_rec)

    def test_solid_red_degenerate_runs(self, exact_pipeline):
        """All-DC blocks: every AC coefficient quantizes to zero, so each
        63-long zero run hits the RLE count limits — the distribution the
        pack16 count field (6 bits) and per-block Huffman must survive."""
        img = _load_rgba("Solid_red.png")[..., :3]
        assert (img.reshape(-1, 3) == img[0, 0]).all()  # truly solid
        enc = exact_pipeline.encode(img, entropy=False)
        # Maximal-run RLE: few pairs per block (DC + one zero run + tail).
        assert int(np.max(enc.rle_lengths["lum"])) <= 8
        rec = exact_pipeline.roundtrip(img)
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        np.testing.assert_array_equal(rec, ref_rec)

    def test_solid_red_per_block_entropy_roundtrip(self):
        """The per-block parity Huffman on a 2-to-3-symbol alphabet (the
        quirky heap's smallest trees) — encode and re-decode bit-exact."""
        pipe = JPEGPipeline(JPEGConfig(precision="exact", entropy="per_block"))
        img = _load_rgba("Solid_red.png")[..., :3][:40, :40]
        enc = pipe.encode(img)
        assert enc.per_block_bits is not None
        rec = pipe.decode(enc)
        ref_rec, _ = oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        np.testing.assert_array_equal(rec, ref_rec)


class TestFullImageRoundTrip:
    """Fast (production) pipeline over the full committed images — the
    ragged 1200×630 RGBA og.png exercises the non-conforming-shape
    fallbacks end to end; MSE/PSNR are committed by ``bench golden``."""

    @pytest.mark.parametrize(
        "name", ["og.png", "Solid_red.png"]
    )
    def test_fast_roundtrip_matches_exact(self, name):
        """The f32 production path reconstructs within one level of the
        f64 exact path on full real images.  The absolute loss is the
        reference algorithm's own (truncate-toward-zero quantization bites
        hardest on saturated solid color: MSE 358 on pure red is intrinsic,
        measured identically in exact mode)."""
        img = read_png(os.path.join(ASSETS, name))
        fast = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"))
        exact = JPEGPipeline(JPEGConfig(precision="exact", entropy="shared"))
        rec_f = fast.decode(fast.encode(img))
        rec_e = exact.decode(exact.encode(img))
        assert rec_f.shape == img.shape and rec_f.dtype == np.uint8
        assert np.abs(rec_f.astype(int) - rec_e.astype(int)).max() <= 2
        mse = float(np.mean((rec_f.astype(np.float64) - img) ** 2))
        # Measured: og 36.15 (≈32.5 dB PSNR), Solid_red 358.0 (intrinsic).
        assert mse < (400.0 if name == "Solid_red.png" else 50.0), mse
