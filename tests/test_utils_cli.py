"""Utils (I/O, metrics, visualization) and the CLI surface."""

import json
import os

import numpy as np
import pytest

from lz4jpeg_tpu.cli import main as cli_main
from lz4jpeg_tpu.formats.jpeg_container import (
    is_jpeg_container,
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu.utils.io import (
    binary_string,
    dump_to_hex_file,
    hex_dump,
    read_png,
    write_png,
    write_text_rendering,
)
from lz4jpeg_tpu.utils.inputs import extract_random_passage, generate_noise_image
from lz4jpeg_tpu.utils.metrics import mse, mse_rgb, psnr
from lz4jpeg_tpu.utils.visualize import (
    b_chrominance_image,
    luminance_image,
    r_chrominance_image,
)


class TestIO:
    def test_hex_dump_matches_reference_format(self):
        # "%02X " per byte (LZ4.c:100-103), trailing space included.
        assert hex_dump(b"\x02\x0d\x40") == "02 0D 40 "

    def test_dump_to_hex_file(self, tmp_path, golden_compressed):
        src = tmp_path / "c.bin"
        src.write_bytes(golden_compressed)
        out = tmp_path / "compressed.txt"
        dump_to_hex_file(str(src), str(out))
        assert out.read_text().startswith("02 0D 40 01 F1 2C 00 17 ")

    def test_binary_string(self):
        assert binary_string(0xF1) == "11110001"

    def test_png_roundtrip(self, tmp_path, rng):
        img = generate_noise_image(16, 24, rng)
        p = tmp_path / "x.png"
        write_png(str(p), img)
        np.testing.assert_array_equal(read_png(str(p)), img)

    def test_text_rendering(self, tmp_path):
        p = tmp_path / "out.txt"
        write_text_rendering(str(p), b"ab\x00c\xff")
        assert p.read_bytes() == b"ab0x00c0xFF"


class TestInputs:
    def test_passage_is_printable(self, text_corpus, rng):
        text = extract_random_passage(text_corpus, 5000, rng)
        assert len(text) == 5000
        assert b"\n" not in text and b"\r" not in text

    def test_passage_too_long_rejected(self, text_corpus, rng):
        with pytest.raises(ValueError):
            extract_random_passage(text_corpus, 10**9, rng)

    @pytest.mark.parametrize("size", [1, 4096, 120_000])
    def test_text_corpus_is_seeded_prose(self, size):
        import zlib

        from lz4jpeg_tpu.utils.inputs import generate_text_corpus

        text = generate_text_corpus(size, seed=3)
        assert len(text) == size
        assert text == generate_text_corpus(size, seed=3)
        assert all(32 <= c < 127 or c == 10 for c in text)
        if size >= 4096:
            assert text != generate_text_corpus(size, seed=4)
            # Compressible like prose, not like noise.
            assert len(zlib.compress(text)) < 0.5 * size

    def test_photo_image_is_seeded_and_structured(self):
        from lz4jpeg_tpu.utils.inputs import generate_photo_image

        a = generate_photo_image(48, 64, np.random.default_rng(5))
        b = generate_photo_image(48, 64, np.random.default_rng(5))
        assert a.shape == (48, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        # Smooth: neighbouring pixels are far closer than in noise.
        step = np.abs(np.diff(a.astype(np.int32), axis=1)).mean()
        assert step < 20


class TestMetrics:
    def test_mse_zero_on_identical(self, rng):
        img = generate_noise_image(8, 8, rng)
        assert mse_rgb(img, img) == 0.0
        assert psnr(img, img) == float("inf")

    def test_reference_mse_uses_red_channel(self):
        plane = np.full((4, 4), 100, np.uint8)
        rec = np.zeros((4, 4, 3), np.uint8)
        rec[..., 0] = 90
        assert mse(plane, rec) == 100.0


class TestVisualize:
    def test_luminance_is_gray(self, rng):
        y = rng.integers(0, 256, size=(4, 4), dtype=np.uint8)
        img = luminance_image(y)
        np.testing.assert_array_equal(img[..., 0], y)
        np.testing.assert_array_equal(img[..., 1], y)

    def test_chroma_neutral_at_128(self):
        v = np.full((2, 2), 128, np.uint8)
        np.testing.assert_array_equal(r_chrominance_image(v), 128)
        np.testing.assert_array_equal(b_chrominance_image(v), 128)


class TestJPEGContainer:
    def test_roundtrip(self, rng):
        from lz4jpeg_tpu.config import JPEGConfig
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        pipeline = JPEGPipeline(JPEGConfig(precision="exact", entropy="shared"))
        img = generate_noise_image(16, 16, rng)
        enc = pipeline.encode(img)
        blob = pack_container(enc)
        assert is_jpeg_container(blob)
        dec = unpack_container(blob)
        assert (dec.height, dec.width) == (16, 16)
        for c in ("lum", "r", "b"):
            # The container may restore a different transfer layout
            # (sparse16 with native, packed16/pairs fallbacks); compare
            # through the decoded zigzag VALUES — the canonical content.
            from lz4jpeg_tpu.ops.rle import (
                rle_decode_batched,
                rle_decode_packed16,
                rle_decode_sparse16,
            )

            def canon(e, c=c):
                arr = np.asarray(e.rle[c])
                if e.rle_sparse16:
                    return np.asarray(rle_decode_sparse16(arr))
                k = arr.shape[1] if e.rle_packed16 else arr.shape[1] // 2
                fn = (
                    rle_decode_packed16 if e.rle_packed16 else rle_decode_batched
                )
                return np.asarray(fn(arr, np.asarray(e.rle_lengths[c]), k))

            np.testing.assert_array_equal(canon(dec), canon(enc))
            np.testing.assert_array_equal(dec.rle_lengths[c], enc.rle_lengths[c])
        np.testing.assert_array_equal(
            pipeline.decode(dec), pipeline.decode(enc)
        )

    def test_per_block_not_serializable(self, rng):
        from lz4jpeg_tpu.config import JPEGConfig
        from lz4jpeg_tpu.models.jpeg import JPEGPipeline

        pipeline = JPEGPipeline(
            JPEGConfig(precision="exact", entropy="per_block")
        )
        enc = pipeline.encode(generate_noise_image(8, 8, rng))
        with pytest.raises(ValueError):
            pack_container(enc)


class TestCLI:
    def test_lz4_roundtrip_files(self, tmp_path, golden_input):
        src = tmp_path / "in.txt"
        src.write_bytes(golden_input)
        comp = tmp_path / "out.bin"
        hexf = tmp_path / "compressed.txt"
        rc = cli_main(
            ["lz4", "encode", str(src), str(comp), "--mode", "parity",
             "--hexdump", str(hexf)]
        )
        assert rc == 0 and hexf.exists()
        dec = tmp_path / "dec.txt"
        assert cli_main(["lz4", "decode", str(comp), str(dec)]) == 0
        assert dec.read_bytes() == golden_input

    def test_lz4_encode_writes_log(self, tmp_path, golden_input):
        """The reference opens encoding_log.txt on every encode
        (LZ4.c:24,683); --log wires the same record through EncodingLog."""
        src = tmp_path / "in.txt"
        src.write_bytes(golden_input)
        comp = tmp_path / "out.bin"
        logf = tmp_path / "encoding_log.txt"
        rc = cli_main(
            ["lz4", "encode", str(src), str(comp), "--mode", "parity",
             "--log", str(logf)]
        )
        assert rc == 0
        text = logf.read_text()
        assert "encode mode=parity in=350B" in text
        assert "parity frame:" in text and "seq 0:" in text
        # Append semantics: a second encode adds a second record.
        cli_main(
            ["lz4", "encode", str(src), str(comp), "--mode", "parity",
             "--log", str(logf)]
        )
        assert logf.read_text().count("encode mode=parity") == 2

    def test_jpeg_encode_decode_files(self, tmp_path, rng):
        src = tmp_path / "in.png"
        write_png(str(src), generate_noise_image(16, 16, rng))
        cont = tmp_path / "img.tjpg"
        assert cli_main(["jpeg", "encode", str(src), str(cont)]) == 0
        out = tmp_path / "out.png"
        assert cli_main(["jpeg", "decode", str(cont), str(out)]) == 0
        assert read_png(str(out)).shape == (16, 16, 3)

    def test_jpeg_roundtrip_with_viz_and_mse(self, tmp_path, rng, capsys):
        src = tmp_path / "in.png"
        write_png(str(src), generate_noise_image(16, 16, rng))
        out = tmp_path / "rec.png"
        viz = tmp_path / "viz"
        rc = cli_main(
            ["jpeg", "roundtrip", str(src), str(out), "--visualize",
             str(viz), "--mse"]
        )
        assert rc == 0
        assert (viz / "luminance.png").exists()
        assert (viz / "rChrominance.png").exists()
        assert "PSNR" in capsys.readouterr().out

    def test_lzw_files(self, tmp_path):
        src = tmp_path / "in.txt"
        src.write_bytes(b"to be or not to be")
        enc = tmp_path / "out.lzw"
        assert cli_main(["lzw", "encode", str(src), str(enc)]) == 0
        dec = tmp_path / "dec.txt"
        assert cli_main(["lzw", "decode", str(enc), str(dec)]) == 0
        assert dec.read_bytes() == b"to be or not to be"


class TestExperiments:
    def test_lz4_sweep_writes_reference_schema(self, tmp_path):
        from lz4jpeg_tpu.bench.experiments import run_lz4_experiment

        out = tmp_path / "r.json"
        results = run_lz4_experiment(
            sizes=[350, 500], runs=3, output=str(out)
        )
        assert len(results) == 2
        payload = json.loads(out.read_text())
        assert payload[0]["text"] == 350
        assert len(payload[0]["execution_times"]) == 3
        assert payload[0]["mean"] > 0

    def test_jpeg_sweep(self, tmp_path):
        from lz4jpeg_tpu.bench.experiments import run_jpeg_experiment

        out = tmp_path / "j.json"
        results = run_jpeg_experiment(sizes=[8, 16], runs=2, output=str(out))
        assert len(results) == 2
        payload = json.loads(out.read_text())
        assert payload[1]["image_size"] == 16

    def test_jpeg_inverse_device_sweep(self, tmp_path):
        from lz4jpeg_tpu.bench.experiments import (
            run_jpeg_inverse_device_experiment,
        )

        out = tmp_path / "inv.json"
        results = run_jpeg_inverse_device_experiment(
            sizes=[32], runs=2, output=str(out)
        )
        assert len(results) == 1
        payload = json.loads(out.read_text())
        assert payload[0]["image_size"] == 32
        assert payload[0]["throughput"] > 0


class TestProfiling:
    def test_fenced_executes(self):
        import jax.numpy as jnp

        from lz4jpeg_tpu.utils.profiling import fenced

        f = fenced(lambda x: {"a": x * 2, "b": x + 1})
        out = f(jnp.ones((4, 4)))
        assert float(out["a"].sum()) == 32.0
        assert float(out["b"].sum()) == 32.0

    def test_time_device_returns_runs(self):
        import jax.numpy as jnp

        from lz4jpeg_tpu.utils.profiling import time_device

        times = time_device(lambda x: x @ x, jnp.ones((32, 32)), runs=3, warmup=1)
        assert len(times) == 3 and all(t > 0 for t in times)


class TestDevicePeaks:
    def test_h200_peaks(self):
        from lz4jpeg_tpu.bench.roofline import device_peaks

        peaks = device_peaks("NVIDIA H200")
        assert peaks["hbm_gbs"] == 4800.0 and peaks["fp32_tflops"] == 67.0

    def test_unknown_device_kind_raises(self):
        from lz4jpeg_tpu.bench.roofline import device_peaks

        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks("cpu")


class TestCompileCache:
    @pytest.mark.parametrize("env", ["/some/cache", None])
    def test_cache_dir_follows_env(self, monkeypatch, env):
        import jax

        from lz4jpeg_tpu.utils import compile_cache

        if env is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            expected = os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
            expected = env
        before = jax.config.jax_compilation_cache_dir
        try:
            assert compile_cache.enable_compile_cache() == expected
            assert jax.config.jax_compilation_cache_dir == expected
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_is_inside_the_checkout(self):
        from lz4jpeg_tpu.utils import compile_cache

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert compile_cache.CHECKOUT == root
        assert os.path.isdir(os.path.join(root, "lz4jpeg_tpu"))


class TestScaling:
    def test_sweep_runs_on_cpu_mesh(self, tmp_path):
        import json

        from lz4jpeg_tpu.bench.scaling import jpeg_scaling_sweep

        out = tmp_path / "scaling.json"
        results = jpeg_scaling_sweep(
            image_size=64, mesh_sizes=[1, 2], runs=2, output=str(out)
        )
        assert [r["devices"] for r in results] == [1, 2]
        assert results[0]["speedup"] == 1.0
        assert all(r["mean_s"] > 0 for r in results)
        payload = json.loads(out.read_text())
        assert payload["image_size"] == 64
        assert [e["devices"] for e in payload["entries"]] == [1, 2]


class TestEntropyAB:
    def test_ab_runs_and_paths_agree(self, tmp_path):
        """The A/B harness must produce bit-identical
        streams from both placements and write a decision artifact."""
        import json

        pytest.importorskip("lz4jpeg_tpu.native")
        from lz4jpeg_tpu.native import native_available

        if not native_available():
            pytest.skip("native backend not built")
        from lz4jpeg_tpu.bench.entropy_ab import run_entropy_ab

        out = tmp_path / "ab.json"
        artifact = run_entropy_ab(image_size=32, runs=2, output=str(out))
        assert artifact["decision"] in ("host", "device")
        payload = json.loads(out.read_text())
        assert set(payload["channels"]) == {"lum", "r", "b"}
        for entry in payload["channels"].values():
            assert entry["packed_bytes_d2h"] <= entry["pairs_bytes_d2h"]


class TestHarnessRetry:
    def test_retries_then_succeeds(self):
        from lz4jpeg_tpu.bench.harness import run_timed

        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] % 2:
                raise RuntimeError("transient")

        r = run_timed("flaky", flaky, scale=1, runs=3, warmup=0, retries=2)
        assert len(r.times_s) == 3

    def test_exhausted_retries_raise(self):
        import pytest as _pytest

        from lz4jpeg_tpu.bench.harness import run_timed

        def always_fails():
            raise RuntimeError("permanent")

        with _pytest.raises(RuntimeError):
            run_timed("bad", always_fails, scale=1, runs=1, warmup=0, retries=1)


class TestInspect:
    def test_parity_frame_details(self, golden_compressed, capsys, tmp_path):
        src = tmp_path / "c.bin"
        src.write_bytes(golden_compressed)
        assert cli_main(["lz4", "inspect", str(src)]) == 0
        out = capsys.readouterr().out
        assert "parity frame: 2 block(s)" in out
        assert "token=0xF1" in out  # first golden sequence

    def test_fast_frame_details(self, text_corpus, capsys, tmp_path):
        from lz4jpeg_tpu.formats.fast_frame import encode_fast

        src = tmp_path / "m.lz4t"
        src.write_bytes(encode_fast(text_corpus))
        assert cli_main(["lz4", "inspect", str(src)]) == 0
        out = capsys.readouterr().out
        assert "LZ4T frame v1" in out and "compressed," in out


class TestChromaReconstruction:
    def test_matches_reference_loop_semantics(self, rng):
        """Oracle: the C loop of reconstruct_chrominance_matrix
        (JPEG.c:640-691), including the odd-width zero column and ragged
        bottom rows."""
        from lz4jpeg_tpu.utils.visualize import reconstruct_chrominance_matrix

        for h, w in ((16, 16), (13, 11), (8, 9), (5, 17)):
            bpc, bpr = -(-h // 8), -(-w // 8)
            tiles = rng.integers(0, 256, size=(bpc * bpr, 8, 4)).astype(
                np.uint8
            )
            ref = np.zeros((h, w), np.uint8)
            bi = 0
            for br in range(bpc):
                for bc in range(bpr):
                    blk = tiles[bi]
                    bi += 1
                    for lr in range(8):
                        gr = br * 8 + lr
                        if gr >= h:
                            break
                        for lc in range(4):
                            gc = bc * 8 + lc * 2
                            if gc + 1 >= w:
                                break
                            ref[gr, gc] = blk[lr, lc]
                            ref[gr, gc + 1] = blk[lr, lc]
            got = reconstruct_chrominance_matrix(tiles, bpc, bpr, h, w)
            np.testing.assert_array_equal(ref, got)
