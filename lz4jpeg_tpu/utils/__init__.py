from lz4jpeg_tpu.utils.parity import (  # noqa: F401
    quantization_tie_mask,
    assert_quantized_parity,
)
from lz4jpeg_tpu.utils.stats import trimmed_mean, median  # noqa: F401
from lz4jpeg_tpu.utils.io import (  # noqa: F401
    read_png,
    write_png,
    hex_dump,
    dump_to_hex_file,
    binary_string,
    EncodingLog,
    clear_files,
    write_text_rendering,
)
from lz4jpeg_tpu.utils.inputs import (  # noqa: F401
    extract_random_passage,
    generate_noise_image,
    generate_photo_image,
    generate_text_corpus,
)
from lz4jpeg_tpu.utils.metrics import mse, mse_rgb, psnr  # noqa: F401
from lz4jpeg_tpu.utils.profiling import fenced, time_device, trace  # noqa: F401
