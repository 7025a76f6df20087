"""Seeded benchmark and test inputs, mirroring the reference's generators.

* ``generate_text_corpus`` — deterministic English-like text (Zipf-ranked
  pseudo-words and punctuation) standing in for the reference's text
  corpus: compressible the way prose is, and made from a seed so no run
  reads a file from outside the repository;
* ``extract_random_passage`` — a random substring of a text corpus with
  newlines replaced by spaces so every byte stays printable, which the
  parity LZ4 text path requires (``Experiment/random_extract.c:8-71``;
  the printability constraint is load-bearing, SURVEY.md §2.1.6);
* ``generate_noise_image`` — per-pixel uniform RGB noise
  (``Experiment/random_image.c:58-77``);
* ``generate_photo_image`` — a photo-like frame (smooth gradients, hard
  edges, sensor noise) for the camera-sized paths.
"""

from __future__ import annotations

import numpy as np

_SYLLABLES = (
    "a an ar as at be ca ce co de di do el en er es ga ge he hi in is it "
    "la le li lo ma me mi mo na ne no on or ou pa pe ra re ri ro sa se si "
    "so st ta te th ti to tr un ur us ve wa we wi"
).split()
# Separator tokens and their probabilities after each word.
_SEPARATORS = (b" ", b", ", b". ", b"\n")
_SEPARATOR_P = (0.86, 0.07, 0.045, 0.025)


def generate_text_corpus(
    size: int, seed: int = 0, vocab: int = 4096, zipf_s: float = 1.1
) -> bytes:
    """``size`` bytes of seeded pseudo-prose.

    A vocabulary of ``vocab`` pseudo-words (1-4 syllables) is drawn once
    from the seed; words then follow a Zipf law of exponent ``zipf_s`` over
    their rank, each followed by a space, comma, full stop or newline.
    Vectorized end to end, so tens of MiB take about a second."""
    rng = np.random.default_rng(seed)
    n_syl = rng.integers(1, 5, size=vocab)
    syl = rng.integers(0, len(_SYLLABLES), size=int(n_syl.sum()))
    ends = np.cumsum(n_syl)
    words = [
        "".join(_SYLLABLES[j] for j in syl[e - k : e]).encode()
        for e, k in zip(ends, n_syl)
    ]
    table = words + list(_SEPARATORS)
    lens = np.fromiter((len(t) for t in table), np.int64, len(table))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.frombuffer(b"".join(table), np.uint8)

    rank_p = 1.0 / np.arange(1, vocab + 1) ** zipf_s
    mean_token = float(
        (rank_p / rank_p.sum()) @ lens[:vocab]
        + np.dot(_SEPARATOR_P, lens[vocab:])
    )
    n_words = int(size / mean_token * 1.05) + 16
    tokens = np.empty(2 * n_words, np.int64)
    tokens[0::2] = rng.choice(vocab, size=n_words, p=rank_p / rank_p.sum())
    tokens[1::2] = vocab + rng.choice(
        len(_SEPARATORS), size=n_words, p=_SEPARATOR_P
    )
    tok_lens = lens[tokens]
    total = int(tok_lens.sum())
    out_start = np.cumsum(tok_lens) - tok_lens
    src = np.repeat(starts[tokens] - out_start, tok_lens) + np.arange(total)
    text = flat[src].tobytes()
    while len(text) < size:  # the 5% margin makes this rare
        text += generate_text_corpus(size - len(text), seed + 1, vocab, zipf_s)
    return text[:size]


def extract_random_passage(
    corpus: bytes, length: int, rng: np.random.Generator
) -> bytes:
    if length > len(corpus):
        raise ValueError(f"passage of {length} exceeds corpus ({len(corpus)})")
    start = int(rng.integers(0, len(corpus) - length + 1))
    passage = corpus[start : start + length]
    return passage.replace(b"\r", b" ").replace(b"\n", b" ")


def generate_noise_image(
    height: int, width: int, rng: np.random.Generator
) -> np.ndarray:
    return rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)


def generate_photo_image(
    height: int, width: int, rng: np.random.Generator
) -> np.ndarray:
    """(H, W, 3) uint8 frame with the structure of a photograph: a smooth
    two-axis colour gradient, a few flat-shaded rectangles and discs with
    hard edges, and mild Gaussian sensor noise."""
    yy = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :, None]
    c0, cx, cy = (rng.uniform(0, 255, 3).astype(np.float32) for _ in range(3))
    img = c0 * (1 - 0.5 * xx - 0.5 * yy) + cx * 0.5 * xx + cy * 0.5 * yy
    img = np.broadcast_to(img, (height, width, 3)).copy()
    for _ in range(12):
        y0, x0 = rng.integers(0, height), rng.integers(0, width)
        h, w = rng.integers(height // 16, height // 3), rng.integers(
            width // 16, width // 3
        )
        img[y0 : y0 + h, x0 : x0 + w] = rng.uniform(0, 255, 3)
    ys = np.arange(height, dtype=np.float32)[:, None]
    xs = np.arange(width, dtype=np.float32)[None, :]
    for _ in range(6):
        cy_, cx_ = rng.uniform(0, height), rng.uniform(0, width)
        r = rng.uniform(min(height, width) / 20, min(height, width) / 5)
        disc = (ys - cy_) ** 2 + (xs - cx_) ** 2 <= r * r
        img[disc] = rng.uniform(0, 255, 3)
    img += rng.normal(0.0, 3.0, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)
