"""Test-corpus loading (the reference's data/ images, with fallback).

The reference ships 49 numbered 512x512 grayscale GIFs plus lenna.gif
(data/, SURVEY T7).  When that corpus is mounted we benchmark on it for
direct comparability; otherwise a deterministic synthetic corpus with
similar statistics stands in.
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_DATA = "/root/reference/data"

# name -> corpus file mapping used by the reference's figure script
# (tests/figure.py:11-12): Lenna=lenna.gif, Babara=1.gif, Baboon=47.gif
NAMED_IMAGES = {"Lenna": "lenna.gif", "Babara": "1.gif", "Baboon": "47.gif"}


def synthetic_corpus(n: int = 49, size: int = 512) -> np.ndarray:
    """Deterministic natural-ish grayscale images, (n, size, size) uint8."""
    out = np.empty((n, size, size), np.uint8)
    y, x = np.mgrid[0:size, 0:size]
    for i in range(n):
        rng = np.random.RandomState(1000 + i)
        fx, fy = rng.uniform(1.5, 6, 2)
        img = (
            110.0
            + 70.0 * np.sin(2 * np.pi * (fx * x / size + rng.rand()))
            * np.cos(2 * np.pi * (fy * y / size + rng.rand()))
            + 30.0 * ((x // rng.randint(20, 60) + y // rng.randint(20, 60)) % 2)
            + rng.randn(size, size) * 5.0
        )
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


# The in-repo golden image's oracle numbers at quality 50, measured with
# the host float64 path (``container.compress``, no TICX trailer).
GOLDEN_Q50_BYTES = 21982
GOLDEN_Q50_PSNR = 32.345


def golden_image(size: int = 512, seed: int = 7) -> np.ndarray:
    """Seeded 512x512 grayscale stand-in for Lenna: smooth gradients, a
    checker texture with hard edges, and sensor-like noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size]
    img = (
        96.0
        + 60.0 * np.sin(2 * np.pi * x / (size / 3.0))
        * np.cos(2 * np.pi * y / (size / 2.0))
        + 40.0 * ((x // 37 + y // 29) % 2)
        + rng.randn(size, size) * 6.0
    )
    return np.clip(img, 0, 255).astype(np.uint8)


def corpus_available() -> bool:
    return os.path.isdir(REFERENCE_DATA)


def load_corpus(limit: int | None = None) -> np.ndarray:
    """(N, 512, 512) uint8: the 49 numbered corpus images (or synthetic)."""
    if not corpus_available():
        return synthetic_corpus(limit or 49)
    from PIL import Image

    n = 49 if limit is None else min(limit, 49)
    out = []
    for i in range(1, n + 1):
        path = os.path.join(REFERENCE_DATA, f"{i}.gif")
        out.append(np.asarray(Image.open(path).convert("L")))
    return np.stack(out)


def load_named(name: str) -> np.ndarray:
    if not corpus_available():
        return synthetic_corpus(1)[0]
    from PIL import Image

    path = os.path.join(REFERENCE_DATA, NAMED_IMAGES[name])
    return np.asarray(Image.open(path).convert("L"))
