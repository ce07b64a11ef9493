"""Test config: force a virtual 8-device CPU mesh before jax imports.

Multi-device sharding logic is exercised on N virtual CPU devices via
--xla_force_host_platform_device_count.  Tests that need the GPU carry
the ``gpu`` marker and run the card's work in a child process.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Env vars alone do not displace an already-registered accelerator plugin
# in this environment; pin the config explicitly before any computation.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_ROOT, "tinyimgcodec"))


needs_reference = pytest.mark.skipif(
    not reference_available(), reason="reference repo not mounted"
)


@pytest.fixture(scope="session")
def lenna() -> np.ndarray:
    """512x512 grayscale Lenna from the reference corpus, or the in-repo
    golden image when the reference is not mounted."""
    path = os.path.join(REFERENCE_ROOT, "data", "lenna.gif")
    if os.path.exists(path):
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))
    return golden_image()


@pytest.fixture(scope="session")
def golden() -> np.ndarray:
    """The seeded in-repo golden image (corpus.golden_image)."""
    return golden_image()


def golden_image() -> np.ndarray:
    from tinyimgcodec_tpu.corpus import golden_image as _golden

    return _golden()


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Natural-ish test image: smooth gradients + textures + edges."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (
        96.0
        + 60.0 * np.sin(2 * np.pi * x / (w / 3.0)) * np.cos(2 * np.pi * y / (h / 2.0))
        + 40.0 * ((x // 37 + y // 29) % 2)
        + rng.randn(h, w) * 6.0
    )
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def small_image() -> np.ndarray:
    return synthetic_image(64, 80, seed=3)
