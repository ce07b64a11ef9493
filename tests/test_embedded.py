"""Embedded fixed-point encoder tests (scaled_dct stream cross-impl).

The analog of the reference's cross-implementation conformance
trick (tests/cbenchmark.py: C encoder subprocess -> Python decoder): our
fixed-point C encoder's streams must decode correctly through our decoder
AND through the reference's Python decoder.
"""

import subprocess

import numpy as np
import pytest

from tests.conftest import needs_reference, synthetic_image
from tinyimgcodec_tpu import container, metrics, native
from tinyimgcodec_tpu.constants import FLAG_SCALED_DCT

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C compiler available"
)

# thresholds for the noisy synthetic test image (Lenna-based absolute
# parity with the reference C encoder -- 40.45/38.33/36.45/34.60 dB,
# SURVEY 2.5-11 -- is covered by test_embedded_lenna_psnr)
EXPECTED_MIN_PSNR = {0: 35.5, 1: 34.0, 2: 32.5, 3: 31.5}


@pytest.mark.parametrize("qfactor", [0, 1, 2, 3])
def test_embedded_roundtrip_psnr(qfactor):
    img = synthetic_image(128, 128, seed=50)
    data = native.embedded_encode(img, qfactor)
    h, w, q, flag = container.parse_header(data)
    assert (h, w, q) == (128, 128, qfactor)
    assert flag & FLAG_SCALED_DCT
    out = container.decompress(data)
    assert out.shape == img.shape
    assert metrics.psnr(img, out) > EXPECTED_MIN_PSNR[qfactor]


@needs_reference
def test_embedded_lenna_psnr(lenna):
    data = native.embedded_encode(lenna, 2)
    out = container.decompress(data)
    # reference C encoder scores 36.45 dB at med on Lenna
    assert metrics.psnr(lenna, out) > 35.5


@needs_reference
def test_embedded_compression_ratio(lenna):
    # reference C encoder CRs on Lenna: 3.26 / 5.13 / 8.10 / 12.99
    for qf, min_cr in [(0, 2.5), (1, 4.0), (2, 6.5), (3, 10.0)]:
        data = native.embedded_encode(lenna, qf)
        assert metrics.compression_ratio(lenna, data) > min_cr


# Reference C encoder's published Lenna numbers (result_c.png bars,
# verified by execution -- SURVEY 2.5-11 / BASELINE.md).
_REF_C_CR = {0: 3.26, 1: 5.13, 2: 8.10, 3: 12.99}
_REF_C_PSNR = {0: 40.45, 1: 38.33, 2: 36.45, 3: 34.60}


@needs_reference
@pytest.mark.parametrize("qfactor", [0, 1, 2, 3])
def test_embedded_rd_parity_vs_reference_published(lenna, qfactor):
    """Quantified rate/distortion parity vs the reference C binary.

    Our embedded quantizer deliberately rounds with half of the
    EFFECTIVE divisor where the reference always uses QUANT>>1
    (SURVEY quirk 2.5-12; decision record in native/embedded.c).  The
    measured consequence -- pinned here, not hidden behind loose
    thresholds -- is up to ~25% lower CR at qfactor>0, repaid with up
    to ~+1.3 dB PSNR; qfactor=0 matches the reference almost exactly.
    """
    data = native.embedded_encode(lenna, qfactor)
    cr = metrics.compression_ratio(lenna, data)
    psnr = metrics.psnr(lenna, container.decompress(data))
    cr_ratio = cr / _REF_C_CR[qfactor]
    psnr_delta = psnr - _REF_C_PSNR[qfactor]
    if qfactor == 0:
        assert 0.95 < cr_ratio < 1.05
        assert abs(psnr_delta) < 0.2
    else:
        assert 0.75 < cr_ratio < 1.05   # the rounding trade's rate cost
        assert -0.2 < psnr_delta < 1.6  # repaid in fidelity, never worse


# The same measurements on the in-repo golden image (corpus.golden_image),
# taken with this encoder and the host decoder.
_GOLDEN_CR = {0: 2.894, 1: 4.194, 2: 6.262, 3: 9.774}
_GOLDEN_PSNR = {0: 36.340, 1: 34.495, 2: 33.354, 3: 32.393}


def test_embedded_golden_psnr(golden):
    data = native.embedded_encode(golden, 2)
    out = container.decompress(data)
    assert metrics.psnr(golden, out) > 33.3


def test_embedded_golden_compression_ratio(golden):
    for qf, min_cr in [(0, 2.85), (1, 4.15), (2, 6.2), (3, 9.7)]:
        data = native.embedded_encode(golden, qf)
        assert metrics.compression_ratio(golden, data) > min_cr


@pytest.mark.parametrize("qfactor", [0, 1, 2, 3])
def test_embedded_rd_golden(golden, qfactor):
    """Rate/distortion of each qfactor on the golden image, pinned to
    the measured values: the encoder is deterministic, so any drift is
    a change of its quantizer or entropy coder."""
    data = native.embedded_encode(golden, qfactor)
    cr = metrics.compression_ratio(golden, data)
    psnr = metrics.psnr(golden, container.decompress(data))
    assert abs(cr - _GOLDEN_CR[qfactor]) < 1e-3
    assert abs(psnr - _GOLDEN_PSNR[qfactor]) < 1e-3


def test_embedded_cli_pipe(lenna):
    """Streaming CLI: raw pixels on stdin -> bitstream on stdout."""
    cli = native.embedded_cli_path()
    assert cli is not None
    img = lenna[:64, :64]
    proc = subprocess.run(
        [cli, "64", "64", "2"],
        input=img.tobytes(),
        capture_output=True,
        timeout=60,
    )
    assert proc.returncode == 0
    lib_out = native.embedded_encode(img, 2)
    assert proc.stdout == lib_out


def test_embedded_rejects_bad_dims():
    with pytest.raises(ValueError):
        native.embedded_encode(np.zeros((60, 64), np.uint8), 2)


@needs_reference
def test_embedded_stream_decodes_with_reference_decoder(lenna):
    from tests.ref_shim import import_reference

    ref = import_reference()
    img = lenna[:128, :128]
    data = native.embedded_encode(img, 2)
    theirs = ref.decompress(data)
    ours = container.decompress(data)
    assert np.array_equal(theirs, ours)
    assert metrics.psnr(img, ours) > 34.0


@needs_reference
def test_reference_c_stream_decodes_with_our_decoder(lenna):
    """Compile the *reference's* C encoder and decode its stream with OUR
    decoder -- direct bitstream-contract conformance both ways."""
    import os
    import tempfile

    src_dir = "/root/reference/c"
    if not os.path.isdir(src_dir):
        pytest.skip("reference c/ not present")
    with tempfile.TemporaryDirectory() as td:
        binary = os.path.join(td, "ref_encode")
        r = subprocess.run(
            ["cc", "-O2", "-o", binary,
             os.path.join(src_dir, "encode.c"),
             os.path.join(src_dir, "img.c"),
             os.path.join(src_dir, "fifo.c")],
            capture_output=True,
        )
        if r.returncode != 0:
            pytest.skip("reference C encoder does not build here")
        img = lenna[:128, :128]
        proc = subprocess.run(
            [binary, "128", "128", "med"],
            input=img.tobytes(),
            capture_output=True,
            timeout=60,
        )
        assert proc.returncode == 0
        out = container.decompress(proc.stdout)
        assert out.shape == img.shape
        assert metrics.psnr(img, out) > 33.0


def test_embedded_stream_device_decode(lenna):
    """scaled_dct streams decode through the device transform path too
    (engine exact mode), matching the host/golden decoder bit-for-bit."""
    from tinyimgcodec_tpu.engine import Engine

    img = lenna[:64, :64]
    data = native.embedded_encode(img, 2)
    host = container.decompress(data)
    dev = Engine().decompress(data)
    assert np.array_equal(dev, host)
