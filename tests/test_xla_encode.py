"""The XLA encode path's layers, its precision and compile-cache
settings, and the GPU smoke script's behaviour off the GPU.

Layer by layer: transform (``ops/transform``), symbolize and per-block
packing (``ops/entropy``), device stitch (``entropy.stitch_words``) and
host stitch (``native.stitch``), each checked against the float64 host
oracle or the host stitcher.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests.conftest import synthetic_image
from tinyimgcodec_tpu import api, container, golden, metrics
from tinyimgcodec_tpu.bitstream import BitWriter, pack_ragged_words
from tinyimgcodec_tpu.ops import entropy, transform
from tinyimgcodec_tpu.parallel import make_mesh
from tinyimgcodec_tpu.parallel.batch import compress_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle_zz(img, quality):
    a = golden.encode_arrays(img, quality)
    dc = np.cumsum(a.dc, dtype=np.int64)
    return np.concatenate([dc[:, None], a.ac], axis=1)


# -- transform ------------------------------------------------------------

@pytest.mark.parametrize("quality", [10, 50, 90])
def test_exact_transform_matches_oracle(quality):
    """Unflagged exact-mode coefficients equal the float64 oracle's;
    flagged blocks are the ones the host fix-up recomputes."""
    img = synthetic_image(64, 64, seed=95)
    blocks = transform.blockify(img.astype(np.int32))
    zz, flags = transform.encode_blocks(
        blocks, quality, transform.EXACT, with_flags=True
    )
    zz, flags = np.asarray(zz), np.asarray(flags)
    ref = _oracle_zz(img, quality)
    assert np.array_equal(zz[~flags], ref[~flags])


def test_exact_tie_fixup():
    """Every block hits an exact rational DC tie (constant 129 => DC
    coefficient 8/16 = 0.5 at q=50): every block is flagged and the
    fix-up still yields byte-identical output."""
    img = np.full((32, 32), 129, np.uint8)
    _, flags = transform.encode_blocks(
        transform.blockify(img), 50, transform.EXACT, with_flags=True
    )
    assert np.asarray(flags).all(), "DC ties must be flagged"
    assert compress_batch(img[None], 50) == [container.compress(img, 50)]


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    return [
        eqn.params["precision"]
        for eqn in jaxpr.jaxpr.eqns
        if eqn.primitive.name == "dot_general"
    ]


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_fast_transform_precision_highest(direction):
    """The fast transform's matmul pins Precision.HIGHEST: a default
    precision f32 dot may run in TF32 on a GPU and move coefficients."""
    highest = jax.lax.Precision.HIGHEST
    if direction == "encode":
        x = np.zeros((4, 8, 8), np.int32)
        precs = _dot_precisions(
            lambda b: transform.encode_blocks(b, 50, transform.FAST), x
        )
    else:
        x = np.zeros((4, 64), np.int32)
        precs = _dot_precisions(
            lambda z: transform.decode_blocks(z, 50, transform.FAST), x
        )
    assert precs, "no dot_general in the fast transform"
    for p in precs:
        assert p == (highest, highest)


def test_df_contract_is_unrolled():
    """Exact mode's double-float sums are straight-line code on every
    backend: no loop primitive in the traced program (loop bodies may
    be compiled with FMA contraction, which breaks the error-free
    transforms)."""
    x = np.zeros((2, 8, 8), np.int32)
    jaxpr = jax.make_jaxpr(
        lambda b: transform.encode_blocks(b, 50, transform.EXACT)
    )(x)
    names = {e.primitive.name for e in jaxpr.jaxpr.eqns}
    assert not names & {"while", "scan", "fori_loop"}
    assert "optimization_barrier" in names


@pytest.mark.parametrize("quality", [50, 90])
def test_fast_mode_rate_distortion_matches_oracle(quality):
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (81, 82)])
    out = compress_batch(imgs, quality, precision="fast")
    for img, data in zip(imgs, out):
        ref = container.compress(img, quality)
        dec = container.decompress(data)
        ref_dec = container.decompress(ref)
        # f32 may round rare ties the other way: same quality, same rate
        assert np.abs(dec.astype(int) - ref_dec.astype(int)).max() <= 2
        assert abs(len(data) - len(ref)) < 64
        assert metrics.psnr(img, dec) >= metrics.psnr(img, ref_dec) - 0.05


# -- symbolize + pack -----------------------------------------------------

def test_batch_dc_predictor_resets_per_image():
    """Each image's first block diffs against 0, not the previous
    image's last DC."""
    imgs = np.stack([np.full((16, 16), 200, np.uint8),
                     np.full((16, 16), 60, np.uint8)])
    out = compress_batch(imgs, 50)
    assert out == [container.compress(im, 50) for im in imgs]


def test_batch_matches_single_image_calls():
    imgs = np.stack([synthetic_image(48, 64, seed=s) for s in (62, 63, 64)])
    out = api.compress_batch(imgs, 50)
    assert out == [api.compress(im, 50) for im in imgs]


@pytest.mark.parametrize("quality", [50, 90])
def test_extreme_runs(quality):
    """Sparse impulses produce long zero runs (ZRL chains)."""
    rng = np.random.RandomState(7)
    img = np.full((64, 64), 128, np.uint8)
    img[rng.randint(0, 64, 30), rng.randint(0, 64, 30)] = 255
    assert compress_batch(img[None], quality) == [
        container.compress(img, quality)
    ]


# -- stitch ---------------------------------------------------------------

def _packed_rows(img, quality):
    zz = transform.encode_blocks(
        transform.blockify(img[None]), quality, transform.EXACT
    )
    dc, ac = transform.dc_dpcm(zz)
    w0, w1, bits, _ = entropy.block_symbols(dc, ac)
    words, block_bits = entropy.pack_blocks(w0, w1, bits)
    return np.asarray(words)[0], np.asarray(block_bits)[0].astype(np.int32)


@pytest.mark.parametrize("content", ["natural", "noise"])
def test_device_stitch_matches_host_stitch(content):
    """entropy.stitch_words (device) == native.stitch (C) ==
    pack_ragged_words (numpy) on the same per-block rows."""
    from tinyimgcodec_tpu import native

    if content == "natural":
        img = synthetic_image(64, 64, seed=71)
    else:
        img = np.random.RandomState(72).randint(0, 256, (64, 64))
        img = img.astype(np.uint8)
    words, bits = _packed_rows(img, 50)
    host = pack_ragged_words(words, bits)
    if native.available():
        assert native.stitch(words, bits) == host
    total = int(bits.sum())
    need = -(-total // 32)
    stream, got_total = entropy.stitch_words(words, bits, need + 8)
    assert int(got_total) == total
    dev = np.asarray(stream)[:need].astype(">u4").tobytes()
    assert dev[: len(host)] == host


def test_device_assembly_overflow_retry():
    """A capacity far below the stream takes the worst-case retry and
    still emits a complete, decodable stream."""
    img = synthetic_image(64, 64, seed=73)
    tight = compress_batch(img[None], 90, mesh=make_mesh(1),
                           assemble="device", bits_per_pixel_budget=0.01)
    roomy = compress_batch(img[None], 90, mesh=make_mesh(1),
                           assemble="device", bits_per_pixel_budget=16.0)
    assert tight == roomy
    assert container.decompress(tight[0]).shape == img.shape


def test_bitwriter_bit_length_is_running_total():
    """bit_length() stays exact across every write kind (the oracle's
    per-block TICX offsets read it once per block)."""
    w = BitWriter()
    expect = 0
    for nbits in (0, 1, 7, 13, 64):
        w.write_bits(1, nbits)
        expect += nbits
        assert w.bit_length() == expect
    w.write_int(-5)
    w.write_bytes(b"ab")
    w.extend_packed(np.array([3, 1, 0]), np.array([2, 0, 5]))
    expect += 3 + 16 + 7
    assert w.bit_length() == expect
    assert len(w.to_bytes()) == -(-expect // 8)


# -- jobs -----------------------------------------------------------------

def test_jobs_raise_engine_errors(tmp_path, monkeypatch):
    """A failing batch encode raises out of the job: nothing is
    swallowed into a silent per-image fallback."""
    from tinyimgcodec_tpu.jobs import CorpusEncodeJob

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(api, "compress_batch", boom)
    job = CorpusEncodeJob(str(tmp_path / "job"), quality=50)
    with pytest.raises(RuntimeError, match="device lost"):
        job.run({"a": synthetic_image(16, 16, seed=1)})


# -- compile cache --------------------------------------------------------

_CACHE_PROBE = (
    "import jax, json; from tinyimgcodec_tpu import xla_cache; "
    "xla_cache.ensure_cache(); "
    "print(json.dumps([jax.config.jax_compilation_cache_dir, "
    "xla_cache.CACHE_DIR]))"
)


def _probe_cache(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ensure_cache_honours_env(tmp_path):
    chosen, _ = _probe_cache(str(tmp_path / "cache"))
    assert chosen == str(tmp_path / "cache")


def test_ensure_cache_defaults_inside_checkout():
    chosen, default = _probe_cache(None)
    assert chosen == default == os.path.join(REPO, ".xla_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()


# -- chip_smoke.py --------------------------------------------------------

def test_chip_smoke_without_gpu_fails():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("script", [
    "scripts/profile_encode.py", "scripts/probe_fast_precision.py",
])
def test_gpu_scripts_without_gpu_fail(script):
    """The measurement scripts never fall back to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, script, "--batch", "1", "--size", "16"], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "MP/s" not in out.stdout


def test_chip_smoke_one_card_run_sees_one_card():
    """The default mode narrows the visible cards to the caller's first."""
    code = (
        "import os, chip_smoke\n"
        "try:\n"
        "    chip_smoke.init_gpu(multi=False)\n"
        "except chip_smoke.SmokeFailure:\n"
        "    pass\n"
        "print(os.environ['CUDA_VISIBLE_DEVICES'])\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="3,5")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "3"


def test_profile_layer_bytes_from_shapes():
    """Roofline bytes: each entropy layer's operands plus results."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import profile_encode

    nb = 10
    sym_out = 3 * nb * entropy.SLOTS * 4 + 1  # w0, w1, bits, overflow
    assert profile_encode.layer_bytes(nb) == {
        "block_symbols": nb * 64 * 4 + sym_out,
        "pack_blocks": sym_out - 1 + nb * (entropy.BLOCK_WORDS + 1) * 4,
        "symbols+pack": nb * 64 * 4 + nb * (entropy.BLOCK_WORDS + 1) * 4,
    }


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("phase", [
    "corpus_encode", "sweep", "adversarial", "auto_table", "decode",
    "multi",
])
def test_chip_smoke_phases_on_cpu(phase, capsys):
    """Each chip_smoke phase at a tiny size on the CPU backend: the
    checks pass and no rate is printed without a known card."""
    from tinyimgcodec_tpu import corpus

    cs = _smoke()
    rates = cs.Rates(None)
    images = corpus.synthetic_corpus(3, 32)
    if phase == "corpus_encode":
        cs.phase_corpus_encode(images, 50, rates)
    elif phase == "sweep":
        cs.phase_sweep(images[:2], (10, 90))
    elif phase == "adversarial":
        cs.phase_adversarial(32, (1, 99))
    elif phase == "auto_table":
        cs.phase_auto_table()
    elif phase == "decode":
        streams = {q: cs.oracle_streams(images, q)[0] for q in (50, 90)}
        cs.phase_decode(streams, rates)
    else:
        cs.run_multi(None, n=4, n_images=6, size=32, big_size=64)
    assert "MP/s" not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The full smoke script on the card (skips where there is none)."""
    try:
        probe = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                               text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        probe = None
    if probe is None or probe.returncode != 0 or "GPU" not in probe.stdout:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"ok": true' in out.stdout.strip().splitlines()[-1]
