"""Device transform stage: blockify -> DCT -> quantize -> zigzag -> DPCM.

Device-first design (vs the reference's scipy calls + numpy loops,
utils.py:13-53, codec.py:26-70):

- the 2-D DCT/IDCT are batched 8x8 matrix products against the orthonormal
  DCT-II basis, over a device-resident ``(num_blocks, 8, 8)`` tensor;
- two precision modes: ``"fast"`` (plain float32) and ``"exact"``
  (double-float arithmetic, :mod:`.df32`) whose quantized coefficients and
  decoded pixels match the float64 reference bit-for-bit;
- zig-zag is a static gather; DC DPCM is a shift-subtract (encode) /
  cumulative sum (decode) over the block axis -- both embarrassingly
  parallel, no per-block Python loops anywhere.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    AAN_SCALES,
    INVERSE_ZIGZAG,
    ZIGZAG_ORDER,
    quant_divisors,
)
from . import df32

FAST = "fast"
EXACT = "exact"

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.cache
def dct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis D (float64): coeffs = D @ x."""
    k = np.arange(8)[:, None].astype(np.float64)
    j = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2 * j + 1) * k * np.pi / 16.0)
    d[0, :] = 1.0 / (2.0 * math.sqrt(2.0))
    return d


@functools.cache
def _basis_df() -> tuple[np.ndarray, np.ndarray]:
    return df32.split_hi_lo(dct_basis())


def pad_to_blocks(image: np.ndarray) -> np.ndarray:
    """Host-side reflect pad to multiples of 8 (reference utils.py:56-61)."""
    h, w = image.shape[-2:]
    ph = -h % 8
    pw = -w % 8
    if ph or pw:
        pad = [(0, 0)] * (image.ndim - 2) + [(0, ph), (0, pw)]
        image = np.pad(image, pad, mode="reflect")
    return image


def blockify(image: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (..., H/8 * W/8, 8, 8) in raster block order."""
    *lead, h, w = image.shape
    x = image.reshape(*lead, h // 8, 8, w // 8, 8)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def unblockify(blocks: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, h, w)


@functools.cache
def _fast_encode_matrix(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """Fused (64, 64) matrix: pixels -> quantized zig-zag coefficients.

    One matmul does DCT + 1/divisor scaling + zig-zag: column
    k is the zig-zag-k DCT basis vector over the 64 pixel positions,
    pre-divided by its quantization divisor.  The level shift folds into
    a per-column offset (only the DC column has a nonzero basis sum).
    """
    d = dct_basis()
    kron = np.einsum("ui,vj->ijuv", d, d).reshape(64, 64)  # [pixel, coeff]
    recip = (1.0 / quant_divisors(quality)).reshape(64)
    m = kron * recip[None, :]
    m = m[:, ZIGZAG_ORDER]
    offset = 128.0 * m.sum(axis=0)
    # only the DC column has a nonzero basis sum; snap float summation
    # noise on the others to an exact zero
    offset[np.abs(offset) < 1e-6] = 0.0
    return m.astype(np.float32), offset.astype(np.float32)


@functools.cache
def _fast_decode_matrix(quality: int, scaled_dct: bool) -> np.ndarray:
    """Fused (64, 64) matrix: zig-zag coefficients -> pixel values - 128."""
    d = dct_basis()
    kron = np.einsum("ui,vj->ijuv", d, d).reshape(64, 64)  # [pixel, coeff]
    mult = dequant_multipliers(quality, scaled_dct).reshape(64)
    m = (kron * mult[None, :])[:, ZIGZAG_ORDER]  # [pixel, zigzag coeff]
    return m.T.astype(np.float32)  # [zigzag coeff, pixel]


def _df_contract(get_term, n: int = 8):
    """Sum n double-float terms: get_term(k) -> (th, tl) df arrays.

    Unrolled straight-line code on every backend.  XLA may contract
    multiply-add into FMA inside loop bodies, which destroys the
    error-free transforms (on the CPU the two_prod error term comes
    back zero inside a ``fori_loop`` body, even through optimization
    barriers); the unrolled form is byte-exact against the float64
    oracle on the CPU and on the GPU.
    """
    acc_h, acc_l = get_term(0)
    for k in range(1, n):
        th, tl = get_term(k)
        acc_h, acc_l = df32.df_add(acc_h, acc_l, th, tl)
    return acc_h, acc_l


def _dct2_df(blocks_f32: jnp.ndarray):
    """Double-float 2-D DCT: C = D X D^T with X exact float32."""
    dh, dl = _basis_df()
    dh = jnp.asarray(dh)
    dl = jnp.asarray(dl)

    # stage 1: Y[u, j] = sum_i D[u, i] X[i, j]  (X exact -> two_prod)
    def term1(i):
        x = jnp.take(blocks_f32, i, axis=-2)[..., None, :]  # (...,1,8)
        mh = jnp.take(dh, i, axis=1)[:, None]               # (8,1)
        ml = jnp.take(dl, i, axis=1)[:, None]
        ph, pe = df32.two_prod(x, mh)
        pe = pe + x * ml
        return df32.quick_two_sum(ph, pe)

    y_h, y_l = _df_contract(term1)

    # stage 2: C[u, v] = sum_j Y[u, j] D[v, j]
    def term2(j):
        xh = jnp.take(y_h, j, axis=-1)[..., :, None]
        xl = jnp.take(y_l, j, axis=-1)[..., :, None]
        mh = jnp.take(dh, j, axis=1)[None, :]
        ml = jnp.take(dl, j, axis=1)[None, :]
        return df32.df_mul(xh, xl, mh, ml)

    return _df_contract(term2)


def _idct2_df(cd_h: jnp.ndarray, cd_l: jnp.ndarray):
    """Double-float 2-D IDCT: X = D^T C D."""
    dh, dl = _basis_df()
    dh = jnp.asarray(dh)
    dl = jnp.asarray(dl)

    # stage 1: Y[i, v] = sum_u D[u, i] C[u, v]
    def term1(u):
        ch = jnp.take(cd_h, u, axis=-2)[..., None, :]
        cl = jnp.take(cd_l, u, axis=-2)[..., None, :]
        mh = jnp.take(dh, u, axis=0)[:, None]  # D[u, :] as column over i
        ml = jnp.take(dl, u, axis=0)[:, None]
        return df32.df_mul(ch, cl, mh, ml)

    y_h, y_l = _df_contract(term1)

    # stage 2: X[i, j] = sum_v Y[i, v] D[v, j]
    def term2(v):
        yh = jnp.take(y_h, v, axis=-1)[..., :, None]
        yl = jnp.take(y_l, v, axis=-1)[..., :, None]
        mh = jnp.take(dh, v, axis=0)[None, :]
        ml = jnp.take(dl, v, axis=0)[None, :]
        return df32.df_mul(yh, yl, mh, ml)

    return _df_contract(term2)


# ---------------------------------------------------------------------------
# Encode / decode transforms
# ---------------------------------------------------------------------------

def encode_blocks(
    blocks: jnp.ndarray,
    quality: int,
    precision: str = EXACT,
    with_flags: bool = False,
):
    """(..., nb, 8, 8) uint8/int pixels -> (..., nb, 64) int32 zig-zag
    quantized coefficients (DC at index 0, not yet DPCM'd).

    with_flags=True additionally returns a per-block bool marking blocks
    whose rounding decision is too close to a boundary for double-float
    arithmetic to certify against the float64 reference (host fixup).
    """
    if precision == FAST:
        # fused single matmul: DCT + quant scaling + zigzag.  Precision
        # is pinned: on an H100 a default-precision f32 dot runs in TF32
        # (10 mantissa bits), which moves quantized coefficients.
        m, offset = _fast_encode_matrix(quality)
        x = blocks.astype(jnp.float32).reshape(*blocks.shape[:-2], 64)
        y = jnp.matmul(x, jnp.asarray(m), precision=_HIGHEST)
        q = jnp.round(y - jnp.asarray(offset))
        zz = q.astype(jnp.int32)
        flags = jnp.zeros(blocks.shape[:-2], dtype=bool)
        if with_flags:
            return zz, flags
        return zz
    x = blocks.astype(jnp.float32) - 128.0  # level shift, exact in f32
    recip = 1.0 / quant_divisors(quality)   # float64 host constants
    c_h, c_l = _dct2_df(x)
    rh, rl = df32.split_hi_lo(recip)
    q_h, q_l = df32.df_mul(c_h, c_l, jnp.asarray(rh), jnp.asarray(rl))
    q, uncertain = df32.df_round_half_even(q_h, q_l)
    flags = jnp.any(uncertain, axis=(-2, -1))
    zz = q.astype(jnp.int32).reshape(*blocks.shape[:-2], 64)
    zz = jnp.take(zz, jnp.asarray(ZIGZAG_ORDER), axis=-1)
    if with_flags:
        return zz, flags
    return zz


def dc_dpcm(zz: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split (..., nb, 64) into DPCM'd DC (..., nb) and AC (..., nb, 63).

    Raster-order DPCM over the block axis (reference codec.py:34-35);
    the first block keeps its raw DC.
    """
    dc = zz[..., 0]
    prev = jnp.concatenate(
        [jnp.zeros_like(dc[..., :1]), dc[..., :-1]], axis=-1
    )
    return dc - prev, zz[..., 1:]


def dequant_multipliers(quality: int, scaled_dct: bool = False) -> np.ndarray:
    """Per-position float64 dequantization multiplier (8, 8).

    Normal streams: the quantization divisors.  scaled_dct streams (from
    the embedded fixed-point encoder): quality holds the qfactor shift and
    coefficients carry AAN scaling, so the combined multiplier is
    div50 * 2**qfactor / AAN (reference codec.py:59-62).
    """
    if scaled_dct:
        return quant_divisors(50) * float(2 ** quality) / AAN_SCALES
    return quant_divisors(quality)


def decode_blocks(
    zz: jnp.ndarray,
    quality: int,
    precision: str = EXACT,
    scaled_dct: bool = False,
    with_flags: bool = False,
):
    """(..., nb, 64) int32 zig-zag coefficients (DC already un-DPCM'd) ->
    (..., nb, 8, 8) uint8 pixel blocks (+ per-block uncertainty flags
    when with_flags=True; see encode_blocks)."""
    if precision == FAST:
        m = _fast_decode_matrix(quality, scaled_dct)
        x = jnp.matmul(
            zz.astype(jnp.float32), jnp.asarray(m), precision=_HIGHEST
        )
        pix = jnp.floor(jnp.clip(x + 128.0, 0.0, 255.0))
        pix = pix.reshape(*zz.shape[:-1], 8, 8)
        flags = jnp.zeros(zz.shape[:-1], dtype=bool)
        out = pix.astype(jnp.uint8)
        if with_flags:
            return out, flags
        return out
    coeffs = jnp.take(zz, jnp.asarray(INVERSE_ZIGZAG), axis=-1)
    coeffs = coeffs.reshape(*zz.shape[:-1], 8, 8)
    mult = dequant_multipliers(quality, scaled_dct)
    c = coeffs.astype(jnp.float32)  # exact (|coeff| << 2**24)
    mh, ml = df32.split_hi_lo(mult)
    dq_h, dq_e = df32.two_prod(c, jnp.asarray(mh))
    dq_e = dq_e + c * jnp.asarray(ml)
    dq_h, dq_l = df32.quick_two_sum(dq_h, dq_e)
    x_h, x_l = _idct2_df(dq_h, dq_l)
    x_h, x_l = df32.df_add_float(x_h, x_l, 128.0)
    pix, uncertain = df32.df_floor(x_h, x_l)
    # boundary uncertainty only matters where the clip to [0, 255]
    # doesn't absorb it (x_h is the +128-shifted pixel value)
    uncertain = uncertain & (x_h > 0.5) & (x_h < 255.5)
    flags = jnp.any(uncertain, axis=(-2, -1))
    pix = jnp.clip(pix, 0.0, 255.0)
    out = pix.astype(jnp.uint8)
    if with_flags:
        return out, flags
    return out


def undo_dpcm(dc_diff: jnp.ndarray, ac: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`dc_dpcm`: (..., nb), (..., nb, 63) -> (..., nb, 64)."""
    dc = jnp.cumsum(dc_diff, axis=-1)
    return jnp.concatenate([dc[..., None], ac], axis=-1)
