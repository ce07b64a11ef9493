"""Device entropy coding: vectorized RLE + Huffman codes + bit packing.

The reference's hot loop is per-block Python entropy coding (~97% of
encode time, SURVEY 3.1).  Here the whole stage is data-parallel on
device:

1. **Symbolization** (:func:`block_symbols`): every block yields 65
   fixed slots -- [DC, 63 x AC coefficient, EOB].  Zig-zag zero runs are
   recovered with an exclusive cumulative max (position of the previous
   nonzero), so each nonzero coefficient knows its run length; runs >= 16
   fold their ZRL prefix codes into the same slot.  Each slot produces a
   <= 59-bit payload held left-aligned in two uint32 lanes plus a bit
   length (possibly 0).  Huffman code/length lookup is a vectorized gather
   from the numeric Annex K tables (constants.py layouts).
2. **Block packing** (:func:`pack_blocks`): an exclusive cumulative sum
   of slot lengths gives every slot its bit offset inside its block; a
   65-step vectorized loop ORs the (at most 3) word-aligned fragments of
   each slot into a (num_blocks, 52)-word buffer.  Different slots touch
   disjoint bits, so integer adds implement the OR without conflicts.
3. **Stream stitching** (:func:`stitch_words`): an exclusive scan over
   block bit lengths gives global offsets; each output word *gathers* the
   (<= 7) blocks that overlap it -- a gather, so no two writers ever
   touch one output word.

Capacity bounds are static: 52 words = 1664 bits per block covers the
worst legal block (63 AC coefficients at 26 bits + 20 DC bits + EOB).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

BLOCK_WORDS = C.BLOCK_WORDS  # 52
SLOTS = 65  # DC + 63 AC + EOB

_U32 = jnp.uint32
_FULL = jnp.uint32(0xFFFFFFFF)


def _u(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=_U32)


def _category(v: jnp.ndarray) -> jnp.ndarray:
    """JPEG size/category: bit length of |v| (0 for 0). int32 in/out."""
    return 32 - jax.lax.clz(jnp.abs(v))


def _magnitude(v: jnp.ndarray, size: jnp.ndarray) -> jnp.ndarray:
    """JPEG signed-magnitude bits: v>=0 -> v; v<0 -> one's complement of
    |v| == (v-1) in two's complement (reference huffman.py:59-60)."""
    mask = (jnp.int32(1) << size) - 1
    return _u((v - (v < 0)) & mask)


def _append(w0, w1, length, value_u32, nbits):
    """Append an <=32-bit big-endian value to left-aligned (w0, w1, len).

    Bit 0 of the payload sits at the MSB of w0.  nbits may be 0.
    All shift amounts are guarded to stay in [0, 31] (XLA shifts are
    undefined at >= bit width).
    """
    end = length + nbits
    e2 = end - 32  # bits that land in w1
    # contribution to w0: value >> e2 (if straddling/after) or << (32-end)
    shift_left = jnp.clip(32 - end, 0, 31)
    shift_right = jnp.clip(e2, 0, 31)
    in_w0 = jnp.where(
        e2 <= 0,
        value_u32 << _u(shift_left),
        jnp.where(e2 >= 32, _u(0), value_u32 >> _u(shift_right)),
    )
    # contribution to w1: low e2 bits of value, left-aligned at 32-e2
    shift_w1 = jnp.clip(32 - e2, 0, 31)
    in_w1 = jnp.where(
        e2 <= 0,
        _u(0),
        jnp.where(e2 >= 32, value_u32, value_u32 << _u(shift_w1)),
    )
    return w0 | in_w0, w1 | in_w1, end


import functools


@functools.cache
def _symbol_tables():
    """Merged numeric tables for single-gather symbolization.

    - DC/AC combined entries: ``code << 8 | code_length`` (codes <= 16
      bits, lengths <= 16, so one uint32 gather serves both).
    - ZRL prefix table indexed by z = run >> 4 in 0..3: the z-fold
      repetition of the 11-bit ZRL code, left-aligned in two uint32
      lanes, plus its bit length 11*z.
    """
    dc_comb = (C.DC_CODE.astype(np.uint64) << 8) | C.DC_CODELEN.astype(
        np.uint64
    )
    ac_comb = (
        C.AC_CODE.reshape(-1).astype(np.uint64) << 8
    ) | C.AC_CODELEN.reshape(-1).astype(np.uint64)
    zp0 = np.zeros(4, np.uint32)
    zp1 = np.zeros(4, np.uint32)
    zlen = np.zeros(4, np.int32)
    for z in range(1, 4):
        v = 0
        for _ in range(z):
            v = (v << C.ZRL_LEN) | C.ZRL_CODE
        bits = 11 * z
        v64 = v << (64 - bits)
        zp0[z] = v64 >> 32
        zp1[z] = v64 & 0xFFFFFFFF
        zlen[z] = bits
    return (
        dc_comb.astype(np.uint32),
        ac_comb.astype(np.uint32),
        zp0, zp1, zlen,
    )


def block_symbols(
    dc_diff: jnp.ndarray,
    ac: jnp.ndarray,
    dc_code: np.ndarray | jnp.ndarray | None = None,
    dc_len: np.ndarray | jnp.ndarray | None = None,
    ac_code: np.ndarray | jnp.ndarray | None = None,
    ac_len: np.ndarray | jnp.ndarray | None = None,
):
    """(..., nb) DC diffs + (..., nb, 63) AC -> per-slot payloads.

    Returns (w0, w1, bits, overflow): uint32/uint32/int32 arrays of shape
    (..., nb, 65) and a scalar bool overflow flag (set when a coefficient
    needs a size outside the table, i.e. |AC| > 1023 or |DC diff| > 2047 --
    the reference raises KeyError there, SURVEY 3.5 note).

    Optional table overrides (custom Huffman tables) use separate
    code/length arrays (numpy constants or traced jax arrays, so one
    compiled program serves every per-image table).  ZRL and EOB codes are
    derived from the override AC table (indices 15*11 and 0), and the
    overflow flag additionally covers the custom-table capacity limits
    (a slot payload must fit 64 bits; codes must be <= 16 bits wide).
    """
    custom = dc_code is not None or ac_code is not None
    if custom:
        dc_code_a = jnp.asarray(
            C.DC_CODE if dc_code is None else dc_code, jnp.uint32
        )
        dc_len_a = jnp.asarray(
            C.DC_CODELEN if dc_len is None else dc_len, jnp.uint32
        )
        ac_code_a = jnp.asarray(
            C.AC_CODE if ac_code is None else ac_code, jnp.uint32
        ).reshape(-1)
        ac_len_a = jnp.asarray(
            C.AC_CODELEN if ac_len is None else ac_len, jnp.uint32
        ).reshape(-1)
        dc_comb = (dc_code_a << _u(8)) | dc_len_a
        ac_comb = (ac_code_a << _u(8)) | ac_len_a
        # ZRL payload table for z in 0..3 repeats of the *custom* ZRL code
        zrl = ac_comb[15 * 11]
        zc = zrl >> _u(8)
        zl = (zrl & _u(0xFF)).astype(jnp.int32)
        zw0 = _u(0)
        zw1 = _u(0)
        zln = jnp.int32(0)
        zp0l, zp1l, zll = [_u(0)], [_u(0)], [jnp.int32(0)]
        for _ in range(3):
            zw0, zw1, zln = _append(zw0, zw1, zln, zc, zl)
            zp0l.append(zw0)
            zp1l.append(zw1)
            zll.append(zln)
        zp0 = jnp.stack(zp0l)
        zp1 = jnp.stack(zp1l)
        zlen = jnp.stack(zll)
        eob = ac_comb[0]
        eob_code = eob >> _u(8)
        eob_len = (eob & _u(0xFF)).astype(jnp.int32)
    else:
        dc_comb, ac_comb, zp0, zp1, zlen = _symbol_tables()
        eob_code = _u(C.EOB_CODE)
        eob_len = jnp.int32(C.EOB_LEN)
    dc_comb = jnp.asarray(dc_comb)
    ac_comb = jnp.asarray(ac_comb)
    zp0 = jnp.asarray(zp0)
    zp1 = jnp.asarray(zp1)
    zlen = jnp.asarray(zlen)

    # ---- DC slot: code+magnitude left-aligned directly ----------------
    cat = _category(dc_diff)
    dc_over = jnp.any(cat > 11)
    cat_c = jnp.clip(cat, 0, 11)
    comb = jnp.take(dc_comb, cat_c)
    code = comb >> _u(8)
    clen = (comb & _u(0xFF)).astype(jnp.int32)
    mag = _magnitude(dc_diff, cat_c)
    cat_u = _u(cat_c)
    val = (code << cat_u) | mag
    dc_bits = clen + cat_c  # in [2, 20]
    dc_w0 = val << _u(32 - dc_bits)
    dc_w1 = jnp.zeros_like(dc_w0)

    # ---- AC slots ------------------------------------------------------
    nz = ac != 0
    pos = jnp.arange(63, dtype=jnp.int32)
    marked = jnp.where(nz, pos, jnp.int32(-1))
    prev_inc = jax.lax.cummax(marked, axis=ac.ndim - 1)
    prev = jnp.concatenate(
        [jnp.full_like(prev_inc[..., :1], -1), prev_inc[..., :-1]],
        axis=-1,
    )
    run = pos - prev - 1  # zeros since previous nonzero (valid where nz)
    size = _category(ac)
    ac_over = jnp.any(jnp.where(nz, size, 0) > 10)
    s = jnp.clip(size, 0, 10)
    r = run & 15
    z = jnp.clip(run >> 4, 0, 3)  # number of ZRL prefixes
    comb = jnp.take(ac_comb, jnp.clip(r * 11 + s, 0, 175))
    code = comb >> _u(8)
    clen = (comb & _u(0xFF)).astype(jnp.int32)
    mag = _magnitude(ac, s)
    s_u = _u(s)
    val = (code << s_u) | mag      # code+magnitude, <= 26 bits
    vlen = clen + s
    plen = jnp.take(zlen, z)   # ZRL prefix bits (0/11/22/33 for Annex K)
    end = plen + vlen          # <= 59 static; <= 64 enforced for custom
    e2 = end - 32
    # place val at bit offset plen of the two-lane payload
    left_sh = _u(jnp.clip(32 - end, 0, 31))
    right_sh = _u(jnp.clip(e2, 0, 31))
    w1_sh = _u(jnp.clip(32 - e2, 0, 31))
    in_w0 = jnp.where(e2 <= 0, val << left_sh, val >> right_sh)
    in_w1 = jnp.where(e2 <= 0, _u(0), val << w1_sh)
    ac_w0 = jnp.take(zp0, z) | in_w0
    ac_w1 = jnp.take(zp1, z) | in_w1
    nz_u = nz.astype(_U32)
    ac_w0 = ac_w0 * nz_u
    ac_w1 = ac_w1 * nz_u
    ac_bits = end * nz.astype(jnp.int32)

    # ---- EOB slot ------------------------------------------------------
    eob_w0 = jnp.broadcast_to(
        eob_code << _u(jnp.clip(32 - eob_len, 0, 31)), dc_w0.shape
    )
    eob_w1 = jnp.zeros_like(dc_w1)
    eob_bits = jnp.broadcast_to(eob_len, dc_bits.shape)

    w0_all = jnp.concatenate(
        [dc_w0[..., None], ac_w0, eob_w0[..., None]], axis=-1
    )
    w1_all = jnp.concatenate(
        [dc_w1[..., None], ac_w1, eob_w1[..., None]], axis=-1
    )
    bits_all = jnp.concatenate(
        [dc_bits[..., None], ac_bits, eob_bits[..., None]], axis=-1
    )
    overflow = dc_over | ac_over
    if custom:
        # custom tables can exceed the static layout's capacity bounds:
        # a slot payload is two uint32 lanes (64 bits) and a block buffer
        # is BLOCK_WORDS words -- flag rather than corrupt.
        slot_over = jnp.any((end > 64) & nz)
        blk_bits = jnp.sum(bits_all, axis=-1)
        overflow = overflow | slot_over | jnp.any(
            blk_bits > BLOCK_WORDS * 32
        )
    return w0_all, w1_all, bits_all, overflow


def pack_blocks(w0, w1, bits):
    """Per-slot payloads (..., nb, 65) -> per-block word buffers.

    Returns (words (..., nb, 52) uint32, block_bits (..., nb) int32).
    """
    offsets = jnp.cumsum(bits, axis=-1) - bits  # exclusive
    block_bits = offsets[..., -1] + bits[..., -1]

    word_idx = offsets >> 5          # first word this slot touches
    s = offsets & 31                 # shift within that word
    ns = 32 - s
    # Slot payload (w0,w1) shifted right by s spans 3 words:
    s_u = _u(jnp.clip(s, 0, 31))
    ns_u = _u(jnp.clip(ns, 1, 32) & 31)  # ns in [1,32] -> shift 0 when 32
    c0 = w0 >> s_u
    left_w0 = jnp.where(s == 0, _u(0), w0 << ns_u)
    c1 = left_w0 | (w1 >> s_u)
    c2 = jnp.where(s == 0, _u(0), w1 << ns_u)

    lane = jnp.arange(BLOCK_WORDS, dtype=jnp.int32)

    def body(j, words):
        tgt = word_idx[..., j][..., None]  # (..., nb, 1)
        contrib = (
            jnp.where(lane == tgt, c0[..., j][..., None], _u(0))
            | jnp.where(lane == tgt + 1, c1[..., j][..., None], _u(0))
            | jnp.where(lane == tgt + 2, c2[..., j][..., None], _u(0))
        )
        return words | contrib

    # initial carry derived from the (possibly shard_map-varying) inputs so
    # the fori_loop carry type matches under shard_map's vma tracking
    zero = c0[..., :1] & _u(0)
    words = jnp.broadcast_to(zero, (*bits.shape[:-1], BLOCK_WORDS))
    words = jax.lax.fori_loop(0, SLOTS, body, words)
    return words, block_bits


def stitch_words(words, block_bits, out_words: int, max_overlap: int = 7):
    """Concatenate ragged bit buffers into one contiguous word stream.

    words: (n, W) uint32 rows of big-endian bit buffers; block_bits: (n,)
    int32 valid bits per row; out_words: static capacity of the output
    (>= ceil(total_bits / 32)); max_overlap: max rows that can overlap one
    32-bit output word (7 for 8x8 blocks whose min payload is 6 bits; 2
    when rows are large shard segments).

    Gather-based rather than scatter-based: each output word *looks up*
    the rows overlapping its 32 bits and ORs their aligned fragments, so
    no two rows write one word (a design from an earlier target that
    serialized scatters; a scatter or atomic-OR form is untested here).

    Returns (stream (out_words,) uint32, total_bits scalar).
    """
    nb, width = words.shape
    offsets = jnp.cumsum(block_bits) - block_bits  # exclusive, sorted
    total = offsets[-1] + block_bits[-1]

    wpos = jnp.arange(out_words, dtype=jnp.int32) * 32
    # first row whose offset range could cover this word's first bit
    first = jnp.searchsorted(offsets, wpos, side="right") - 1

    ext = jnp.concatenate([words, jnp.zeros((nb, 1), _U32)], axis=1)

    def fragment(k):
        b = jnp.clip(first + k, 0, nb - 1)
        o = jnp.take(offsets, b)
        l = jnp.take(block_bits, b)
        d = wpos - o  # bit position inside row b where this word starts
        # gather the two words of row b covering bits [d, d+32)
        u = jnp.clip(d >> 5, 0, width - 1)
        sh = d & 31
        hi = ext[b, u]
        lo = ext[b, u + 1]
        sh_u = _u(jnp.clip(sh, 0, 31))
        nsh_u = _u(jnp.clip(32 - sh, 1, 32) & 31)
        val = jnp.where(
            sh == 0, hi, (hi << sh_u) | (lo >> nsh_u)
        )
        # d < 0: row starts inside this word; shift right instead
        neg = _u(jnp.clip(-d, 0, 31))
        val = jnp.where(d < 0, jnp.where(-d >= 32, _u(0), hi >> neg), val)
        # mask to the word's bit range that row b actually owns:
        # bits g in [max(0, o-wpos), min(32, o+l-wpos))
        g0 = jnp.clip(o - wpos, 0, 32)
        g1 = jnp.clip(o + l - wpos, 0, 32)
        left = jnp.where(g0 == 0, _FULL, _FULL >> _u(jnp.clip(g0, 0, 31)))
        left = jnp.where(g0 >= 32, _u(0), left)
        right = jnp.where(
            g1 >= 32, _FULL,
            ~(_FULL >> _u(jnp.clip(g1, 0, 31))),
        )
        mask = left & right
        valid = (g1 > g0) & (d < width * 32)
        return jnp.where(valid, val & mask, _u(0))

    out = fragment(0)
    for k in range(1, max_overlap):
        out = out | fragment(k)
    return out, total
