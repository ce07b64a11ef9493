"""Device (XLA) chunk-parallel entropy decode of TICX-indexed streams.

The reference decoder walks one serial bit cursor through the whole
payload (reference huffman.py:66-74: bit-at-a-time prefix match inside a
per-block loop) -- the decode hot loop and THE parallelization obstacle
(SURVEY 3.2).  The TICX trailer removes the obstacle: it records the
exact payload bit offset of every ``stride``-th block, so a stream is
``C = ceil(nb/stride)`` independently decodable chunks.

This module decodes all chunks of a whole batch of streams AT ONCE on
the accelerator, with no Huffman LUT and no per-symbol host work:

1. **Chain following** (the only serial part, vectorized across
   chunks): every chunk carries a bit cursor; each chain step decodes
   up to 2 * _PAIRS symbols PER CHUNK from ONE contiguous
   4*_PAIRS-half-cell uint16 payload gather plus _PAIRS rows of a
   packed PAIRED ``(mode, 16-bit window) -> (len, size, run, EOB,
   advance) x 2`` table (each row also carries the speculative decode
   of the FOLLOWING symbol when both codes share the window) -- 0.75
   serialized gathers per symbol; the chain is gather-throughput-bound.  Values, signs (JPEG
   one's-complement, reference bitbuffer.py:61-65) and record packing
   happen in-register; _UNROLL steps write one record slab per
   ``lax.while_loop`` iteration, until every chunk has finished its
   blocks or the slot budget runs out (callers RESUME exhausted chunks
   from the returned cursor state).
2. **Record unpack** (fully parallel over all recorded slots, zero
   gathers): the chain already decoded value/run/kind/EOB into each
   record word; the buffer transposes to chunk-major so the segmented
   scans below run on the contiguous last axis.
3. **Reassembly** (parallel scans + one matmul): per-chunk running block
   counter (cumsum of DC slots) + intra-block zig-zag position via a
   reset-at-DC segmented cumsum (cummax trick), then -- for canonical
   layouts -- a batched one-hot bf16 matmul places every slot into the
   ``(nb_total, 64)`` coefficient tensor (values ride in two <=8-bit
   pieces, exact in a bf16 matmul with f32 accumulation); arbitrary
   chunk subsets (resumes) use a
   sorted scatter instead.

Validation is explicit: a chunk is ``ok`` only if it decoded exactly its
block count, every coefficient landed in [0, 63], and its final cursor
lands exactly on the next chunk's recorded offset (or inside the final
byte-alignment pad).  Corrupt streams therefore degrade loudly to the
host decoder per image instead of silently mis-decoding (the reference's
graceful-degradation contract, codec.py:178-186, stays with the host
oracle).

Tables: the standard Annex-K tables compile as constants (the fast
path); dynamic-table streams decode through the SAME programs with
their parsed tables passed as runtime tensors (``tables=``), provided
the table is canonical, 16-bit-limited, and standard-range (DC category
<= 11 / AC size <= 10 -- the same bound as the device ENCODER's layout,
huffman.py ``HuffmanSpec.extended``); :func:`canonical_tables` performs
that admission check on the host.  Extended-range or non-canonical
tables fall back to the host decoder.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import (
    AC_BITS,
    AC_HUFFVAL,
    DC_BITS,
    DC_HUFFVAL,
)

# absolute per-block symbol bound: 1 DC + 63 AC values + <=3 ZRL + EOB
MAX_BLOCK_SYMBOLS = 68

# pair-decodes per chain step: each step does ONE payload gather of
# 4*_PAIRS half-cells plus _PAIRS paired-info-row gathers, decoding up
# to 2*_PAIRS symbols -- (1 + _PAIRS) serialized gathers per 2*_PAIRS
# symbols
_PAIRS = 2
# steps per while-loop iteration (each writes 2*_PAIRS record rows);
# amortizes the slab write + cond reduce
_UNROLL = 2


@functools.cache
def _decode_tables():
    """Canonical per-length decode tables (T.81 F.2.2.3 form).

    For each table: mincode[l], maxcode[l] (last code of length l, -1
    where the length is unused), valptr[l] (first symbol index of that
    length), all indexed 1..16 (index 0 unused), plus the symbol-order
    huffval array.  Derived from the same Annex-K BITS/HUFFVAL spec
    arrays as the encoder's tables (constants.py:96-123)."""

    def build(bits, huffval):
        mincode = np.full(17, 0, np.int32)
        maxcode = np.full(17, -1, np.int32)
        valptr = np.zeros(17, np.int32)
        code = 0
        k = 0
        for l in range(1, 17):
            n = bits[l - 1]
            if n:
                valptr[l] = k
                mincode[l] = code
                maxcode[l] = code + n - 1
                code += n
                k += n
            code <<= 1
        return (
            mincode, maxcode, valptr,
            np.asarray(huffval, np.int32),
        )

    return build(DC_BITS, DC_HUFFVAL), build(AC_BITS, AC_HUFFVAL)


def canonical_tables(tables: dict):
    """Parsed string-code tables -> ((dc), (ac)) in T.81 F.2.2.3 form.

    Host-side admission check for device decode of dynamic-table
    streams (container.read_huffman_table output).  Returns the same
    (mincode, maxcode, valptr, huffval) tuples as :func:`_decode_tables`
    (huffval zero-padded to 256 so jit signatures are table-independent)
    or None when the table cannot drive the device chain:

    * a code longer than 16 bits (the chain decodes via 16-bit windows);
    * codes that are not CANONICAL (per-length consecutive, numbered by
      the standard shift law) -- _code_len's first-match rule is only
      correct for canonical codes, and this codec's own builder
      (huffman._canonical_codes) always emits them; foreign tables that
      are not canonical fall back to the host bit-cursor;
    * extended-range symbols (DC category > 11 / AC size > 10): value
      reassembly carries coefficients in two <=8-bit matmul pieces
      (|v| <= 2047) and the pair-window invariant assumes <= 27-bit
      symbols -- the same standard-range bound as the device ENCODER
      (huffman.HuffmanSpec.extended, engine.py:412-418).
    """
    from ..constants import AC as AC_KEY
    from ..constants import DC as DC_KEY

    def build(code_map, sym_value):
        if not code_map:
            return None
        items = []
        for sym, s in code_map.items():
            l = len(s)
            if l < 1 or l > 16:
                return None
            v = sym_value(sym)
            if v is None:
                return None
            items.append((l, int(s, 2), v))
        items.sort()
        mincode = np.zeros(17, np.int32)
        maxcode = np.full(17, -1, np.int32)
        valptr = np.zeros(17, np.int32)
        huffval = np.zeros(256, np.int32)
        code = 0
        prev_l = 0
        for k, (l, c, v) in enumerate(items):
            code <<= l - prev_l
            prev_l = l
            if c != code:  # not the canonical numbering
                return None
            if maxcode[l] < 0:
                mincode[l] = code
                valptr[l] = k
            maxcode[l] = code
            huffval[k] = v
            code += 1
        return mincode, maxcode, valptr, huffval

    def dc_sym(cat):
        return cat if isinstance(cat, int) and 0 <= cat <= 11 else None

    def ac_sym(rs):
        try:
            run, size = rs
        except (TypeError, ValueError):
            return None
        if 0 <= run <= 15 and 0 <= size <= 10:
            return (run << 4) | size
        return None

    dc = build(tables[DC_KEY], dc_sym)
    ac = build(tables[AC_KEY], ac_sym)
    if dc is None or ac is None:
        return None
    return dc, ac


def flatten_tables(tables):
    """((dc), (ac)) decode tuples -> flat 8-tuple for jit arg passing.

    Single source of the argument order (mincode, maxcode, valptr,
    huffval for DC then AC); :func:`unflatten_tables` is the inverse
    used inside the jitted programs."""
    return tuple(a for t in tables for a in t)


def unflatten_tables(flat):
    """Inverse of :func:`flatten_tables`; empty input -> None (the
    standard-table constant path)."""
    return (tuple(flat[:4]), tuple(flat[4:])) if flat else None


def _code_len(w16, maxcode):
    """Length of the canonical codeword in the high bits of w16.

    Vectorized Annex F.2.2.3: the true length is the FIRST l with
    ``w16 >> (16 - l) <= maxcode[l]`` (shorter prefixes always compare
    greater for canonical codes; unused lengths have maxcode -1 and
    never match).  Statically unrolled descending so the smallest
    matching l wins without materializing an (..., 16) intermediate.
    Garbage windows that match nothing keep the fallback 16 --
    downstream validation rejects the chunk.

    maxcode may be a host constant (standard tables -- unused lengths
    prune at trace time, keeping that XLA program unchanged) or a
    traced tensor (dynamic-table streams -- the unused-length guard
    joins the predicate instead)."""
    import jax.numpy as jnp

    out = jnp.full(w16.shape, 16, jnp.int32)
    host = isinstance(maxcode, np.ndarray)
    for l in range(16, 0, -1):
        if host:
            if maxcode[l] < 0:  # host constant: unused code length
                continue
            out = jnp.where(w16 >> (16 - l) <= maxcode[l], l, out)
        else:
            out = jnp.where(
                (w16 >> (16 - l) <= maxcode[l]) & (maxcode[l] >= 0),
                l, out,
            )
    return out


def _sign_extend(mag, size):
    """JPEG one's-complement magnitude -> signed value (size==0 -> 0)."""
    import jax.numpy as jnp

    half = jnp.int32(1) << jnp.maximum(size - 1, 0)
    neg = (mag < half) & (size > 0)
    return jnp.where(neg, mag - (jnp.int32(1) << size) + 1, mag)


def _decode_symbol(w32, tables):
    """One symbol at the head of each 32-bit window.

    Returns (code_len, symbol_value); symbol_value is the huffval entry
    (the category for DC, run<<4|size for AC).  Elementwise over w32's
    shape."""
    import jax.numpy as jnp

    mincode, maxcode, valptr, huffval = tables
    w16 = (w32 >> 16).astype(jnp.int32)
    L = _code_len(w16, maxcode)
    code = w16 >> (16 - L)
    idx = jnp.take(jnp.asarray(valptr), L) + code - jnp.take(
        jnp.asarray(mincode), L
    )
    idx = jnp.clip(idx, 0, len(huffval) - 1)
    sym = jnp.take(jnp.asarray(huffval), idx)
    return L, sym


def entropy_decode_chunks(
    words,
    chunk_start,
    chunk_blocks,
    chunk_block_base,
    chunk_end_lo,
    chunk_end_hi,
    nb_total: int,
    stride: int,
    max_symbols: int | None = None,
    layout: tuple[int, int] | None = None,
    paired: bool | None = None,
    resume=None,
    return_state: bool = False,
    tables=None,
    _return_records: bool = False,
):
    """Decode all chunks of a (multi-stream) payload word array.

    words: (W,) uint32 big-endian payload words (streams byte-padded to
    word boundaries and concatenated).  chunk_start: (C,) int32 global
    bit offsets of each chunk.  chunk_blocks: (C,) blocks per chunk
    (== stride except final image chunks).  chunk_block_base: (C,)
    first global block index of each chunk.  chunk_end_lo/hi: (C,)
    inclusive bounds the final cursor must land in (exact next-chunk
    offset for interior chunks; [payload_end-7, payload_end] for each
    image's last chunk).

    max_symbols: per-chunk slot-ROW budget sizing the record buffers (a
    row holds one symbol, with <= 2 dead rows per chunk tail).  The
    legal worst case (stride * 68) is ~6x what natural content needs,
    and the post-chain phases cost O(budget * C), so callers run with a
    small budget first and retry at the worst case only when
    ``exhausted`` reports a chunk ran out (two-round decode).

    layout: ``(images, nb_per_image)`` when the chunks follow
    prepare_batch's canonical layout (uniform images; chunk k holds the
    CONTIGUOUS ascending block range [base_k, base_k + blocks_k), full
    ``stride``-block chunks except each image's last, dead pad chunks
    only at the end).  Enables the scatter-free matmul reassembly;
    pass None for arbitrary chunk subsets (the rerun path), which use
    a sorted XLA scatter instead.

    resume: ``(pos0, is_dc0, left0, zzcur0, wbad0)`` -- (C,) int32
    arrays of per-chunk CONTINUATION state from a previous pass's
    ``return_state=True`` output (bit cursor, 1 if the next symbol is a
    DC, blocks still unfinished, zig-zag position of the last written
    coefficient in the cut block, 1 if any earlier pass recorded an
    invalid write for the chunk -- carried so a corrupt prefix still
    fails validation after a clean-looking continuation).  A resumed pass decodes only the
    REMAINING symbols of each chunk and its ``zz`` holds only the
    coefficients it decoded -- callers ADD it to the prior pass's
    output (coefficient sets are disjoint).  With resume, chunk_blocks
    still carries each chunk's ORIGINAL total (for block indexing);
    use layout=None (resumed subsets are not canonical).

    Returns (zz (nb_total, 64) int32 zig-zag coefficients with DPCM'd
    DC in column 0, ok (C,) bool per-chunk validation, exhausted (C,)
    bool -- ran out of budget, resume to finish[, state -- the
    continuation tuple above, when return_state]).  Traceable under
    jit; everything stays on device.
    """
    import jax
    import jax.numpy as jnp

    # tables: None = the standard Annex-K tables as trace-time
    # constants (phase 0 constant-folds; the XLA program is unchanged
    # from the standard-only design).  Otherwise a
    # ((mincode, maxcode, valptr, huffval) x 2) tuple of RUNTIME
    # tensors from canonical_tables() -- dynamic-table streams share
    # one compiled program across all tables of a given batch shape.
    if tables is None:
        dc_tab, ac_tab = _decode_tables()
    else:
        dc_tab, ac_tab = tables
    c = chunk_start.shape[0]
    # Slot ROWS: the pair-step chain decodes two symbols per step (the
    # gathered 80-bit window always covers a legal symbol pair, <= 52
    # bits), so rows track symbols exactly except for <= 2 dead rows at
    # each chunk's tail (a chunk finishing mid-step or mid-slab).
    worst = int(stride) * MAX_BLOCK_SYMBOLS + 2
    s_cap = min(worst, max_symbols) if max_symbols else worst
    s_cap = (
        -(-s_cap // (2 * _PAIRS * _UNROLL)) * (2 * _PAIRS * _UNROLL)
    )

    # Chunk state lives as (8, ceil(C/8)) tiles (a layout kept from an
    # earlier target whose vector tiles were 8 rows deep).  Pad chunks
    # to a multiple of 8 with DEAD chunks (zero blocks decode nothing
    # and validate ok: cursor stays at start == both end bounds).
    c8 = -(-c // 8) * 8
    crows, ccols = 8, c8 // 8

    def shape2d(arr, fill=0):
        flat = jnp.full((c8,), fill, jnp.int32)
        flat = flat.at[:c].set(arr.astype(jnp.int32))
        return flat.reshape(crows, ccols)

    chunk_start = shape2d(chunk_start)
    chunk_blocks = shape2d(chunk_blocks)
    chunk_block_base = shape2d(chunk_block_base)
    chunk_end_lo = shape2d(chunk_end_lo)
    chunk_end_hi = shape2d(chunk_end_hi)

    # -- phase 0: packed per-window symbol table + window array --------
    # The serial phase is bound by per-op dispatch overhead and gather
    # locality, so it must be a handful of ops over SMALL tables:
    #  * info_tab[(is_dc << 16) | w16] packs EVERYTHING about the
    #    symbol whose code heads the 16-bit window: code length (5b),
    #    magnitude size (4b), zero run (4b), EOB flag (1b), total bit
    #    advance (top bits).  512 KB, content-independent.  (Codes are
    #    <= 16 bits by construction; magnitude bits extending past the
    #    window only contribute their COUNT, which the window
    #    determines.)
    #  * hq[j] = 4*_PAIRS consecutive 16-bit half-cells from cell j --
    #    one contiguous uint16 row gather yields every window a whole
    #    chain step needs.  (A previous variant precomputed 224 MB of
    #    per-bit-position next tables: random HBM gathers measured
    #    SLOWER than recomputing.)
    w16_all = jnp.arange(65536, dtype=jnp.int32)
    w16_u = (w16_all << 16).astype(jnp.uint32)
    l_dc, cat = _decode_symbol(w16_u, dc_tab)
    l_ac, rs = _decode_symbol(w16_u, ac_tab)
    cat = jnp.clip(cat, 0, 15)
    info_dc = l_dc | (cat << 5) | ((l_dc + cat) << 14)
    adv_ac = l_ac + (rs & 15)
    info_ac = (
        l_ac | ((rs & 15) << 5) | ((rs >> 4) << 9)
        | jnp.where(rs == 0, 1 << 13, 0) | (adv_ac << 14)
    )
    info_tab = jnp.concatenate([info_ac, info_dc])
    if paired is None:
        # budgeted passes default to the paired chain (fastest); the
        # unbudgeted worst-case pass keeps the miss-free chain so its
        # stride*68 slot bound stays exact
        paired = max_symbols is not None
    if paired:
        # PAIRED info table: row (is_dc << 16) | w16 packs symbol 1's
        # info word AND the speculative decode of the symbol that
        # follows it in the same 16-bit window (valid -- bit 19 of
        # word 1 -- whenever adv1 + len2 <= 16, the common case for
        # natural content).  One contiguous 2-int row gather then
        # serves BOTH symbols of a chain step: 2 serialized gathers
        # per step instead of 3 (the chain is gather-throughput-bound).
        # A pair miss decodes only
        # symbol 1 that step (dead record row; the budget/rerun
        # machinery absorbs the rare inflation).  The worst-case rerun
        # pass (max_symbols None) keeps the miss-free two-gather chain
        # so its stride*68 slot bound stays exact.
        def spec2(v1, mode2_dc):
            adv1 = v1 >> 14
            w2 = jnp.where(
                adv1 <= 15, (w16_all << jnp.clip(adv1, 0, 15))
                & 0xFFFF, 0
            )
            v2 = jnp.where(
                mode2_dc, jnp.take(info_dc, w2),
                jnp.take(info_ac, w2),
            )
            ok = adv1 + (v2 & 31) <= 16
            return v2 | jnp.where(ok, 1 << 19, 0)
        # after DC comes AC; after AC comes DC iff EOB
        pair_dc = spec2(info_dc, jnp.zeros_like(w16_all, bool))
        pair_ac = spec2(info_ac, (info_ac & (1 << 13)) != 0)
        ptab = jnp.stack(
            [info_tab,
             jnp.concatenate([pair_ac, pair_dc])],
            axis=1,
        )  # (131072, 2)

    hw = jnp.stack(
        [(words >> jnp.uint32(16)).astype(jnp.int32),
         (words & jnp.uint32(0xFFFF)).astype(jnp.int32)],
        axis=1,
    ).reshape(-1)  # (2W,) 16-bit cells
    # 4*_PAIRS consecutive half-cells per row: ONE contiguous-slice
    # gather yields 64*_PAIRS bits -- with the <=15-bit cursor phase
    # that always covers 2*_PAIRS legal symbols (worst 26 bits each;
    # garbage extractions stay inside the gathered registers, and
    # validation rejects those chunks)
    ncells = 4 * _PAIRS
    # uint16 rows: the cells are 16-bit halves anyway, and halving the
    # gathered bytes measures ~4% off the whole pass (chain 11.34 ->
    # 10.90 ms on the q=50 corpus at the 16-row budget)
    hw16 = hw.astype(jnp.uint16)
    hq = jnp.stack(
        [hw16] + [
            jnp.roll(hw16, -j).at[-j:].set(0)
            for j in range(1, ncells)
        ],
        axis=1,
    )  # (2W, ncells) uint16

    # -- phase 1: chain following (the only serial part) ---------------
    # The round-4 chain decoded ONE symbol per lockstep step (2 gathers
    # + ~14 narrow ops + 1 row write + the any(left) cond reduce) and
    # was bound by per-step dispatch/launch overhead, not data
    # (~770 steps at ~8 us per op, measured on an earlier target).  This
    # round's chain cuts the per-symbol serialized work three ways:
    #  * PAIR DECODE: one 5-half-cell gather gives >=65 bits from the
    #    cursor; symbol 2's code window is extracted from the same
    #    registers, so the serialized gather chain is 1.5/symbol
    #    instead of 2.  A legal symbol pair is at most 26+26 bits, so
    #    the second symbol ALWAYS decodes from the gathered bits --
    #    every live step advances exactly two symbols (one at the
    #    chunk's final odd symbol).
    #  * UNROLL: each while iteration runs _UNROLL pair-steps and
    #    writes their 2*_UNROLL record rows as ONE slab, so the
    #    dynamic_update_slice and the any(left) cond reduce amortize
    #    2*_UNROLL times.
    #  * the SYMBOL VALUE decodes in-chain (record packs value/run/
    #    kind/eob in one int32) so the post-chain phases have ZERO
    #    gathers (the round-4 win, kept).
    def sym_value(v, wins, off):
        """Signed value of the symbol described by info word ``v`` whose
        code starts ``off`` bits after the cursor.  wins[k] =
        bits[pos + 16k, pos + 16k + 32); the smallest window whose end
        covers the magnitude is selected, and for any VALID stream the
        magnitude then sits at a non-negative in-window offset (end >
        16(k-1)+32 and size <= 15 force offm >= 16k).  Garbage
        windows/offsets clamp and mis-extract harmlessly -- validation
        rejects those chunks."""
        length = v & 31
        size = (v >> 5) & 15
        offm = off + length
        end = offm + size
        base = wins[0]
        kbase = jnp.zeros_like(offm)
        for k in range(1, len(wins)):
            sel = end > 16 * k + 16
            base = jnp.where(sel, wins[k], base)
            kbase = jnp.where(sel, 16 * k, kbase)
        rel = offm - kbase
        mag = (
            (base >> jnp.clip(32 - rel - size, 0, 31).astype(jnp.uint32))
            & ((jnp.uint32(1) << size.astype(jnp.uint32)) - 1)
        ).astype(jnp.int32)
        return _sign_extend(mag, size)

    def code16_at(off, wins):
        """The 16-bit code window at bit ``off`` after the cursor."""
        k = off >> 4
        w = wins[0]
        for kk in range(1, len(wins)):
            w = jnp.where(k >= kk, wins[kk], w)
        sh = (off & 15).astype(jnp.uint32)
        return ((w << sh) >> 16).astype(jnp.int32)

    def pack_rec(value, v, kind, eob):
        return (
            (value + 0x8000)
            | (((v >> 9) & 15) << 16)          # run
            | (kind << 20)
            | (jnp.where(eob, 1, 0) << 22)
        )

    def one_pair(off0, is_dc, left, wins, first):
        """Decode up to two symbols starting ``off0`` bits after the
        cursor: symbol A always commits while the chunk is live; in the
        paired chain symbol B commits when the speculative table entry
        is valid (adv_A + len_B <= 16), else its record row is dead and
        the next pair re-decodes it.  Returns (off_end, is_dc, left,
        rec_A, rec_B)."""
        live = left > 0
        if first:
            code_a = (wins[0] >> 16).astype(jnp.int32)
        else:
            code_a = code16_at(off0, wins)
        idx = code_a + (is_dc.astype(jnp.int32) << 16)
        if paired:
            pr = jnp.take(ptab, idx, axis=0, mode="clip")
            va = pr[..., 0]
            vbp = pr[..., 1]
        else:
            va = jnp.take(info_tab, idx, mode="clip")
        adv_a = (va >> 14) & 31
        eob_a = (va & (1 << 13)) != 0
        kind_a = jnp.where(live, jnp.where(is_dc, 2, 1), 0)
        rec_a = pack_rec(sym_value(va, wins, off0), va, kind_a, eob_a)
        left_a = left - (live & eob_a)
        is_dc_b = jnp.where(live, jnp.where(is_dc, False, eob_a),
                            is_dc)
        off_a = off0 + jnp.where(live, adv_a, 0)
        if paired:
            vb = vbp
            ok_b = (vbp & (1 << 19)) != 0
            live_b = live & (left_a > 0) & ok_b
        else:
            vb = jnp.take(
                info_tab,
                code16_at(off_a, wins)
                + (is_dc_b.astype(jnp.int32) << 16),
                mode="clip",
            )
            live_b = live & (left_a > 0)
        adv_b = (vb >> 14) & 31
        eob_b = (vb & (1 << 13)) != 0
        kind_b = jnp.where(live_b, jnp.where(is_dc_b, 2, 1), 0)
        rec_b = pack_rec(sym_value(vb, wins, off_a), vb, kind_b,
                         eob_b)
        left_b = left_a - (live_b & eob_b)
        is_dc_c = jnp.where(live_b, jnp.where(is_dc_b, False, eob_b),
                            is_dc_b)
        off_b = off_a + jnp.where(live_b, adv_b, 0)
        return off_b, is_dc_c, left_b, rec_a, rec_b

    def decode_step(pos, is_dc, left):
        """Decode up to 2*_PAIRS symbols per live chunk from ONE
        payload gather: _PAIRS pair decodes against the same
        4*_PAIRS-half-cell window (a legal symbol is <= 26 bits, so
        2*_PAIRS of them always fit the >= 64*_PAIRS - 15 gathered
        bits)."""
        cell = pos >> 4
        sph = (pos & 15).astype(jnp.uint32)
        q = jnp.take(hq, cell, axis=0, mode="clip")
        h = [q[..., k].astype(jnp.uint32) for k in range(ncells)]
        sh = jnp.uint32(16) - sph
        wins = []
        for k in range(ncells - 2):
            a = (h[k] << 16) | h[k + 1]
            wins.append(
                jnp.where(sph == 0, a, (a << sph) | (h[k + 2] >> sh))
            )
        off = jnp.int32(0)
        recs = []
        for j in range(_PAIRS):
            off, is_dc, left, ra, rb = one_pair(
                off, is_dc, left, wins, j == 0
            )
            recs += [ra, rb]
        return pos + off, is_dc, left, recs

    def body(state):
        i, pos, is_dc, left, pbuf = state
        recs = []
        for _ in range(_UNROLL):
            pos, is_dc, left, rs = decode_step(pos, is_dc, left)
            recs += rs
        pbuf = jax.lax.dynamic_update_slice(
            pbuf, jnp.stack(recs), (i, 0, 0)
        )
        return i + 2 * _PAIRS * _UNROLL, pos, is_dc, left, pbuf

    def cond(state):
        i, pos, is_dc, left, pbuf = state
        return (i < s_cap) & jnp.any(left > 0)

    if resume is not None:
        pos0, isdc0, left0, zzcur0, wbad0 = resume
        pos_i = shape2d(pos0)
        # dead-pad fill 1: the expected-DC validation below reduces to
        # 0 decoded blocks for left=0 pads
        isdc_i = shape2d(isdc0, fill=1)
        left_i = shape2d(left0)
        zzcur0 = shape2d(zzcur0)
        wbad0 = shape2d(wbad0)
    else:
        pos_i = chunk_start
        isdc_i = jnp.ones((crows, ccols), jnp.int32)
        left_i = chunk_blocks
        zzcur0 = jnp.zeros((crows, ccols), jnp.int32)
        wbad0 = jnp.zeros((crows, ccols), jnp.int32)
    init = (
        jnp.int32(0),
        pos_i,
        isdc_i != 0,
        left_i,
        jnp.zeros((s_cap, crows, ccols), jnp.int32),
    )
    steps, pos_f, isdc_f, left_f, pbuf = jax.lax.while_loop(
        cond, body, init
    )
    exhausted = left_f > 0
    bad = exhausted

    # -- phase 2: unpack recorded slots (no gathers) -------------------
    # slot-major -> chunk-major FIRST: the segmented scans then run
    # along the LAST axis of (8, cc, S) tiles and the reassembly needs
    # no further transposes
    pbuf = jnp.transpose(pbuf, (1, 2, 0))  # (8, cc, S)
    kbuf = (pbuf >> 20) & 3
    is_dc = kbuf == 2
    is_ac = kbuf == 1
    valid = kbuf != 0
    value = (pbuf & 0xFFFF) - 0x8000
    run = (pbuf >> 16) & 15
    eob = is_ac & (((pbuf >> 22) & 1) != 0)

    # -- phase 3: reassembly ------------------------------------------
    # block index within chunk: blocks already completed by earlier
    # passes (0 when fresh) + running count of DC slots, off by one
    # when the stream opens at a block boundary (a fresh chunk's first
    # DC is block start_blk, not start_blk + 1)
    start_blk = chunk_blocks - left_i
    blk_in_chunk = (
        start_blk[..., None]
        + jnp.cumsum(is_dc.astype(jnp.int32), axis=-1)
        - isdc_i[..., None]
    )
    # zig-zag position: segmented cumsum of (run + 1) with reset at DC.
    # cum is monotone, so the running max of (cum where DC else
    # sentinel) is the base at the most recent DC slot; before the
    # first DC of a RESUMED mid-block chunk, the base continues the
    # prior pass's cut position (-zzcur0).
    adv_pos = jnp.where(is_ac & ~eob, run + 1, 0)
    cum = jnp.cumsum(adv_pos, axis=-1)
    _sent = jnp.int32(-(1 << 30))
    base = jax.lax.cummax(jnp.where(is_dc, cum, _sent), axis=2)
    base = jnp.where(base <= _sent // 2, -zzcur0[..., None], base)
    zz_pos = jnp.where(is_dc, 0, cum - base)

    write = valid & ~eob
    blk = chunk_block_base[..., None] + blk_in_chunk
    pos_ok = (zz_pos >= 0) & (zz_pos <= 63)
    blk_ok = (blk >= 0) & (blk < nb_total)
    good = write & pos_ok & blk_ok
    val = jnp.where(good, value, 0)
    if layout is not None:
        # MATMUL reassembly (no XLA scatter): chunks write their blocks
        # contiguously and in order (prepare_batch's canonical layout),
        # so per chunk the (slot -> block-in-chunk x zigzag) placement
        # is OUT[c] = A[c].T @ B[c] with A the block one-hot and B the
        # value-weighted zigzag one-hot -- a batched (C, stride, S) x
        # (C, S, 64) matmul, then a reshape + slice assembles the
        # (nb_total, 64) tensor (on an earlier target the XLA scatter
        # it replaces was most of the post-chain cost).  Exactness: the
        # value rides in two <=8-bit pieces (lo in [0,127], hi in
        # [-16,15], val = hi*128 + lo) because the operands are bf16 --
        # bf16 represents integers <=255 exactly and the f32
        # accumulation of <=S terms stays < 2^24.  Checked on the GPU
        # by pixel identity with the host decoder (chip_smoke.py).
        images, nb_image = layout
        n_c = -(-nb_image // int(stride))
        s_axis = s_cap
        blk_cm = blk_in_chunk.reshape(c8, s_axis)
        pos_cm = zz_pos.reshape(c8, s_axis)
        val_cm = val.reshape(c8, s_axis)
        lo = (val_cm & 127).astype(jnp.bfloat16)
        hi = ((val_cm - (val_cm & 127)) >> 7).astype(jnp.bfloat16)
        a_onehot = (
            blk_cm[:, :, None] == jnp.arange(stride, dtype=jnp.int32)
        ).astype(jnp.bfloat16)
        l_onehot = (
            pos_cm[:, :, None] == jnp.arange(64, dtype=jnp.int32)
        )
        out_lo = jax.lax.dot_general(
            a_onehot, l_onehot.astype(jnp.bfloat16) * lo[:, :, None],
            (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        out_hi = jax.lax.dot_general(
            a_onehot, l_onehot.astype(jnp.bfloat16) * hi[:, :, None],
            (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        zz_chunks = (out_lo + 128.0 * out_hi).astype(jnp.int32)
        # canonical layout: full chunks exactly tile each image's
        # blocks and only the final chunk is short, so valid rows are
        # the contiguous prefix [0, nb_image) after grouping chunks by
        # image -- a reshape + slice, no gather
        zz = (
            zz_chunks[: images * n_c]
            .reshape(images, n_c * int(stride), 64)[:, :nb_image]
            .reshape(nb_total, 64)
        )
    else:
        # general layout (subset reruns): sorted scatter -- within a
        # chunk valid targets strictly increase and chunk ranges ascend
        # with chunk order; invalid slots (EOB, dead) repeat the
        # chunk's LAST valid index via a running max, adding 0 there --
        # every live chunk's step-0 slot is a valid DC write, so no -1
        # survives except in dead-pad chunks, which sit at the END of
        # chunk order and map to the discard sentinel.
        flat = jnp.where(good, blk * 64 + zz_pos, -1)
        flat = jax.lax.cummax(flat, axis=2)
        flat = jnp.where(flat < 0, nb_total * 64, flat)
        flat_cm = flat.reshape(-1)
        val_cm = val.reshape(-1)
        zz = jnp.zeros((nb_total * 64 + 1,), jnp.int32)
        # resumed chunks can open with non-write slots (EOB at the
        # cut), whose sentinel-filled leading indices break global
        # sortedness -- drop the hint there (resumed subsets are small)
        zz = zz.at[flat_cm].add(
            val_cm, mode="drop",
            indices_are_sorted=resume is None,
        )
        zz = zz[:-1].reshape(nb_total, 64)

    # -- validation ----------------------------------------------------
    wbad = wbad0 | jnp.any(
        write & ~(pos_ok & blk_ok), axis=-1
    ).astype(jnp.int32)
    bad = bad | (wbad != 0)
    blocks_done = jnp.sum(is_dc.astype(jnp.int32), axis=-1)
    # a pass opening mid-block (resume with is_dc0 == 0) finishes the
    # cut block without a DC slot of its own
    expected_dc = jnp.maximum(left_i - 1 + isdc_i, 0)
    bad = bad | (blocks_done != expected_dc)
    bad = bad | (pos_f < chunk_end_lo) | (pos_f > chunk_end_hi)
    ok_out = (~bad).reshape(-1)[:c]
    ex_out = exhausted.reshape(-1)[:c]
    if _return_records:  # profiling hook (scripts/profile_decode.py)
        return zz, ok_out, ex_out, pbuf
    if return_state:
        zzcur_f = cum[..., -1] - base[..., -1]
        state = tuple(
            a.reshape(-1)[:c] for a in (
                pos_f, isdc_f.astype(jnp.int32), left_f, zzcur_f, wbad,
            )
        )
        return zz, ok_out, ex_out, state
    return zz, ok_out, ex_out


def suggest_budget_rows(payload_words: int, nb_total: int,
                        stride: int, margin: float = 1.5) -> int:
    """Content-adaptive first-pass slot budget (rows per chunk).

    Payload bits predict symbols at ~4.2 bits/symbol (q=50 corpus: 67
    bits/block over ~15 slot rows; q=90: 115 over ~35 -- denser content
    uses SHORTER codes); ``margin`` covers the density tail.  Bucketed
    to a fixed ladder so jit signatures stay bounded; 68 is the exact
    worst case (MAX_BLOCK_SYMBOLS).
    """
    est = payload_words * 32.0 / max(nb_total, 1) / 4.2 * margin
    for mult in (16, 24, 32, 48, 68):
        if mult >= min(est, 68):
            break
    return int(stride) * mult + 2


def prepare_batch(streams: list[bytes]):
    """Host-side prep: uniform TICX streams -> device input arrays.

    Returns None if any stream is ineligible (no/invalid TICX trailer,
    non-uniform shape/quality/tables, inadmissible dynamic table --
    :func:`canonical_tables` -- or payload too large for 31-bit
    cursors), else a dict of numpy arrays + metadata for
    :func:`entropy_decode_chunks`.  Dynamic-table streams contribute a
    ``"tables"`` entry (the canonical decode tuples) and have their
    payloads realigned to byte boundaries here (the table segment ends
    off-byte); TICX offsets are payload-relative in both layouts
    (container.py), so the chunk math is identical.
    """
    from .. import container
    from ..bitstream import BitReader, bits_to_bytes
    from ..constants import (
        FLAG_CUSTOM_TABLE,
        FLAG_SCALED_DCT,
        HEADER_BYTES,
    )

    metas = []
    h0 = None
    tables0 = None
    for data in streams:
        try:
            h, w, q, flag = container.parse_header(data)
        except Exception:
            return None
        if h0 is None:
            h0 = (h, w, q)
        elif (h, w, q) != h0:
            return None
        nb = -(-h // 8) * -(-w // 8)
        idx = container.parse_block_index(data, nb)
        if idx is None:
            return None
        off, stride, pay_end = idx
        if flag & FLAG_CUSTOM_TABLE:
            try:
                reader = BitReader(data)
                reader.seek(HEADER_BYTES * 8)
                tables = container.read_huffman_table(reader)
            except Exception:
                return None
            payload_off = reader.tell()
            if payload_off >= pay_end * 8:
                return None
            if tables0 is None:
                tables0 = tables
                # admission BEFORE any payload realignment: an
                # inadmissible table (extended-range / non-canonical /
                # >16-bit) rejects in O(table) instead of re-packing
                # every payload first
                tabs0 = canonical_tables(tables0)
                if tabs0 is None:
                    return None
            elif tables != tables0:  # one table per compiled batch
                return None
            pay_bits_true = pay_end * 8 - payload_off
            # parse_block_index's off[-1] bound over-counts by the
            # table-segment bits on custom streams; re-validate against
            # the TRUE payload length so a corrupt trailer degrades to
            # the serial host cursor instead of mis-chunking
            if off[-1] >= pay_bits_true:
                return None
            payload = bits_to_bytes(reader._bits[payload_off:pay_end * 8])
        else:
            payload = data[HEADER_BYTES:pay_end]
            pay_bits_true = len(payload) * 8
        metas.append((payload, nb, off, stride, pay_bits_true, flag))
    stride0 = metas[0][3]
    if any(m[3] != stride0 for m in metas):
        return None
    if any(m[5] != metas[0][5] for m in metas):  # uniform flags
        return None
    tabs = tabs0 if tables0 is not None else None

    word_chunks = []
    starts, blocks, bases, end_lo, end_hi, img_of = [], [], [], [], [], []
    base_bits = 0
    blk_base = 0
    for i, (payload, nb, off, stride, pay_bits_true, flag) in enumerate(
        metas
    ):
        pay_bits = len(payload) * 8
        pad = (-len(payload)) % 4
        word_chunks.append(payload + b"\x00" * pad)
        n_chunks = len(off)
        g = base_bits + off.astype(np.int64)
        starts.append(g)
        nb_in = np.full(n_chunks, stride, np.int64)
        nb_in[-1] = nb - stride * (n_chunks - 1)
        blocks.append(nb_in)
        bases.append(blk_base + np.arange(n_chunks, dtype=np.int64)
                     * stride)
        lo = np.empty(n_chunks, np.int64)
        hi = np.empty(n_chunks, np.int64)
        lo[:-1] = g[1:]
        hi[:-1] = g[1:]
        # the final cursor must land in the writer's <= 7-bit byte-align
        # pad window, measured from the TRUE payload bit length (for
        # realigned dynamic-table payloads the packbits byte padding is
        # NOT part of the stream)
        lo[-1] = base_bits + max(pay_bits_true - 7, 0)
        hi[-1] = base_bits + pay_bits_true
        end_lo.append(lo)
        end_hi.append(hi)
        img_of.append(np.full(n_chunks, i, np.int64))
        base_bits += pay_bits + pad * 8
        blk_base += nb
    # cursors and the (pos, kind) slot packing need positions < 2^28
    # bits (32 MB of payload per batch); larger batches use the host
    # entropy path
    if base_bits >= 2**28:
        return None

    raw = b"".join(word_chunks)
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    return {
        "words": words,
        "chunk_start": np.concatenate(starts).astype(np.int32),
        "chunk_blocks": np.concatenate(blocks).astype(np.int32),
        "chunk_block_base": np.concatenate(bases).astype(np.int32),
        "chunk_end_lo": np.concatenate(end_lo).astype(np.int32),
        "chunk_end_hi": np.concatenate(end_hi).astype(np.int32),
        "chunk_img": np.concatenate(img_of).astype(np.int32),
        "nb_total": blk_base,
        "nb_per_image": metas[0][1],
        "stride": int(stride0),
        "shape": h0,
        "scaled_dct": bool(metas[0][5] & FLAG_SCALED_DCT)
        and not (metas[0][5] & FLAG_CUSTOM_TABLE),
        "tables": tabs,
    }
