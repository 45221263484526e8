"""Parallel value decoding + image reconstruction.

Given per-group metadata from offset recovery (offsets.py or the "ix"
sidecar), all groups decode simultaneously: the only remaining dependency is
*within* a group (value i's position depends on lengths of values 0..i-1),
which unrolls into 16 wavefront steps, each a fully vectorized gather+table
step across every group of the image.  The per-band prefix-sum un-delta
(QB3decode.h:717-722) becomes one cumulative sum over the scan sequence, and
the band-delta add pass (QB3decode.h:729-737) one vectorized add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..constants import B, B2, curve_offsets
from ..offsets import KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL, KIND_ZERO
from .bitutils import (magsabs, magsmul, peek64, smag, step_flip_index,
                       words_u32, words_u64)
from .encode import block_origins

_DEC_GROUP_LEN = jnp.asarray(T.DEC_GROUP[:, :, 0].astype(np.int32))
_DEC_GROUP_VAL = jnp.asarray(T.DEC_GROUP[:, :, 1].astype(np.uint32))
_DEC_SINGLE_LEN = jnp.asarray(T.DEC_SINGLE[:, :, 0].astype(np.int32))
_DEC_SINGLE_VAL = jnp.asarray(T.DEC_SINGLE[:, :, 1].astype(np.uint32))
_IDX_DEC_LEN = jnp.asarray(T.IDX_DEC[:16, 0].astype(np.int32))
_IDX_DEC_VAL = jnp.asarray(T.IDX_DEC[:16, 1].astype(np.uint32))


def payload_words(payload: bytes) -> np.ndarray:
    """Payload bytes -> little-endian uint64 words with a spill word."""
    n = (len(payload) + 7) // 8 + 1
    buf = np.zeros(n * 8, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return buf.view("<u8")


def _dec_value(w, rung, use_single):
    """Branchless single-value decode at arbitrary rung -> (val u64, len).

    use_single selects the unswapped tables (CF values / uniques); otherwise
    the group-context tables apply.  Handles computed rungs >= 8 including
    the rung-63 65-bit form (caller adds the extra bit).
    """
    tr = jnp.clip(rung, 0, 7)
    ti = (w & ((jnp.uint64(1) << (tr + 2).astype(jnp.uint64)) - 1)).astype(jnp.int32)
    tl = jnp.where(use_single, _DEC_SINGLE_LEN[tr, ti], _DEC_GROUP_LEN[tr, ti])
    tv = jnp.where(use_single, _DEC_SINGLE_VAL[tr, ti], _DEC_GROUP_VAL[tr, ti]).astype(jnp.uint64)
    # computed path (QB3decode.h:119-129)
    r64 = jnp.clip(rung, 2, None).astype(jnp.uint64)
    rbit = jnp.uint64(1) << r64
    short = (w & 1) == 0
    n = (w >> 1) & 1
    v2 = (w >> 2) & (rbit - 1)
    cl = jnp.where(short, rung, rung + 1 + n.astype(jnp.int32))
    cv = jnp.where(short, (w & (rbit - 1)) >> 1,
                   jnp.where(n == 0, v2 | (rbit >> 1), v2 | rbit))
    tbl = rung <= 7
    return jnp.where(tbl, tv, cv), jnp.where(tbl, tl, cl)


def dsw_arith(w1, ubits: int):
    """Arithmetic codeswitch decode == the DSW table (tables.py _make_dsw),
    without the table, as a few selects that fuse into the caller's
    elementwise kernel.

    w1: the stream bits AFTER the change flag (w >> 1), any uint dtype.
    Returns (cs_len incl flag, delta int32), valid where the flag was 1.
    """
    W = w1.dtype
    r = ubits - 1  # plain VLC rung of the codeswitch code
    rbit = jnp.array(1 << r, W)
    short = (w1 & 1) == 0
    n = (w1 >> 1) & 1
    vmask = rbit - 1
    v = jnp.where(short, (w1 & vmask) >> 1,
        jnp.where(n == 0, ((w1 >> 2) & vmask) | (rbit >> 1),
                  ((w1 >> 2) & vmask) | rbit))
    ln = jnp.where(short, r, r + 1 + n.astype(jnp.int32)) + 1
    mag = (v >> 1).astype(jnp.int32)
    neg = (v & 1) == 1
    delta = jnp.where(neg, (-(mag + 1)) & ((1 << ubits) - 1),
                      (mag + 1) & ((1 << (ubits - 1)) - 1))
    return ln, delta


def indexed_meta(words64, glens, nblocks: int, nbands: int, ubits: int):
    """Recover per-group metadata from the "ix" sidecar, fully on device.

    FTL/BASE streams have no extended encodings, so the rung chain is a plain
    modular prefix sum of codeswitch deltas — each delta readable from the
    bits at the group's offset without knowing the incoming rung.

    glens: (nblocks*nbands,) int32 per-group bit lengths in stream order.
    Returns (kind, val_pos, vrung, cf) flat arrays matching decode_groups.
    """
    nmask = (1 << ubits) - 1
    words64 = words_u64(words64)
    ends = jnp.cumsum(glens.astype(jnp.int64))
    goff = (ends - glens).reshape(nblocks, nbands)
    w = peek64(words64, goff)
    has_cs = (w & 1) == 1
    dlen, ddelta = dsw_arith(w >> 1, ubits)
    cs_len = jnp.where(has_cs, dlen, 1)
    delta = jnp.where(has_cs, ddelta, 0)
    rung = jnp.cumsum(delta, axis=0) & nmask  # entry runbits are zero
    rung0 = rung == 0
    # the all-zero flag sits at cs_len <= 8 bits in, within the same window
    flag = ((w >> cs_len.astype(jnp.uint64)) & 1).astype(jnp.int32)
    kind = jnp.where(rung0, jnp.where(flag == 1, KIND_BITS, KIND_ZERO), KIND_NORMAL)
    val_pos = goff + cs_len.astype(jnp.int64) + jnp.where(rung0, 1, 0)
    cf = jnp.zeros_like(w)
    return (kind.reshape(-1).astype(jnp.uint8), val_pos.reshape(-1),
            rung.reshape(-1), cf.reshape(-1))


_NREG_IX = {8: 8, 16: 12, 32: 20, 64: 36}


def decode_indexed_narrow(words64, glens, nblocks: int, nbands: int,
                          apply_step: bool, tbits: int = 8, ntiles: int = 1,
                          tile_words32: int = 0, nreg: int | None = None):
    """Sidecar-indexed decode, all element widths.

    One direct gather per group loads its register window of NREG u32
    words; the codeswitch parse, rung prefix sum, and the 16-value
    wavefront all run on those windows with no further memory access.
    Groups span at most 150/280/540/1056 bits (8/12/20/36 u32 regs); 8-bit
    lanes use 32-bit value windows, wider types 64-bit windows (u64
    includes the rung-63 65-bit long form).

    ntiles > 1 decodes a batch of same-shape independent streams in one
    flat pass: the payloads are concatenated with a fixed stride of
    tile_words32 uint32 words, glens is (ntiles * nblocks * nbands,), and
    every per-tile state (bit cursor, rung chain) resets at tile boundaries.
    """
    W = jnp.uint32 if tbits <= 16 else jnp.uint64
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    nmask = (1 << ubits) - 1
    ngroups = ntiles * nblocks * nbands
    # int32 bit cursors: callers guard total bits < 2^31 (api._decode_core)
    if ntiles == 1:
        ends = jnp.cumsum(glens.astype(jnp.int32))
        goff = ends - glens  # group start bit offsets
    else:
        g2 = glens.reshape(ntiles, nblocks * nbands).astype(jnp.int32)
        ends2 = jnp.cumsum(g2, axis=1)
        tbase = (jnp.arange(ntiles, dtype=jnp.int32) * (tile_words32 * 32))
        goff = (ends2 - g2 + tbase[:, None]).reshape(-1)
    base = (goff >> 5).astype(jnp.int32)
    off0 = (goff & 31).astype(jnp.int32)
    words32 = words_u32(words64)

    # the sidecar knows this stream's true max group span (api._indexed_nreg),
    # which is usually well under the format-worst window
    NREG = nreg if nreg is not None else _NREG_IX[tbits]
    regs_arr = words32[base[:, None] + jnp.arange(NREG)[None, :]]
    regs = [regs_arr[:, i] for i in range(NREG)]
    regs += [jnp.zeros_like(base).astype(jnp.uint32),
             jnp.zeros_like(base).astype(jnp.uint32)]

    def sel(wi, k):
        out = regs[NREG - 1 + k]
        for i in range(NREG - 2, -1, -1):
            out = jnp.where(wi == i, regs[i + k], out)
        return out

    if tbits == 8:
        def window(off):
            wi = off >> 5
            sh = (off & 31).astype(jnp.uint32)
            lo = sel(wi, 0)
            hi = sel(wi, 1)
            high = jnp.where(sh == 0, jnp.uint32(0), hi << ((jnp.uint32(32) - sh) & 31))
            return (lo >> sh) | high
    else:
        def window(off):
            # 64-bit window assembled from three u32 regs
            wi = off >> 5
            sh = (off & 31).astype(jnp.uint64)
            r0 = sel(wi, 0).astype(jnp.uint64)
            r1 = sel(wi, 1).astype(jnp.uint64)
            r2 = sel(wi, 2).astype(jnp.uint64)
            w = (r0 >> sh) | (r1 << (jnp.uint64(32) - sh))
            w = jnp.where(sh == 0, r0 | (r1 << 32), w)
            w = w | jnp.where(sh == 0, jnp.uint64(0), r2 << (jnp.uint64(64) - sh))
            return w

    # codeswitch parse + rung chain (modular prefix sum per band)
    w0 = window(off0)
    has_cs = (w0 & 1) == 1
    dlen, ddelta = dsw_arith(w0 >> 1, ubits)
    cs_len = jnp.where(has_cs, dlen, 1)
    delta = jnp.where(has_cs, ddelta, 0)
    rung = (jnp.cumsum(delta.reshape(ntiles, nblocks, nbands), axis=1)
            & nmask).reshape(-1)
    rung0 = rung == 0
    flag = ((w0 >> cs_len.astype(w0.dtype)) & 1).astype(jnp.int32)
    is_bits = rung0 & (flag == 1)
    is_zero = rung0 & (flag == 0)
    is_group = ~rung0
    off = off0 + cs_len + jnp.where(rung0, 1, 0)

    per = {8: 3, 16: 3, 32: 1, 64: 1}[tbits]
    takes = np.minimum(per, B2 - np.arange(0, B2, per))

    if tbits == 8:
        # vectorized bit reader: a u64 accumulator per group, refilled with
        # one reg word (single dynamic select) per macro step.  Sound for u8
        # because a step consumes <= 27 bits < the 32-bit refill, and the
        # refill shift (navail < 27) keeps the word inside the accumulator.
        def selreg(k):
            out = regs[NREG]  # zero pad
            for i in range(NREG - 1, -1, -1):
                out = jnp.where(k == i, regs[i], out)
            return out.astype(jnp.uint64)

        k0 = off >> 5
        acc0 = (selreg(k0) | (selreg(k0 + 1) << 32)) >> (off & 31).astype(jnp.uint64)
        navail0 = 64 - (off & 31)
        k0 = k0 + 2

        def body(carry, take):
            acc, navail, k = carry
            shift = jnp.zeros_like(navail)
            outs = []
            for t in range(per):
                ww = (acc >> shift.astype(jnp.uint64)).astype(W)
                gv, gl = _vlc_decode_arith(ww, rung, W)
                v = jnp.where(is_group, gv, jnp.where(is_bits, ww & 1, W(0)))
                ln = jnp.where(is_group, gl, jnp.where(is_bits, 1, 0))
                live = t < take
                outs.append(jnp.where(live, v, 0))
                shift = shift + jnp.where(live, ln, 0)
            acc = acc >> shift.astype(jnp.uint64)
            navail = navail - shift
            need = navail < 27
            fill = jnp.where(need, selreg(k), jnp.uint64(0))
            acc = acc | (fill << navail.astype(jnp.uint64))
            navail = navail + jnp.where(need, 32, 0)
            k = k + jnp.where(need, 1, 0)
            return (acc, navail, k), jnp.stack(outs, axis=-1)

        _, vals = jax.lax.scan(body, (acc0, navail0, k0), jnp.asarray(takes))
    else:
        def body(off, take):
            w = window(off)
            shift = jnp.zeros_like(off)
            outs = []
            for t in range(per):
                ww = (w >> shift.astype(w.dtype)).astype(W)
                gv, gl = _vlc_decode_arith(ww, rung, W)
                if tbits == 64:
                    # rung-63 long form is 65 bits; bit 62 of the value is
                    # the stream bit just past the 64-bit window
                    ovf = is_group & (gl == 65)
                    extra = window(off + shift + 64) & 1
                    gv = gv | jnp.where(ovf, extra << 62, jnp.uint64(0))
                v = jnp.where(is_group, gv, jnp.where(is_bits, ww & 1, W(0)))
                ln = jnp.where(is_group, gl, jnp.where(is_bits, 1, 0))
                live = t < take
                outs.append(jnp.where(live, v, 0))
                shift = shift + jnp.where(live, ln, 0)
            return (off + shift).astype(jnp.int32), jnp.stack(outs, axis=-1)

        _, vals = jax.lax.scan(body, off, jnp.asarray(takes))
    g = jnp.moveaxis(vals, 0, 1).reshape(ngroups, -1)[:, :B2]
    if apply_step:
        match, ones = step_flip_index(g, rung)
        lane = jnp.arange(B2, dtype=jnp.int32)
        do = is_group & match & (rung >= 1)
        flip = do[:, None] & (lane[None, :] == ones[:, None]) & (ones[:, None] < B2)
        g = g ^ (jnp.where(flip, 1, 0).astype(W) << rung[:, None].astype(W))
    return g


def _vlc_decode_arith(w, rung, W):
    """Arithmetic group-context VLC decode: base 3-range code + value swap.

    The decode tables are the inverse of (swap ∘ vlc); since the swap is an
    involution, decode == swap(vlc_decode(bits)).  Valid for rung >= 1; the
    rung-0 class never reaches here.
    """
    one = jnp.ones((), W)
    r = jnp.maximum(rung, 1)
    rw = r.astype(W)
    rbit = one << rw
    short = (w & 1) == 0
    n = (w >> 1) & 1
    vmask = rbit - 1
    v = jnp.where(short, (w & vmask) >> 1,
        jnp.where(n == 0, ((w >> 2) & vmask) | (rbit >> 1),
                  ((w >> 2) & vmask) | rbit))
    ln = jnp.where(short, r, r + 1 + n.astype(jnp.int32))
    # group-context swap (rung 1: 1<->2, rung 2: 3<->4, 3..7: 2^r-1<->2^r)
    a = jnp.where(r == 1, one, jnp.where(r == 2, one * 3,
                  (one << jnp.clip(rw, 0, 7)) - 1))
    do_swap = r <= 7
    v = jnp.where(do_swap & (v == a), a + 1,
        jnp.where(do_swap & (v == a + 1), a, v))
    return v, ln


def decode_groups_regwindow(words64, kind, val_pos, vrung, cf, apply_step: bool,
                            tbits: int):
    """Gather-minimal wavefront for 8/16-bit FTL/BASE streams.

    A whole 8-bit group spans at most 149 bits (16-bit: 279), so 4 (resp. 6)
    aligned 64-bit words cover it from any phase.  Those are gathered once
    per group; all 16 value windows then come from funnel shifts over the
    in-register words — the per-value loop does no memory access at all.
    """
    W = jnp.uint32
    is_bits = kind == KIND_BITS
    is_group = kind == KIND_NORMAL

    if tbits == 8:
        # uint32 lanes throughout: 8 aligned u32 regs cover the 149-bit span;
        # each derived 32-bit window yields 3 values (codes <= 9 bits)
        words32 = words_u32(words64)
        base = (val_pos >> 5).astype(jnp.int32)
        nregs = 8
        regs = [words32[base + i] for i in range(nregs)]
        regs.append(jnp.zeros_like(regs[0]))
        off0 = (val_pos & 31).astype(jnp.int32)
        wshift, wmask = 5, 31

        def window(off):
            wi = off >> wshift
            sh = (off & wmask).astype(W)
            lo = regs[nregs - 1]
            hi = regs[nregs]
            for i in range(nregs - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            high = jnp.where(sh == 0, W(0), hi << ((W(32) - sh) & wmask))
            return (lo >> sh) | high
    else:
        # 6 aligned u64 regs cover the 279-bit span; 3 values per 64-bit window
        words64 = words_u64(words64)
        base = (val_pos >> 6).astype(jnp.int32)
        nregs = 6
        regs = [words64[base + i] for i in range(nregs)]
        regs.append(jnp.zeros_like(regs[0]))
        off0 = (val_pos & 63).astype(jnp.int32)

        def window(off):
            wi = off >> 6
            sh = (off & 63).astype(jnp.uint64)
            lo = regs[nregs - 1]
            hi = regs[nregs]
            for i in range(nregs - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            high = jnp.where(sh == 0, jnp.uint64(0),
                             hi << ((jnp.uint64(64) - sh) & 63))
            return (lo >> sh) | high

    per = 3  # values decoded per window (3 * max code len fits the window)

    def body(off, take):
        w = window(off)
        shift = jnp.zeros_like(off)
        outs = []
        for t in range(per):
            ww = (w >> shift.astype(w.dtype)).astype(W)
            gv, gl = _vlc_decode_arith(ww, vrung, W)
            v = jnp.where(is_group, gv, jnp.where(is_bits, ww & 1, jnp.uint32(0)))
            ln = jnp.where(is_group, gl, jnp.where(is_bits, 1, 0))
            live = t < take
            outs.append(jnp.where(live, v, 0))
            shift = shift + jnp.where(live, ln, 0)
        return (off + shift).astype(jnp.int32), jnp.stack(outs, axis=-1)

    takes = np.minimum(per, B2 - np.arange(0, B2, per))
    off, vals = jax.lax.scan(body, off0, jnp.asarray(takes))
    g = jnp.moveaxis(vals, 0, 1).reshape(kind.shape[0], -1)[:, :B2]
    pos = val_pos + (off - off0).astype(jnp.int64)
    if apply_step:
        match, ones = step_flip_index(g, vrung)
        lane = jnp.arange(B2, dtype=jnp.int32)
        do = is_group & match & (vrung >= 1)
        flip = do[:, None] & (lane[None, :] == ones[:, None]) & (ones[:, None] < B2)
        g = g ^ (jnp.where(flip, 1, 0).astype(W) << vrung[:, None].astype(W))
    return g, pos


def _vlc_decode_plain(w, rung, W):
    """Base 3-range decode with NO swap (index codes; tables.py IDX_DEC)."""
    one = jnp.ones((), W)
    r = jnp.maximum(rung, 1)
    rw = r.astype(W)
    rbit = one << rw
    short = (w & 1) == 0
    n = (w >> 1) & 1
    vmask = rbit - 1
    v = jnp.where(short, (w & vmask) >> 1,
        jnp.where(n == 0, ((w >> 2) & vmask) | (rbit >> 1),
                  ((w >> 2) & vmask) | rbit))
    return v, jnp.where(short, r, r + 1 + n.astype(jnp.int32))


def _vlc_decode_single(w, rung, W):
    """Single-value context decode: plain VLC + the rung 3..7 middle swap
    (CF values, index uniques; tables.py DEC_SINGLE)."""
    v, ln = _vlc_decode_plain(w, rung, W)
    a = (jnp.ones((), W) << jnp.clip(rung, 0, 7).astype(W)) - 1
    do = (rung >= 3) & (rung <= 7)
    v = jnp.where(do & (v == a), a + 1, jnp.where(do & (v == a + 1), a, v))
    # rung 0: one literal bit
    return (jnp.where(rung == 0, w & 1, v),
            jnp.where(rung == 0, 1, ln))


def decode_groups_fused(words64, kind, val_pos, vrung, cf, apply_step: bool,
                        tbits: int):
    """Register-window wavefront for 8/16-bit streams INCLUDING the extended
    encodings (CF/index groups): one direct gather per group, then the
    16-value walk + the uniques pass run on in-register windows.  Replaces
    decode_groups' per-element peek64 gathers on the hot best-mode path.
    """
    W = jnp.uint32
    ngroups = kind.shape[0]
    is_zero = kind == KIND_ZERO
    onebit = (kind == KIND_BITS) | (kind == KIND_CF0)
    is_idx = kind == KIND_IDX
    is_group = (kind == KIND_NORMAL) | (kind == KIND_CF)

    # whole-group span incl. uniques fits NREG words from any 32-bit phase
    NREG = 8 if tbits == 8 else 14
    base = (val_pos >> 5).astype(jnp.int32)
    off0 = (val_pos & 31).astype(jnp.int32)
    words32 = words_u32(words64)
    regs_arr = words32[base[:, None] + jnp.arange(NREG)[None, :]]
    regs = [regs_arr[:, i] for i in range(NREG)]
    regs += [jnp.zeros_like(regs[0]), jnp.zeros_like(regs[0])]

    if tbits == 8:
        def window(off):
            wi = off >> 5
            sh = (off & 31).astype(W)
            lo = regs[NREG - 1]
            hi = regs[NREG]
            for i in range(NREG - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            return (lo >> sh) | jnp.where(sh == 0, W(0), hi << ((W(32) - sh) & 31))
    else:
        def window(off):
            wi = off >> 5
            sh = (off & 31).astype(jnp.uint64)
            lo = regs[NREG - 1]
            hi = regs[NREG]
            w2 = regs[NREG + 1]
            for i in range(NREG - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            for i in range(NREG - 3, -1, -1):
                w2 = jnp.where(wi == i, regs[i + 2], w2)
            w = lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << 32)
            w = w >> sh
            return w | jnp.where(sh == 0, jnp.uint64(0),
                                 w2.astype(jnp.uint64) << ((jnp.uint64(64) - sh) & 63))

    per = 3
    takes = np.minimum(per, B2 - np.arange(0, B2, per))

    def body(off, take):
        w = window(off)
        shift = jnp.zeros_like(off)
        outs = []
        for t in range(per):
            ww = (w >> shift.astype(w.dtype)).astype(W)
            gv, gl = _vlc_decode_arith(ww, vrung, W)
            iv, il = _vlc_decode_plain(ww, jnp.full_like(vrung, 2), W)
            v = jnp.where(is_group, gv,
                jnp.where(is_idx, iv,
                jnp.where(onebit, ww & 1, W(0))))
            ln = jnp.where(is_group, gl,
                 jnp.where(is_idx, il,
                 jnp.where(onebit, 1, 0)))
            live = t < take
            outs.append(jnp.where(live, v, 0))
            shift = shift + jnp.where(live, ln, 0)
        return (off + shift).astype(jnp.int32), jnp.stack(outs, axis=-1)

    off, vals = jax.lax.scan(body, off0, jnp.asarray(takes))
    g = jnp.moveaxis(vals, 0, 1).reshape(ngroups, -1)[:, :B2]

    # uniques pass for index groups (<= 8 singles at vrung)
    maxidx = jnp.max(jnp.where(is_idx[:, None], g, 0), axis=-1).astype(jnp.int32)

    def ubody(off, u):
        live = is_idx & (u <= maxidx)
        w = window(off)
        uv, ul = _vlc_decode_single(w.astype(W) if tbits == 8 else
                                    (w & jnp.uint64(0xFFFFFFFF)).astype(W),
                                    vrung, W)
        return (off + jnp.where(live, ul, 0)).astype(jnp.int32), \
            jnp.where(live, uv, 0)

    off, uniqs = jax.lax.scan(ubody, off, jnp.arange(B2 // 2))
    uq = jnp.moveaxis(uniqs, 0, -1)  # (n, 8)
    gi = jnp.sum(jnp.where(
        (jnp.clip(g, 0, 7).astype(jnp.int32)[..., None]
         == jnp.arange(B2 // 2, dtype=jnp.int32)[None, None, :]),
        uq[:, None, :], 0), axis=-1)
    g = jnp.where(is_idx[:, None], gi, g)

    # step restore (CF always; NORMAL unless FTL)
    restore = (kind == KIND_CF) if not apply_step else is_group
    match, ones = step_flip_index(g, vrung)
    lane = jnp.arange(B2, dtype=jnp.int32)
    do = restore & match & (vrung >= 1)
    flip = do[:, None] & (lane[None, :] == ones[:, None]) & (ones[:, None] < B2)
    g = g ^ (jnp.where(flip, 1, 0).astype(W) << vrung[:, None].astype(W))

    # CF multiply-back / CF0 expansion, masked to the element width
    cfv = cf.astype(W)
    mask = W((1 << tbits) - 1)
    mm = (magsabs(g) * (cfv[:, None] << 1) - (g & 1)) & mask
    g = jnp.where((kind == KIND_CF)[:, None], mm, g)
    neg = (((cfv - 1) << 1) | 1) & mask
    g = jnp.where((kind == KIND_CF0)[:, None],
                  jnp.where(g != 0, neg[:, None], 0), g)
    return g


def decode_groups(words64, kind, val_pos, vrung, cf, apply_step: bool,
                  has_extended: bool = True):
    """Wavefront decode of all groups -> mag-sign values (n, B2) uint64.

    words64: stream; kind/val_pos/vrung/cf: flat (n,) metadata arrays.
    has_extended=False (FTL/BASE streams) statically removes the index/CF
    handling from the graph.
    """
    n = kind.shape[0]
    words64 = words_u64(words64)
    pos = val_pos.astype(jnp.int64)
    is_zero = kind == KIND_ZERO
    is_bits = kind == KIND_BITS
    is_cf0 = kind == KIND_CF0
    is_idx = kind == KIND_IDX
    is_group = (kind == KIND_NORMAL) | (kind == KIND_CF)
    onebit = is_bits | is_cf0

    def body(pos, _):
        w = peek64(words64, pos)
        gv, gl = _dec_value(w, vrung, jnp.zeros_like(is_zero))
        # rung-63 long form: 65 bits, the 65th is bit 62 of the value (which
        # is always 0 in the 64-bit part).  NB: the equivalent
        # `(gv & ~(1<<62)) | (extra << 62)` miscompiles under XLA:CPU
        # vectorization (jit != eager); keep the plain OR form.
        ovf = is_group & (gl == 65)
        extra = peek64(words64, pos + 64) & 1
        gv = gv | jnp.where(ovf, extra << 62, jnp.uint64(0))
        il, iv = _IDX_DEC_LEN[(w & 15).astype(jnp.int32)], _IDX_DEC_VAL[(w & 15).astype(jnp.int32)]
        v = jnp.where(is_group, gv,
            jnp.where(is_idx, iv.astype(jnp.uint64),
            jnp.where(onebit, w & 1, jnp.uint64(0))))
        ln = jnp.where(is_group, gl,
             jnp.where(is_idx, il,
             jnp.where(onebit, 1, 0)))
        return pos + ln, v

    pos, vals = jax.lax.scan(body, pos, None, length=B2)
    g = jnp.moveaxis(vals, 0, -1)  # (n, B2)

    if has_extended:
        # index groups: decode up to 8 uniques at the running position
        maxidx = jnp.max(jnp.where(is_idx[:, None], g, 0), axis=-1).astype(jnp.int32)

        def ubody(pos, u):
            live = is_idx & (u <= maxidx)
            w = peek64(words64, pos)
            uv, ul = _dec_value(w, vrung, jnp.ones_like(is_zero))
            return pos + jnp.where(live, ul, 0), jnp.where(live, uv, 0)

        pos, uniqs = jax.lax.scan(ubody, pos, jnp.arange(B2 // 2))
        uq = jnp.moveaxis(uniqs, 0, -1)  # (n, 8)
        gi = jnp.take_along_axis(uq, jnp.clip(g, 0, 7).astype(jnp.int32), axis=-1)
        g = jnp.where(is_idx[:, None], gi, g)

    # step restore for group-coded kinds (QB3decode.h:285-289): CF groups
    # always, normal groups unless FTL
    restore = (kind == KIND_CF) if not apply_step else is_group
    match, ones = step_flip_index(g, vrung)
    lane = jnp.arange(B2, dtype=jnp.int32)
    do = restore & match & (vrung >= 1)
    flip = do[:, None] & (lane[None, :] == ones[:, None]) & (ones[:, None] < B2)
    g = g ^ (jnp.where(flip, 1, 0).astype(jnp.uint64) << vrung[:, None].astype(jnp.uint64))

    if has_extended:
        # CF groups: multiply back; CF0: value is mags(-cf) per set bit
        cfv = cf.astype(jnp.uint64)
        g = jnp.where((kind == KIND_CF)[:, None], magsmul(g, cfv[:, None]), g)
        neg = ((cfv - 1) << 1) | 1
        g = jnp.where(is_cf0[:, None], jnp.where(g != 0, neg[:, None], 0), g)
    # BITS groups: value bits decode as 0/1 mag-sign directly
    return g, pos


def _undelta_cumsum_blocks(s, tbits: int):
    """Hierarchical scan-order prefix sum of mag-sign deltas, block-major.

    s: (..., nblocks, C, B2) uint64 (leading tile axes allowed).  The scan
    sequence per band is blocks-major-then-lanes; rather than transposing to
    the (C, nblocks*B2) layout (a full-tensor relayout), the prefix
    decomposes into an in-lane cumsum plus a block-level carry chain, all
    in the native layout.  Exact mod 2^tbits: u32 planes
    with single-add wrap counting (truncation commutes with addition).
    Returns (lo, hi-or-None) u32 planes of the inclusive prefix, same shape.
    """
    bax, lax_ = -3, -1  # block axis, lane axis
    if tbits <= 32:
        lo = s.astype(jnp.uint32)
        cl = jnp.cumsum(lo, axis=lax_)
        tl = cl[..., B2 - 1]  # (..., nblocks, C) block totals
        ctl = jnp.cumsum(tl, axis=-2)
        zshape = ctl.shape[:-2] + (1,) + ctl.shape[-1:]
        carry = jnp.concatenate(
            [jnp.zeros(zshape, jnp.uint32), ctl[..., :-1, :]], axis=-2)
        return cl + carry[..., None], None
    lo = s.astype(jnp.uint32)
    hi = (s >> 32).astype(jnp.uint32)
    cl = jnp.cumsum(lo, axis=lax_)
    wr = jnp.cumsum((cl < lo).astype(jnp.uint32), axis=lax_)
    ch = jnp.cumsum(hi, axis=lax_) + wr
    tl = cl[..., B2 - 1]
    th = ch[..., B2 - 1]
    ctl = jnp.cumsum(tl, axis=-2)
    cwr = jnp.cumsum((ctl < tl).astype(jnp.uint32), axis=-2)
    cth = jnp.cumsum(th, axis=-2) + cwr
    zshape = ctl.shape[:-2] + (1,) + ctl.shape[-1:]
    z = jnp.zeros(zshape, jnp.uint32)
    carry_lo = jnp.concatenate([z, ctl[..., :-1, :]], axis=-2)[..., None]
    carry_hi = jnp.concatenate([z, cth[..., :-1, :]], axis=-2)[..., None]
    flo = cl + carry_lo
    fhi = ch + carry_hi + (flo < cl).astype(jnp.uint32)
    return flo, fhi


def reconstruct_batch(groups, h: int, w: int, nbands: int, order: int,
                      cband: tuple[int, ...], out_dtype):
    """Flat multi-tile reconstruct: (ntiles, nblocks, C, B2) mag-sign groups
    -> (ntiles, H, W, C) images, 4-aligned tiles, fresh band state per tile.

    One cumsum over a (ntiles, C, nblocks*B2) layout un-deltas every tile at
    once; this is pure reshapes around the same math as `reconstruct`.
    """
    assert h % B == 0 and w % B == 0, "batch reconstruct requires aligned tiles"
    tbits = np.iinfo(out_dtype).bits
    ntiles, nblocks = groups.shape[0], groups.shape[1]
    # hierarchical block-major prefix per tile (see _undelta_cumsum_blocks)
    clo, chi = _undelta_cumsum_blocks(smag(groups), tbits)

    offs = curve_offsets(order)
    lane_of = np.zeros((B, B), dtype=np.int32)
    for i, (dy, dx) in enumerate(offs):
        lane_of[dy, dx] = i
    inv = lane_of.reshape(-1)

    def relayout(v):
        t = v[:, :, :, inv].reshape(ntiles, h // B, w // B, nbands, B, B)
        return t.transpose(0, 1, 4, 2, 5, 3).reshape(ntiles, h, w, nbands)

    if chi is None:
        img = relayout(clo).astype(out_dtype)
    else:
        img = (relayout(clo).astype(jnp.uint64)
               | (relayout(chi).astype(jnp.uint64) << 32)).astype(out_dtype)
    cb = np.asarray(cband, dtype=np.int32)
    add = cb != np.arange(nbands)
    core = img[:, :, :, cb]
    return img + core * jnp.asarray(add.astype(out_dtype))[None, None, None, :]


def reconstruct(groups, entry_prev, h: int, w: int, nbands: int, order: int,
                cband: tuple[int, ...], out_dtype):
    """Mag-sign groups (nblocks, C, B2) -> (H, W, C) image.

    Prefix-sum un-delta in scan order, inverse scan gather (later blocks win
    on the overlapped edge pixels, matching the serial write order), then the
    band-delta add pass.
    """
    tbits = np.iinfo(out_dtype).bits
    nblocks = groups.shape[0]
    # hierarchical block-major prefix (no transpose to the sequence layout)
    clo, chi = _undelta_cumsum_blocks(smag(groups), tbits)
    ep = entry_prev.astype(jnp.uint64)
    elo = ep.astype(jnp.uint32)[None, :, None]
    if chi is None:
        clo = clo + elo
        exit_prev = clo[-1, :, B2 - 1]
    else:
        ehi = (ep >> 32).astype(jnp.uint32)[None, :, None]
        nlo = clo + elo
        chi = chi + ehi + (nlo < clo).astype(jnp.uint32)
        clo = nlo
        exit_prev = (clo[-1, :, B2 - 1].astype(jnp.uint64)
                     | (chi[-1, :, B2 - 1].astype(jnp.uint64) << 32))

    offs = curve_offsets(order)
    lane_of = np.zeros((B, B), dtype=np.int32)
    for i, (dy, dx) in enumerate(offs):
        lane_of[dy, dx] = i
    if h % B == 0 and w % B == 0:
        # aligned: static inverse curve permutation + layout transposes
        # (64-bit: per u32 plane)
        inv = lane_of.reshape(-1)  # lane index for raster position dy*B+dx

        def relayout(v):
            t = v[:, :, inv].reshape(h // B, w // B, nbands, B, B)
            return t.transpose(0, 3, 1, 4, 2).reshape(h, w, nbands)

        if tbits == 64:
            lo = relayout(clo).astype(jnp.uint64)
            hi = relayout(chi).astype(jnp.uint64)
            img = (lo | (hi << 32)).astype(out_dtype)
        else:
            img = relayout(clo.astype(out_dtype))
    else:
        vals = (clo if chi is None else
                clo.astype(jnp.uint64)
                | (chi.astype(jnp.uint64) << 32)).astype(out_dtype)
        vals = vals.transpose(1, 0, 2)  # (C, nblocks, B2)
        ys = block_origins(h)
        xs = block_origins(w)
        nby, nbx = len(ys), len(xs)
        # pixel -> providing block (the last block in scan order wins on overlap)
        py = np.arange(h)
        px = np.arange(w)
        by = np.minimum(py // B, nby - 1)
        by = np.where(py >= ys[-1], nby - 1, by)
        bx = np.minimum(px // B, nbx - 1)
        bx = np.where(px >= xs[-1], nbx - 1, bx)
        lane = lane_of[(py[:, None] - ys[by][:, None]), (px[None, :] - xs[bx][None, :])]
        bidx = by[:, None] * nbx + bx[None, :]  # (h, w)
        img = vals[:, bidx, lane]  # (C, H, W)
        img = jnp.transpose(img, (1, 2, 0))
    # band-delta add pass (QB3decode.h:729-737)
    cb = np.asarray(cband, dtype=np.int32)
    add = cb != np.arange(nbands)
    core = img[:, :, cb]
    img = img + core * jnp.asarray(add.astype(out_dtype))[None, None, :]
    return img, exit_prev

