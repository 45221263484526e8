"""Self-contained parallel decode from the compact "ic" chunked index.

The full "ix" sidecar stores one u16 bit length per group (~19% of an 8-bit
stream).  The "ic" chunk instead anchors every K blocks: a u32 span (the
chunk's total bits) plus the per-band entry rung state — 4+nbands bytes per
K*nbands groups (~1% of the stream).  Decode then runs chunk-parallel: all
chunks walk their K blocks simultaneously; within a chunk the groups decode
sequentially with register-window bit reads, which is exactly the serial
dependency the reference decoder has (QB3decode.h:603-723) but carried by
thousands of vector lanes at once instead of one scalar cursor.

FTL/BASE streams only (no extended encodings), any dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import B2
from .decode import _vlc_decode_arith, dsw_arith
from .bitutils import step_flip_index, words_u32

# static register-window sizes per element width: cover one group's worst
# span (prefix + 16 codes [+ overflow bits]) from any 32-bit phase
_NREG = {8: 7, 16: 11, 32: 20, 64: 36}
# values decoded per 64-bit window (per * max_code_bits <= 64)
_PER = {8: 6, 16: 3, 32: 1, 64: 1}

IC_DEFAULT_K = 8  # blocks per chunk (sidecar under 2% of an u8 stream)
_IC_WIDE = 0x8000  # k_blocks flag: u32 spans (chunk spans can exceed 65535)
_IC_BEST = 0x4000  # k_blocks flag: best-mode anchors (adds per-band pcf)


def pack_ic(spans: np.ndarray, entry: np.ndarray, k_blocks: int) -> bytes:
    """Serialize the "ic" chunk payload: u16le k_blocks (bit 15 set when the
    spans need u32), per-chunk u16le/u32le bit spans, then per-chunk
    per-band entry rung bytes."""
    wide = spans.size and int(spans.max()) > 0xFFFF
    head = int(k_blocks) | (_IC_WIDE if wide else 0)
    return (head.to_bytes(2, "little")
            + spans.astype("<u4" if wide else "<u2").tobytes()
            + entry.astype(np.uint8).tobytes())


def parse_ic(buf: bytes, nblocks: int, nbands: int):
    """Inverse of pack_ic -> (k_blocks, starts int64 (nchunks,),
    entry (nchunks, nbands) int32, total_bits), or None if inconsistent."""
    if len(buf) < 2:
        return None
    head = int.from_bytes(buf[:2], "little")
    k = head & ~(_IC_WIDE | _IC_BEST)
    wide = bool(head & _IC_WIDE)
    if k < 1 or head & _IC_BEST:  # best anchors: parse_ic_best
        return None
    nchunks = -(-nblocks // k)
    sbytes = 4 if wide else 2
    if len(buf) != 2 + nchunks * (sbytes + nbands):
        return None
    spans = np.frombuffer(buf, dtype="<u4" if wide else "<u2",
                          count=nchunks, offset=2).astype(np.int64)
    entry = np.frombuffer(buf, dtype=np.uint8,
                          offset=2 + sbytes * nchunks).reshape(nchunks, nbands)
    ends = np.cumsum(spans)
    starts = ends - spans
    if ends[-1] >= 1 << 31:  # int32 bit cursors in the device walk
        return None
    return k, starts, entry.astype(np.int32), int(ends[-1])


def chunk_spans(glens: np.ndarray, rungs: np.ndarray, entry_runbits: np.ndarray,
                k_blocks: int):
    """Host-side "ic" payload pieces from the encoder's per-group lengths and
    per-block rung tensor.

    glens: (nblocks*nbands,) bit length per group in stream order;
    rungs: (nblocks, nbands) running runbits state AFTER each block;
    entry_runbits: (nbands,) state before the image.
    Returns (spans u32 (nchunks,), entry (nchunks, nbands) u8).
    """
    nblocks, nbands = rungs.shape
    nchunks = -(-nblocks // k_blocks)
    g = np.zeros(nchunks * k_blocks * nbands, np.int64)
    g[: glens.size] = glens
    spans = g.reshape(nchunks, -1).sum(axis=1).astype(np.uint32)
    entry = np.empty((nchunks, nbands), np.uint8)
    entry[0] = entry_runbits
    entry[1:] = rungs[k_blocks - 1 : (nchunks - 1) * k_blocks : k_blocks]
    return spans, entry


def decode_chunked(words64, starts, entry_rungs, k_blocks: int, nblocks: int,
                   nbands: int, apply_step: bool, tbits: int):
    """Chunk-parallel wavefront decode -> mag-sign groups (nblocks*nbands, B2).

    words64: padded stream words; starts: (nchunks,) int32 absolute bit
    offset of each chunk; entry_rungs: (nchunks, nbands) int32 runbits state
    at each chunk entry.  k_blocks/nblocks/nbands/tbits static.
    """
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    nmask = (1 << ubits) - 1
    lmask = (1 << (ubits + 1)) - 1
    NREG = _NREG[tbits]
    per = _PER[tbits]
    nchunks = starts.shape[0]

    words32 = words_u32(words64)
    n32 = words32.shape[0]

    def group_step(off, rung_band):
        """Decode one group per chunk lane at bit offsets `off` with incoming
        per-band runbits `rung_band`; returns (g, new_off, new_rung)."""
        base = jnp.clip(off >> 5, 0, n32 - NREG)
        regs_arr = words32[base[:, None] + jnp.arange(NREG)[None, :]]
        regs = [regs_arr[:, i] for i in range(NREG)]
        regs += [jnp.zeros_like(regs[0]), jnp.zeros_like(regs[0])]
        phase = off - (base << 5)  # == off & 31 except in the clipped tail

        def window(o):
            """64 stream bits at chunk-relative offset o (o in [0, 32*NREG))."""
            wi = o >> 5
            sh = (o & 31).astype(jnp.uint32)
            lo = regs[NREG - 1]
            hi = regs[NREG]
            for i in range(NREG - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            lo = lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << 32)
            # third word for the shifted high part
            w2 = regs[NREG]
            for i in range(NREG - 3, -1, -1):
                w2 = jnp.where(wi == i, regs[i + 2], w2)
            out = lo >> sh.astype(jnp.uint64)
            out = out | jnp.where(sh == 0, jnp.uint64(0),
                                  w2.astype(jnp.uint64) << ((jnp.uint64(64) - sh.astype(jnp.uint64)) & 63))
            return out

        # ---- codeswitch parse (QB3decode.h:613-618)
        w0 = window(phase)
        has_cs = (w0 & 1) == 1
        dlen, ddelta = dsw_arith(w0 >> 1, ubits)
        cs_len = jnp.where(has_cs, dlen, 1)
        delta = jnp.where(has_cs, ddelta, 0)
        rung = (rung_band + delta) & nmask
        rung0 = rung == 0
        flag = ((w0 >> cs_len.astype(jnp.uint64)) & 1).astype(jnp.int32)
        is_bits = rung0 & (flag == 1)
        is_group = ~rung0
        o = phase + cs_len + jnp.where(rung0, 1, 0)

        # ---- 16-value wavefront, `per` values per 64-bit window
        outs16 = []
        for v0 in range(0, B2, per):
            take = min(per, B2 - v0)
            w = window(o)
            shift = jnp.zeros_like(o)
            for t in range(take):
                ww = (w >> shift.astype(jnp.uint64))
                if tbits <= 16:
                    gv, gl = _vlc_decode_arith(ww.astype(jnp.uint32), rung, jnp.uint32)
                else:
                    gv, gl = _vlc_decode_arith(ww, rung, jnp.uint64)
                if tbits == 64:
                    # rung-63 long form: 65 bits, bit 62 of the value is the
                    # stream bit right after the 64-bit code part
                    ovf = gl == 65
                    extra = (window(o + shift + 64) & 1)
                    gv = gv | jnp.where(ovf & is_group, extra << 62, jnp.uint64(0))
                v = jnp.where(is_group, gv,
                              jnp.where(is_bits, (ww & 1).astype(gv.dtype), 0))
                ln = jnp.where(is_group, gl, jnp.where(is_bits, 1, 0))
                outs16.append(v)
                shift = shift + ln
            o = o + shift
        g = jnp.stack(outs16, axis=-1)  # (nchunks, B2)

        if apply_step:
            match, ones = step_flip_index(g, rung)
            lane = jnp.arange(B2, dtype=jnp.int32)
            do = is_group & match & (rung >= 1)
            flip = do[:, None] & (lane[None, :] == ones[:, None]) & (ones[:, None] < B2)
            g = g ^ (jnp.where(flip, 1, 0).astype(g.dtype) << rung[:, None].astype(g.dtype))
        return g, off + (o - phase), rung

    def block_step(carry, _):
        off, rungs = carry
        gs = []
        new_rungs = []
        for band in range(nbands):
            g, off, r = group_step(off, rungs[:, band])
            gs.append(g)
            new_rungs.append(r)
        rungs = jnp.stack(new_rungs, axis=1)
        return (off, rungs), jnp.stack(gs, axis=1)  # (nchunks, nbands, B2)

    (off, _), vals = jax.lax.scan(
        block_step, (starts.astype(jnp.int32), entry_rungs.astype(jnp.int32)),
        None, length=k_blocks)
    # (k_blocks, nchunks, nbands, B2) -> (nblocks, nbands, B2)
    g = jnp.moveaxis(vals, 0, 1).reshape(nchunks * k_blocks, nbands, B2)
    return g[:nblocks].reshape(nblocks * nbands, B2)


# -------------------------------------------------- best-mode chunk walk

# register window sizes covering one BEST group's worst span (prefix with
# SIGNAL + cf header + 16 values + 8 uniques) from any 32-bit phase
_NREG_BEST = {8: 10, 16: 17, 32: 29, 64: 53}


def decode_chunked_best(words64, starts, entry_rungs, entry_pcf,
                        k_blocks: int, nblocks: int, nbands: int,
                        tbits: int):
    """Chunk-parallel walk for CF/index (best-mode) streams.

    Extends decode_chunked with the extended encodings
    (QB3decode.h:624-716): SIGNAL codeswitch detection, CF groups (second
    flagless codeswitch, optional own-rung CF code, per-band pcf chain,
    multiply-back, runbits recomputed from the restored group), CF0
    expansion and index groups (16 rung-2 indices + uniques).  Outputs
    FINAL mag-sign values: reconstruct needs no kind metadata.

    entry_pcf: (nchunks, nbands) int32 biased CF state (cf - 2) at each
    chunk entry.  Step restore (best modes are BASE-scan) is applied here.
    """
    from .bitutils import magsabs, topbit
    from .decode import _vlc_decode_plain, _vlc_decode_single

    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    nmask = (1 << ubits) - 1
    NREG = _NREG_BEST[tbits]
    per = _PER[tbits]
    nchunks = starts.shape[0]
    W = jnp.uint32 if tbits <= 16 else jnp.uint64
    VW = jnp.uint64  # value accumulation width (uniform carrier)

    words32 = words_u32(words64)
    n32 = words32.shape[0]

    def group_step(off, rung_band, pcf_band):
        base = jnp.clip(off >> 5, 0, n32 - NREG)
        regs_arr = words32[base[:, None] + jnp.arange(NREG)[None, :]]
        regs = [regs_arr[:, i] for i in range(NREG)]
        regs += [jnp.zeros_like(regs[0]), jnp.zeros_like(regs[0])]
        phase = off - (base << 5)

        def window(o):
            wi = o >> 5
            sh = (o & 31).astype(jnp.uint32)
            lo = regs[NREG - 1]
            hi = regs[NREG]
            for i in range(NREG - 2, -1, -1):
                lo = jnp.where(wi == i, regs[i], lo)
                hi = jnp.where(wi == i, regs[i + 1], hi)
            lo = lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << 32)
            w2 = regs[NREG]
            for i in range(NREG - 3, -1, -1):
                w2 = jnp.where(wi == i, regs[i + 2], w2)
            out = lo >> sh.astype(jnp.uint64)
            return out | jnp.where(
                sh == 0, jnp.uint64(0),
                w2.astype(jnp.uint64) << ((jnp.uint64(64) - sh.astype(jnp.uint64)) & 63))

        # ---- codeswitch parse + SIGNAL detection (QB3decode.h:613-624)
        w0 = window(phase)
        has_cs = (w0 & 1) == 1
        dlen, ddelta = dsw_arith(w0 >> 1, ubits)
        cs_len = jnp.where(has_cs, dlen, 1)
        delta = jnp.where(has_cs, ddelta, 0)
        signal = has_cs & (delta == 0) & (cs_len == ubits + 2)
        o = phase + cs_len

        # ========== plain path (non-signal)
        rung_p = (rung_band + delta) & nmask
        rung0 = rung_p == 0
        flagbit = (window(o) & 1).astype(jnp.int32)
        is_bits = ~signal & rung0 & (flagbit == 1)
        is_zero = ~signal & rung0 & (flagbit == 0)
        is_norm = ~signal & ~rung0

        # ========== extended prefix: flagless codeswitch at o
        l2, d2 = dsw_arith(window(o), ubits)
        l2 = l2 - 1  # flagless
        rung_x = (rung_band + d2) & nmask
        o_x = o + jnp.where(signal, l2, 0)
        is_cfk = signal & (rung_x != nmask)
        is_idxk = signal & (rung_x == nmask)

        # ---- CF header (QB3decode.h:640-668)
        wcf = window(o_x)
        diff = (wcf & 1).astype(jnp.int32)
        own = ((wcf >> 1) & 1).astype(jnp.int32)
        take_own = is_cfk & (diff == 1) & (own == 1)
        o_cf = o_x + jnp.where(is_cfk, 1 + jnp.where(diff == 1, 1, 0), 0)
        l3, d3 = dsw_arith(window(o_cf), ubits)
        l3 = l3 - 1
        cfrung = jnp.where(take_own, (rung_x + d3) & nmask, rung_x)
        o_cf = o_cf + jnp.where(take_own, l3, 0)
        # cf value at cfrung (cfrung-1 with the top bit implied when own)
        dec_rung = jnp.where(take_own, cfrung - 1, cfrung)
        wv = window(o_cf)
        cv, cl = _vlc_decode_single((wv & jnp.uint64(0xFFFFFFFF)).astype(W)
                                    if tbits <= 16 else wv.astype(W),
                                    dec_rung, W)
        cv64 = cv.astype(VW) + jnp.where(take_own,
                                         VW(1) << cfrung.astype(VW), 0)
        has_diff = is_cfk & (diff == 1)
        o_cf = o_cf + jnp.where(has_diff, cl, 0)
        pcf_new = jnp.where(has_diff, cv64, pcf_band.astype(VW))
        cf = pcf_new + 2
        cf0 = is_cfk & (rung_x == 0)
        cfg = is_cfk & (rung_x != 0)

        # ---- index prefix: third codeswitch -> value rung
        l4, d4 = dsw_arith(window(o_x), ubits)
        l4 = l4 - 1
        rung_i = (rung_band + d4) & nmask
        o_i = o_x + jnp.where(is_idxk, l4, 0)

        # ---- value walk: one pass serves all kinds; per-lane the rung and
        # the "how many single-bit/idx" differ, handled by selects
        vrung = jnp.where(is_norm, rung_p,
                 jnp.where(cfg, rung_x,
                 jnp.where(is_idxk, jnp.full_like(rung_p, 2), rung_p)))
        one_bit = is_bits | cf0  # 16 literal bits
        o_v = jnp.where(is_cfk, o_cf,
               jnp.where(is_idxk, o_i,
               o + jnp.where(rung0, 1, 0)))
        group_like = is_norm | cfg  # group-context VLC at vrung
        live_vals = is_norm | cfg | is_idxk | one_bit

        outs16 = []
        for v0 in range(0, B2, per):
            take = min(per, B2 - v0)
            w = window(o_v)
            shift = jnp.zeros_like(o_v)
            for t in range(take):
                ww = w >> shift.astype(jnp.uint64)
                if tbits <= 16:
                    gv, gl = _vlc_decode_arith(ww.astype(jnp.uint32), vrung,
                                               jnp.uint32)
                    iv, il = _vlc_decode_plain(ww.astype(jnp.uint32),
                                               jnp.full_like(vrung, 2),
                                               jnp.uint32)
                else:
                    gv, gl = _vlc_decode_arith(ww, vrung, jnp.uint64)
                    iv, il = _vlc_decode_plain(ww, jnp.full_like(vrung, 2),
                                               jnp.uint64)
                if tbits == 64:
                    ovf = gl == 65
                    extra = window(o_v + shift + 64) & 1
                    gv = gv | jnp.where(ovf & group_like, extra << 62,
                                        jnp.uint64(0))
                v = jnp.where(group_like, gv.astype(VW),
                    jnp.where(is_idxk, iv.astype(VW),
                    jnp.where(one_bit, (ww & 1).astype(VW), 0)))
                ln = jnp.where(group_like, gl,
                     jnp.where(is_idxk, il,
                     jnp.where(one_bit, 1, 0)))
                outs16.append(v)
                shift = shift + ln
            o_v = o_v + shift
        g = jnp.stack(outs16, axis=-1)  # (nchunks, B2) VW

        # ---- index uniques (QB3decode.h:681-716)
        maxidx = jnp.max(jnp.where(is_idxk[:, None], g, 0),
                         axis=-1).astype(jnp.int32)

        def ubody(o_u, u):
            live = is_idxk & (u <= maxidx)
            wv = window(o_u)
            uv, ul = _vlc_decode_single(
                (wv & jnp.uint64(0xFFFFFFFF)).astype(W)
                if tbits <= 16 else wv.astype(W), rung_i, W)
            return o_u + jnp.where(live, ul, 0), jnp.where(live, uv, 0)

        o_v, uniqs = jax.lax.scan(ubody, o_v, jnp.arange(B2 // 2))
        uq = jnp.moveaxis(uniqs, 0, -1).astype(VW)  # (nchunks, 8)
        gi = jnp.sum(jnp.where(
            (jnp.clip(g, 0, 7).astype(jnp.int32)[..., None]
             == jnp.arange(B2 // 2, dtype=jnp.int32)[None, None, :]),
            uq[:, None, :], 0), axis=-1)
        g = jnp.where(is_idxk[:, None], gi, g)

        # ---- step restore (always: best modes scan like BASE)
        restore = is_norm | cfg
        match, ones = step_flip_index(g, vrung)
        lane16 = jnp.arange(B2, dtype=jnp.int32)
        do = restore & match & (vrung >= 1)
        flip = do[:, None] & (lane16[None, :] == ones[:, None]) & \
            (ones[:, None] < B2)
        g = g ^ (jnp.where(flip, 1, 0).astype(VW) << vrung[:, None].astype(VW))

        # ---- CF multiply-back / CF0 expansion, masked to the width
        mask_w = VW((1 << tbits) - 1) if tbits < 64 else VW(0xFFFFFFFFFFFFFFFF)
        mm = (magsabs(g) * (cf[:, None] << 1) - (g & 1)) & mask_w
        g = jnp.where(cfg[:, None], mm, g)
        neg = (((cf - 1) << 1) | 1) & mask_w
        g = jnp.where(cf0[:, None], jnp.where(g != 0, neg[:, None], 0), g)

        # ---- post-group runbits (decoder recompute, QB3decode.h:664)
        used = g[..., 0]
        for i in range(1, B2):
            used = used | g[..., i]
        post = jnp.where(is_norm | is_idxk, jnp.where(is_idxk, rung_i, rung_p),
               jnp.where(cfg, topbit(used | VW(1)),
               jnp.where(cf0, topbit((2 * cf - 1) | VW(1)),
                         rung_p)))  # rung0 plain: runbits = 0 == rung_p
        new_rung = post.astype(jnp.int32)
        new_pcf = jnp.where(is_cfk & (diff == 1), pcf_new, pcf_band.astype(VW))
        end = jnp.where(signal, o_v, jnp.where(
            rung0 & ~signal, o + 1 + jnp.where(is_bits, B2, 0), o_v))
        # non-signal normal groups already advanced o_v from their own start
        end = jnp.where(is_norm, o_v, end)
        return g, off + (end - phase), new_rung, new_pcf

    def block_step(carry, _):
        off, rungs, pcfs = carry
        gs = []
        nr = []
        npc = []
        for band in range(nbands):
            g, off, r, pc = group_step(off, rungs[:, band], pcfs[:, band])
            gs.append(g)
            nr.append(r)
            npc.append(pc)
        return ((off, jnp.stack(nr, axis=1), jnp.stack(npc, axis=1)),
                jnp.stack(gs, axis=1))

    (off, _, _), vals = jax.lax.scan(
        block_step,
        (starts.astype(jnp.int32), entry_rungs.astype(jnp.int32),
         entry_pcf.astype(jnp.uint64)),
        None, length=k_blocks)
    g = jnp.moveaxis(vals, 0, 1).reshape(nchunks * k_blocks, nbands, B2)
    return g[:nblocks].reshape(nblocks * nbands, B2)


def pack_ic_best(spans: np.ndarray, entry: np.ndarray, pcf: np.ndarray,
                 k_blocks: int) -> bytes:
    """ic payload for best-mode streams: pack_ic plus per-chunk per-band
    u16le entry pcf (biased CF, cf - 2).  Callers must check pcf <= 0xFFFF
    (wider CFs fall back to the "ib" sidecar, like _best_sidecar)."""
    wide = spans.size and int(spans.max()) > 0xFFFF
    head = int(k_blocks) | _IC_BEST | (_IC_WIDE if wide else 0)
    return (head.to_bytes(2, "little")
            + spans.astype("<u4" if wide else "<u2").tobytes()
            + entry.astype(np.uint8).tobytes()
            + pcf.astype("<u2").tobytes())


def parse_ic_best(buf: bytes, nblocks: int, nbands: int):
    """Inverse of pack_ic_best -> (k_blocks, starts, entry_rungs,
    entry_pcf (nchunks, nbands) int64, total_bits), or None."""
    if len(buf) < 2:
        return None
    head = int.from_bytes(buf[:2], "little")
    if not head & _IC_BEST:
        return None
    k = head & ~(_IC_WIDE | _IC_BEST)
    wide = bool(head & _IC_WIDE)
    if k < 1:
        return None
    nchunks = -(-nblocks // k)
    sbytes = 4 if wide else 2
    if len(buf) != 2 + nchunks * (sbytes + 3 * nbands):
        return None
    spans = np.frombuffer(buf, dtype="<u4" if wide else "<u2",
                          count=nchunks, offset=2).astype(np.int64)
    off = 2 + sbytes * nchunks
    entry = np.frombuffer(buf, dtype=np.uint8, count=nchunks * nbands,
                          offset=off).reshape(nchunks, nbands)
    pcf = np.frombuffer(buf, dtype="<u2", count=nchunks * nbands,
                        offset=off + nchunks * nbands).reshape(nchunks, nbands)
    ends = np.cumsum(spans)
    starts = ends - spans
    if ends[-1] >= 1 << 31:
        return None
    return (k, starts, entry.astype(np.int32), pcf.astype(np.int64),
            int(ends[-1]))


def chunk_spans_best(glens: np.ndarray, rungs: np.ndarray,
                     pcf_in: np.ndarray, entry_runbits: np.ndarray,
                     entry_cf: np.ndarray, k_blocks: int):
    """Host-side ic-best payload pieces.

    rungs: (nblocks, nbands) DECODER-observable runbits after each block
    (encode_best_blocks' post_runbits); pcf_in: (nblocks, nbands) biased CF
    state BEFORE each block.  Returns (spans u32, entry u8, pcf u16-ranged
    int64) or None when a pcf exceeds 16 bits."""
    nblocks, nbands = rungs.shape
    spans, entry = chunk_spans(glens, rungs, entry_runbits, k_blocks)
    nchunks = spans.shape[0]
    pcf = np.empty((nchunks, nbands), np.int64)
    pcf[0] = entry_cf
    pcf[1:] = pcf_in[k_blocks : (nchunks - 1) * k_blocks + 1 : k_blocks]
    if pcf.size and int(pcf.max()) > 0xFFFF:
        return None
    return spans, entry, pcf
