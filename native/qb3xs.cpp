// qb3xs — native transfer-syntax helpers for the qb3_tpu engine.
//
// The QB3 stream is bit-serial: the position of group k+1 depends on group
// k's code lengths.  This module performs that serial walk at native speed,
// emitting per-group metadata (kind / value-code position / rung / common
// factor) that the device then consumes for fully parallel value decoding
// (qb3_tpu/ops/decode.py).  It mirrors qb3_tpu/offsets.py, the portable
// reference implementation, and is an original design: a flat bit-position
// cursor with absolute peeks, not a streaming accumulator.
//
// Also provides the RLE0 byte post-pass (spec: QB3encode.cpp:271-332,
// QB3decode.cpp:267-307) whose byte-serial scan is host work by nature.
//
// Build: make -C native   (produces libqb3xs.so, loaded via ctypes)

#include <cstdint>
#include <cstring>

#include "qb3xs_tables.inc"

namespace {

constexpr int B2 = 16;
constexpr uint32_t TBL = 0xFFF;

struct Bits {
    const uint8_t* data;
    size_t nbytes;
    int64_t pos = 0;  // bit cursor

    inline uint64_t peek() const {
        size_t byte = size_t(pos >> 3);
        // padded callers guarantee 8 readable bytes past the end; be safe
        uint64_t v = 0;
        size_t avail = nbytes > byte ? nbytes - byte : 0;
        if (avail >= 9) {
            uint64_t lo, hi8;
            memcpy(&lo, data + byte, 8);
            hi8 = data[byte + 8];
            int sh = int(pos & 7);
            return sh ? (lo >> sh) | (hi8 << (64 - sh)) : lo;
        }
        uint8_t tmp[9] = {0};
        memcpy(tmp, data + byte, avail > 9 ? 9 : avail);
        uint64_t lo;
        memcpy(&lo, tmp, 8);
        int sh = int(pos & 7);
        v = sh ? (lo >> sh) | (uint64_t(tmp[8]) << (64 - sh)) : lo;
        return v;
    }
};

inline int ubits_for(int tsize) {
    return tsize == 1 ? 3 : tsize == 2 ? 4 : tsize == 4 ? 5 : 6;
}

// computed decode for rung >= 2; returns len<<16 | unused, value via out
inline void qb3dsz(uint64_t w, int rung, int* len, uint64_t* val) {
    uint64_t rbit = 1ull << rung;
    if (!(w & 1)) {
        *len = rung;
        *val = (w & (rbit - 1)) >> 1;
        return;
    }
    uint64_t n = (w >> 1) & 1;
    uint64_t v = (w >> 2) & (rbit - 1);
    *len = rung + 1 + int(n);
    *val = n ? (v | rbit) : (v | (rbit >> 1));
}

inline void dec_single(uint64_t w, int rung, int* len, uint64_t* val) {
    if (rung <= 7) {
        uint16_t e = DSGL_T[rung][w & ((1u << (rung + 2)) - 1)];
        *len = e >> 12;
        *val = e & TBL;
        return;
    }
    qb3dsz(w, rung, len, val);
}

enum Kind : uint8_t { K_NORMAL = 0, K_ZERO, K_BITS, K_CF, K_CF0, K_IDX };

}  // namespace

namespace {

// u8 FTL specialization: every rung is tabled (<= 7), no extended
// encodings, and a group spans <= 150 bits — the codeswitch, the rung-0
// flag, and the first ~6 values all come from one 64-bit window.
int64_t parse_u8_ftl(Bits& s, int64_t nblocks, int nbands, int32_t* runbits,
                     uint8_t* kind, int64_t* val_pos, int32_t* vrung,
                     uint64_t* cf_out, int32_t* rung_out) {
    const uint16_t* dsw = DSW_T[3];
    int64_t gi = 0;
    for (int64_t b = 0; b < nblocks; b++) {
        for (int c = 0; c < nbands; c++, gi++) {
            uint64_t w = s.peek();
            int used = 1;
            int rung = runbits[c];
            if (w & 1) {
                uint16_t e = dsw[(w >> 1) & 15];
                used = e >> 12;
                rung = (rung + (e & TBL)) & 7;
                runbits[c] = rung;
            }
            vrung[gi] = rung;
            rung_out[gi] = rung;
            cf_out[gi] = 0;
            if (rung == 0) {
                int flag = int((w >> used) & 1);
                s.pos += used + 1;
                val_pos[gi] = s.pos;
                kind[gi] = flag ? K_BITS : K_ZERO;
                if (flag) s.pos += B2;
                continue;
            }
            kind[gi] = K_NORMAL;
            s.pos += used;
            val_pos[gi] = s.pos;
            const uint16_t* t = DGRP_T[rung];
            const uint32_t m = (1u << (rung + 2)) - 1;
            int vused = used;  // keep riding the same window
            for (int i = 0; i < B2; i++) {
                if (vused > 55) {
                    s.pos += vused - used;
                    w = s.peek();
                    used = 0;
                    vused = 0;
                }
                vused += t[(w >> vused) & m] >> 12;
            }
            s.pos += vused - used;
        }
    }
    return s.pos;
}

}  // namespace

extern "C" {

// Walk the stream; fills (nblocks*nbands)-sized arrays in stream order.
// Returns the final bit position, or, when the stream fails one of the
// reference's corruption checks (QB3decode.h:642,:665,:683,:703), the
// negative value -(failed_group + 1); remaining groups are marked all-zero
// so the caller can still produce the reference's partial output.
int64_t qb3xs_parse(const uint8_t* payload, size_t len_bytes, int64_t nblocks,
                    int nbands, int tsize, int is_ftl, const int32_t* entry_runbits,
                    const uint64_t* entry_cf, uint8_t* kind, int64_t* val_pos,
                    int32_t* vrung, uint64_t* cf_out, int32_t* rung_out,
                    int64_t start_bit) {
    const int u = ubits_for(tsize);
    const int nmask = (1 << u) - 1;
    const int lmask = (1 << (u + 1)) - 1;
    const uint16_t* dsw = DSW_T[u];
    const int maxbits = 8 * tsize;
    const uint64_t tmask = maxbits == 64 ? ~0ull : ((1ull << maxbits) - 1);

    int32_t runbits[256];
    uint64_t pcf[256];
    for (int c = 0; c < nbands; c++) {
        runbits[c] = entry_runbits ? entry_runbits[c] : 0;
        pcf[c] = entry_cf ? entry_cf[c] : 0;
    }

    Bits s{payload, len_bytes};
    s.pos = start_bit;  // streaming callers resume mid-payload
    const int64_t n_total = nblocks * nbands;
    if (tsize == 1 && is_ftl)
        return parse_u8_ftl(s, nblocks, nbands, runbits, kind, val_pos,
                            vrung, cf_out, rung_out);
    bool failed = false;
    int64_t gi = 0;
    for (int64_t b = 0; b < nblocks && !failed; b++) {
        for (int c = 0; c < nbands && !failed; c++, gi++) {
            uint64_t w = s.peek();
            int cs_len = 1, delta = 0;
            if (w & 1) {
                uint16_t e = dsw[(w >> 1) & lmask];
                cs_len = e >> 12;
                delta = e & TBL;
            }
            bool signal = !is_ftl && (w & 1) && delta == 0 && cs_len == u + 2;
            if (!signal) {
                int rung = (runbits[c] + delta) & nmask;
                runbits[c] = rung;
                s.pos += cs_len;
                rung_out[gi] = rung;
                vrung[gi] = rung;
                cf_out[gi] = 0;
                if (rung == 0) {
                    int flag = int(s.peek() & 1);
                    s.pos += 1;
                    val_pos[gi] = s.pos;
                    kind[gi] = flag ? K_BITS : K_ZERO;
                    if (flag) s.pos += B2;
                } else {
                    kind[gi] = K_NORMAL;
                    val_pos[gi] = s.pos;
                    // one 64-bit window serves several values (u8: >= 6 per
                    // refill) instead of an unaligned peek per value — the
                    // per-value peek made the walk ~3x slower than the
                    // reference's accumulator decoder
                    if (rung <= 7) {
                        const uint16_t* t = DGRP_T[rung];
                        const uint32_t m = (1u << (rung + 2)) - 1;
                        uint64_t w = s.peek();
                        int used = 0;
                        for (int i = 0; i < B2; i++) {
                            if (used > 55) {
                                s.pos += used; w = s.peek(); used = 0;
                            }
                            used += t[(w >> used) & m] >> 12;
                        }
                        s.pos += used;
                    } else if (rung <= 62) {  // ln <= 64: no long form
                        const int need = rung + 2;
                        uint64_t w = s.peek();
                        int used = 0;
                        for (int i = 0; i < B2; i++) {
                            if (used + need > 64) {
                                s.pos += used; w = s.peek(); used = 0;
                            }
                            int ln; uint64_t v;
                            qb3dsz(w >> used, rung, &ln, &v);
                            used += ln;
                        }
                        s.pos += used;
                    } else {
                        for (int i = 0; i < B2; i++) {
                            int ln; uint64_t v;
                            qb3dsz(s.peek(), rung, &ln, &v);
                            s.pos += ln > 64 ? 65 : ln;
                        }
                    }
                }
                continue;
            }
            // extended encodings (QB3decode.h:624-716)
            s.pos += cs_len;
            uint16_t e2 = dsw[s.peek() & lmask];  // flagless codeswitch
            int rung = (runbits[c] + (e2 & TBL)) & nmask;
            s.pos += (e2 >> 12) - 1;
            if (rung != nmask) {  // CF group
                int cfrung = rung;
                int diff = int(s.peek() & 1);
                s.pos += 1;
                if (diff) {
                    int own = int(s.peek() & 1);
                    s.pos += 1;
                    if (own) {
                        uint16_t e3 = dsw[s.peek() & lmask];
                        cfrung = (rung + (e3 & TBL)) & nmask;
                        s.pos += (e3 >> 12) - 1;
                        failed |= cfrung == rung;  // QB3decode.h:665
                    }
                    int ln; uint64_t v;
                    dec_single(s.peek(), cfrung - own, &ln, &v);
                    s.pos += ln;
                    pcf[c] = v + (own ? (1ull << cfrung) : 0);
                }
                uint64_t cf = pcf[c] + 2;
                cf_out[gi] = cf;
                vrung[gi] = rung;
                if (rung == 0) {
                    kind[gi] = K_CF0;
                    val_pos[gi] = s.pos;
                    s.pos += B2;
                    uint64_t v = 2 * cf - 1;
                    int tb = 63;
                    while (tb && !((v >> tb) & 1)) tb--;
                    runbits[c] = tb;
                } else {
                    kind[gi] = K_CF;
                    val_pos[gi] = s.pos;
                    uint64_t vals[B2];
                    if (rung <= 7) {
                        const uint16_t* t = DGRP_T[rung];
                        const uint32_t m = (1u << (rung + 2)) - 1;
                        for (int i = 0; i < B2; i++) {
                            uint16_t e = t[s.peek() & m];
                            s.pos += e >> 12;
                            vals[i] = e & TBL;
                        }
                    } else {
                        for (int i = 0; i < B2; i++) {
                            int ln; uint64_t v;
                            qb3dsz(s.peek(), rung, &ln, &v);
                            if (ln > 64) {
                                s.pos += 64;
                                v |= (s.peek() & 1) << 62;
                                s.pos += 1;
                            } else {
                                s.pos += ln;
                            }
                            vals[i] = v;
                        }
                    }
                    // step restore then magsmul OR for the runbits chain
                    uint32_t acc = 0;
                    for (int i = 0; i < B2; i++)
                        acc |= uint32_t((vals[i] >> rung) & 1) << i;
                    if ((acc & (acc + 1)) == 0) {
                        int ones = 0;
                        while (acc) { ones++; acc >>= 1; }
                        if (ones < B2) vals[ones] ^= 1ull << rung;
                    }
                    uint64_t used = 0;
                    for (int i = 0; i < B2; i++) {
                        uint64_t v = vals[i];
                        uint64_t mm = (((v >> 1) + (v & 1)) * (cf << 1) - (v & 1)) & tmask;
                        used |= v ? mm : 0;
                    }
                    failed |= cf > used;  // QB3decode.h:683
                    int tb = 63;
                    used |= 1;
                    while (tb && !((used >> tb) & 1)) tb--;
                    runbits[c] = tb;
                }
                rung_out[gi] = runbits[c];
            } else {  // index group
                uint16_t e3 = dsw[s.peek() & lmask];
                rung = (runbits[c] + (e3 & TBL)) & nmask;
                runbits[c] = rung;
                s.pos += (e3 >> 12) - 1;
                kind[gi] = K_IDX;
                vrung[gi] = rung;
                rung_out[gi] = rung;
                cf_out[gi] = 0;
                val_pos[gi] = s.pos;
                failed |= rung == 63;  // QB3decode.h:703 (u64 overflow guard)
                int maxidx = 0;
                int idx_bits = 0;
                for (int i = 0; i < B2; i++) {
                    uint16_t e = IDXD[s.peek() & 0xF];
                    s.pos += e >> 12;
                    idx_bits += e >> 12;
                    int v = e & TBL;
                    if (v > maxidx) maxidx = v;
                }
                // max valid index section is 52 bits (QB3decode.h:707-713)
                failed |= idx_bits > 52;
                for (int i = 0; i <= maxidx; i++) {
                    int ln; uint64_t v;
                    dec_single(s.peek(), rung, &ln, &v);
                    s.pos += ln;
                }
            }
        }
    }
    if (failed) {
        // gi was incremented past the failing group by the loop header
        for (int64_t i = gi; i < n_total; i++) kind[i] = K_ZERO;
        return -gi;  // failed_group = gi - 1
    }
    return s.pos;
}

// ---- RLE0 byte post-pass ----
//
// Escape-site-oriented scan: the cursor jumps between escape opportunities
// (a 0xff pair, or >= 4 zeros not shadowed by a preceding literal 0xff) and
// everything in between is a plain literal.  The final two input bytes are
// never the start of an escape.

int64_t qb3xs_rle0_encode(const uint8_t* src, int64_t len, uint8_t* dst) {
    int64_t ip = 0, op = 0;
    bool lit_ff = false;  // last output byte was a literal 0xff
    while (ip + 2 < len) {
        uint8_t b = src[ip];
        if (b == 0xFF && src[ip + 1] == 0xFF) {
            dst[op] = dst[op + 1] = dst[op + 2] = 0xFF;
            op += 3;
            ip += 2;
            lit_ff = false;
        } else if (b == 0 && !lit_ff && ip + 3 < len &&
                   !(src[ip + 1] | src[ip + 2] | src[ip + 3])) {
            int64_t run = 4;
            while (run < 258 && ip + run < len && src[ip + run] == 0) run++;
            dst[op] = dst[op + 1] = 0xFF;
            dst[op + 2] = uint8_t(run - 4);
            op += 3;
            ip += run;
            lit_ff = false;
        } else {
            dst[op++] = b;
            lit_ff = (b == 0xFF);
            ip++;
        }
    }
    if (ip < len) {
        memcpy(dst + op, src + ip, size_t(len - ip));
        op += len - ip;
    }
    return op;
}

int64_t qb3xs_rle0_decode(const uint8_t* src, int64_t slen, uint8_t* dst, int64_t dlen) {
    int64_t ip = 0, op = 0;
    while (ip + 2 < slen && op < dlen) {
        if (src[ip] != 0xFF || src[ip + 1] != 0xFF) {
            dst[op++] = src[ip++];
            continue;
        }
        bool pair = src[ip + 2] == 0xFF;
        int64_t run = pair ? 2 : 4 + int64_t(src[ip + 2]);
        if (op + run > dlen) return -1;
        memset(dst + op, pair ? 0xFF : 0, size_t(run));
        op += run;
        ip += 3;
    }
    while (ip < slen && op < dlen) dst[op++] = src[ip++];
    return (ip == slen && op == dlen) ? op : -1;
}

int64_t qb3xs_rle0_size(const uint8_t* src, int64_t len) {
    int64_t ip = 0, total = 0;
    while (ip + 2 < len) {
        if (src[ip] != 0xFF || src[ip + 1] != 0xFF) {
            total++;
            ip++;
        } else {
            total += (src[ip + 2] == 0xFF) ? 2 : 4 + int64_t(src[ip + 2]);
            ip += 3;
        }
    }
    return total + (len - ip);
}

}  // extern "C"
