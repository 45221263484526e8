"""Vectorized best-mode encoding (common-factor + index group trials).

The reference encode_best (QB3encode.h:618-724) trial-encodes each group and
rewinds the output stream when the index encoding is smaller — an inherently
serial construction.  This design computes the exact bit length of every
candidate for all groups at once and *selects* per group, which produces the
identical stream without ever materializing losing candidates:

  * per group: plain / CF (cfgenc, QB3encode.h:284-361) / index
    (ienc, QB3encode.h:557-613) code words and lengths;
  * the per-band previous-CF chain (pcf) feeds back into the choice (the
    same/different-CF flag changes the CF candidate's size, which changes
    whether the index trial wins, which changes whether pcf updates).  The
    key identity: a group's pcf transition is either *identity* (the index
    encoding would win against a different-CF-sized candidate) or
    *set-to-(cf-2)* (it would lose) — never a function of the incoming value.
    The chain therefore collapses to a "last set wins" scan, fully parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..constants import B2, ubits_for
from .bitutils import magsabs, magsdiv, topbit
from .encode import (
    _work_dtype,
    csw_arith,
    delta_mags,
    gather_blocks,
    block_rungs,
    value_codes_arith,
)

_SIGNAL = T.SIGNAL  # host-side (ubits is static)


def group_gcd(m, W):
    """Greatest common factor of the mag-sign magnitudes of each group
    (QB3encode.h:98-126).  m: (..., B2) -> (...) gcd (0 if all zero).

    Fixed-iteration binary GCD on W lanes: shift/subtract only — integer
    modulo is emulated division on the VPU and dominates the Euclid form.
    """
    a = magsabs(m).astype(W)
    width = a.shape[-1]
    # convergence bound tracks the DATA width: magnitudes are < 2^tbits(m),
    # so 2*(tbits+1) subtract/halve rounds always finish
    tbits = jnp.iinfo(m.dtype).bits + 1
    one = jnp.ones((), W)

    def ctz(v):
        # trailing zeros of v (0 for v == 0): topbit of the lowest set bit
        return jnp.where(v == 0, 0,
                         topbit((v & (jnp.zeros((), W) - v)) | one))

    def pair_gcd(x, y):
        # gcd(x, 0) == x.  Classic binary form: factor out common twos,
        # keep odd parts, subtract; the larger operand loses >= 1 bit per
        # two rounds, so 2*tbits rounds always converge.
        both = (x != 0) & (y != 0)
        twos = jnp.where(both, jnp.minimum(ctz(x), ctz(y)), 0)
        xo = x >> ctz(x).astype(W)
        yo = y >> ctz(y).astype(W)

        def body(_, xy):
            xo, yo = xy  # xo odd (or final gcd), yo odd or 0
            hi = jnp.maximum(xo, yo)
            lo = jnp.minimum(xo, yo)
            d = hi - lo
            d = d >> ctz(d).astype(W)
            return jnp.where(yo == 0, xo, lo), jnp.where(yo == 0, yo, d)

        xo, yo = jax.lax.fori_loop(0, 2 * int(tbits), body, (xo, yo))
        g = jnp.where(x == 0, y, jnp.where(y == 0, x, xo << twos.astype(W)))
        return g

    while width > 1:
        half = width // 2
        a = pair_gcd(a[..., :half], a[..., half : 2 * half])
        width = half
    return a[..., 0]


def single_codes(v, rung):
    """qb3csztbl: single-value encode at arbitrary rung (QB3encode.h:144-150),
    computed arithmetically (base VLC + the rung 3..7 middle swap; the
    single-value context has no rung 1/2 swap, tables.py ENC_SINGLE).

    v: W-typed values < 2^(rung+1); rung: int32 >= 0 (<= 62, no 65-bit
    case).  Returns (code W, len i32)."""
    W = v.dtype
    one = jnp.ones((), W)
    rw = rung.astype(W) if hasattr(rung, "astype") else W(rung)
    # middle swap for rungs 3..7
    a = (one << jnp.clip(rw, 0, 7)) - 1
    do_swap = (rung >= 3) & (rung <= 7)
    v = jnp.where(do_swap & (v == a), a + 1,
        jnp.where(do_swap & (v == a + 1), a, v))
    r = jnp.maximum(rung, 1)
    rwc = r.astype(W)
    nxt = (v >> (rwc - 1)) & 1
    top = v >> rwc
    tb = one << rwc
    cl = r + (top + (top | nxt)).astype(jnp.int32)
    cc = jnp.where(top == 1, ((v ^ tb) << 2) | 3,
                   jnp.where(nxt == 1, (((v << 1) ^ tb) << 1) | 1, v << 1))
    # rung 0: one literal bit
    return (jnp.where(rung == 0, v & 1, cc),
            jnp.where(rung == 0, 1, cl))


def _flagless(code, ln):
    """Drop the codeswitch change flag (cfgenc/ienc emit it separately or not
    at all, QB3encode.h:300-305, :581-592)."""
    return code >> code.dtype.type(1), ln - 1


def _cs_or_signal(ubits, delta, W):
    """Codeswitch code for a rung delta; the len-1 no-change form is replaced
    by the SIGNAL long form (QB3encode.h:301-303)."""
    code32, ln = csw_arith(delta, jnp.zeros_like(delta), ubits)
    code = code32.astype(W)
    sig_len, sig_code = int(_SIGNAL[ubits, 0]), int(_SIGNAL[ubits, 1])
    use_sig = ln == 1
    return (jnp.where(use_sig, W(sig_code), code),
            jnp.where(use_sig, sig_len, ln))


def index_candidate(m, rung, oldrung, ubits: int):
    """ienc: the index group encoding (QB3encode.h:557-613).

    m: (nb, C, B2) original mag-sign values; returns
    (prefix_code, prefix_len, idx_codes, idx_lens, uniq_codes, uniq_lens,
     total_len, valid).
    """
    nmask = (1 << ubits) - 1
    W = _work_dtype(int(jnp.iinfo(m.dtype).bits))
    mW = m.astype(W)
    # uniques in first-occurrence order
    eq = mW[..., :, None] == mW[..., None, :]  # (nb, C, 16, 16)
    first_occ = jnp.argmax(eq, axis=-1)  # first j with g[j] == g[i]
    lane = jnp.arange(B2, dtype=first_occ.dtype)
    is_first = first_occ == lane
    nuniq = jnp.sum(is_first, axis=-1)  # (nb, C)
    valid = nuniq <= B2 // 2
    rank = jnp.cumsum(is_first, axis=-1) - 1  # rank of first occurrence
    # uid[i] = rank of i's first occurrence; all tiny (16/8-wide) gathers
    # here are one-hot sums that fuse with their neighbours
    uid = jnp.sum(jnp.where(eq & is_first[..., None, :], rank[..., None, :], 0),
                  axis=-1)  # (nb, C, 16) in 0..15
    uid8 = jnp.clip(uid, 0, B2 // 2 - 1)  # safe when invalid
    # counts and first-seen position per unique slot
    onehot = (uid8[..., None] == jnp.arange(B2 // 2)[None, None, None, :])
    counts = jnp.sum(onehot, axis=-2)  # (nb, C, 8)
    slot_live = jnp.arange(B2 // 2)[None, None, :] < jnp.minimum(nuniq, B2 // 2)[..., None]
    # stable sort by descending count (ties keep first-seen order,
    # QB3encode.h:546-554): key = -count, argsort is stable
    order = jnp.argsort(jnp.where(slot_live, -counts, 99), axis=-1, stable=True)
    # position of each unique slot in the sorted order (inverse permutation)
    order1h = order[..., None] == jnp.arange(B2 // 2)[None, None, None, :]
    inv = jnp.sum(jnp.where(order1h, jnp.arange(B2 // 2)[..., None], 0), axis=-2)
    final_idx = jnp.sum(jnp.where(onehot, inv[..., None, :], 0), axis=-1)
    # plain rung-2 index code (no swap in single context at rung 2)
    idx_codes, idx_lens = single_codes(final_idx.astype(W),
                                       jnp.full(final_idx.shape, 2, jnp.int32))
    # unique values ordered by frequency
    uniq_vals_slot = jnp.sum(jnp.where(is_first, mW, 0)[..., None] *
                             (rank[..., None] == jnp.arange(B2 // 2)[None, None, None, :]).astype(W),
                             axis=-2)  # value of unique slot u (first-seen order)
    uniq_sorted = jnp.sum(jnp.where(order1h, uniq_vals_slot[..., None, :], 0),
                          axis=-1)
    uc, ul = single_codes(uniq_sorted, jnp.broadcast_to(rung[..., None], uniq_sorted.shape))
    live_sorted = jnp.sum(jnp.where(order1h, slot_live[..., None, :], 0),
                          axis=-1) > 0
    ul = jnp.where(live_sorted, ul, 0)
    uc = jnp.where(live_sorted, uc, 0)
    # prefix: SIGNAL + flagless cs(max-oldrung) + flagless cs(rung-oldrung)
    sig_len, sig_code = int(_SIGNAL[ubits, 0]), int(_SIGNAL[ubits, 1])
    c1, l1 = _cs_or_signal(ubits, (nmask - oldrung) & nmask, W)
    c1, l1 = _flagless(c1, l1)
    c2, l2 = _cs_or_signal(ubits, (rung - oldrung) & nmask, W)
    c2, l2 = _flagless(c2, l2)
    pcode = W(sig_code) | (c1 << W(sig_len)) | (c2 << (sig_len + l1).astype(W))
    plen = sig_len + l1 + l2
    total = plen + jnp.sum(idx_lens, axis=-1) + jnp.sum(ul, axis=-1)
    return pcode, plen, idx_codes, idx_lens, uc, ul, total, valid


def cf_candidate(m, rung, oldrung, ubits: int):
    """cfgenc components for both the same-CF and different-CF variants
    (QB3encode.h:284-361).

    Returns a dict of code/len tensors; selection happens after the pcf scan.
    """
    nmask = (1 << ubits) - 1
    W = _work_dtype(int(jnp.iinfo(m.dtype).bits))
    cf = group_gcd(m, W)  # (nb, C) W-typed
    has_cf = cf >= 2
    cf_safe = jnp.where(has_cf, cf, jnp.full_like(cf, 2))
    div = magsdiv(m, cf_safe[..., None].astype(m.dtype))  # divided group
    bitsused = div[..., 0]
    for i in range(1, B2):
        bitsused = bitsused | div[..., i]
    trung = topbit(bitsused | jnp.ones_like(bitsused))  # <= 62 when cf >= 2
    cfm = cf_safe - W(2)  # biased CF
    cfrung = topbit(cfm | W(1))

    sig_len, sig_code = int(_SIGNAL[ubits, 0]), int(_SIGNAL[ubits, 1])
    cst_c, cst_l = _cs_or_signal(ubits, (trung - oldrung) & nmask, W)
    cst_c, cst_l = _flagless(cst_c, cst_l)
    # header base: SIGNAL + flagless rung switch
    base_code = W(sig_code) | (cst_c << W(sig_len))
    base_len = sig_len + cst_l

    at_trung = (trung >= cfrung) & ((trung < cfrung + ubits) | (cfrung == 0))
    trung0 = trung == 0

    # diff-CF, cf at trung: flags '1','0' then cf code (or 1 bit when trung==0)
    cfc_at, cfl_at = single_codes(cfm, trung)
    cfc_at = jnp.where(trung0, cfm & 1, cfc_at)
    cfl_at = jnp.where(trung0, 1, cfl_at)
    # diff-CF, own rung: flag '1' + full csw(cfrung-trung) + cf at cfrung-1
    own_c32, own_l = csw_arith(cfrung, trung, ubits)
    own_c = own_c32.astype(W)
    cfc_own, cfl_own = single_codes(cfm ^ (W(1) << cfrung.astype(W)),
                                    cfrung - 1)

    # body: divided group at trung (with step), or 16 single bits when trung==0
    dc, dl, _, _ = value_codes_arith(div, trung, skipstep=False)
    dc = jnp.where(trung0[..., None], div.astype(W) & 1, dc)
    dl = jnp.where(trung0[..., None], 1, dl)
    body_len = jnp.sum(dl, axis=-1)

    # P1 assembly per variant: flags are emitted right after the header base
    one = W(1)
    # same: '0' flag
    p1_same = base_code
    l1_same = base_len + 1
    # diff at trung: '1' then '0'
    p1_at = base_code | (one << base_len.astype(jnp.uint64))
    l1_at = base_len + 2
    # diff own rung: '1' only (the csw change bit supplies the second flag)
    p1_diff_own = base_code | (one << base_len.astype(jnp.uint64))
    l1_diff_own = base_len + 1

    p1_diff = jnp.where(at_trung, p1_at, p1_diff_own)
    l1_diff = jnp.where(at_trung, l1_at, l1_diff_own)
    s1_code_diff = jnp.where(at_trung, jnp.uint64(0), own_c)
    s1_len_diff = jnp.where(at_trung, 0, own_l)
    s2_code_diff = jnp.where(at_trung, cfc_at, cfc_own)
    s2_len_diff = jnp.where(at_trung, cfl_at, cfl_own)

    size_same = l1_same + body_len
    size_diff = l1_diff + s1_len_diff + s2_len_diff + body_len

    return dict(
        cf=cf, has_cf=has_cf, cfm=cfm, trung=trung,
        p1_same=p1_same, l1_same=l1_same,
        p1_diff=p1_diff, l1_diff=l1_diff,
        s1_code_diff=s1_code_diff, s1_len_diff=s1_len_diff,
        s2_code_diff=s2_code_diff, s2_len_diff=s2_len_diff,
        body_codes=dc, body_lens=dl,
        size_same=size_same, size_diff=size_diff,
    )


def pcf_scan(is_set, set_val, entry_cf):
    """Per-band 'last set wins' scan over blocks (axis 0).

    is_set: (nb, C) bool; set_val: (nb, C) uint; entry_cf: (C,).
    Returns pcf_in per block and the exit state.  Implemented as one
    log-depth associative scan (combine = take the right element if it is
    set) — no per-element gathers.
    """
    def combine(a, b):
        av, aset = a
        bv, bset = b
        return jnp.where(bset, bv, av), aset | bset

    vals, seen = jax.lax.associative_scan(
        combine, (set_val, is_set), axis=0)
    incl = jnp.where(seen, vals, entry_cf[None, :])
    pcf_in = jnp.concatenate([entry_cf[None, :].astype(set_val.dtype),
                              incl[:-1]], axis=0)
    return pcf_in, incl[-1]


def encode_best_blocks(img, entry_prev, entry_runbits, entry_cf, order: int,
                       cband: tuple[int, ...], cf_exchange=None,
                       prev_exchange=None, rung_exchange=None):
    """Phase A for the best encoder.  Returns flattened (codes, lens) in
    stream order plus exit band state.

    Sharded callers inject the cross-shard band-state collectives via three
    hooks, each a pure function of shard-local data (no sequential chain):
      prev_exchange(vals) -> (C,) entry_prev      (ppermute of exit values)
      rung_exchange(exit_runbits) -> (C,) entry   (ppermute of exit rungs)
      cf_exchange(is_set, set_val) -> (C,) entry pcf ("last CF set wins"
        across shards; the set decisions are entry-independent, see the
        module docstring, so one all-gather suffices)."""
    ubits = ubits_for(img.dtype.itemsize)
    nmask = (1 << ubits) - 1
    tbits = jnp.iinfo(img.dtype).bits
    W = _work_dtype(int(tbits))
    vals = gather_blocks(img, order, cband)
    if prev_exchange is not None:
        entry_prev = prev_exchange(vals)
    m, exit_prev = delta_mags(vals, entry_prev)
    bitsused, rung, oldrung, exit_runbits = block_rungs(m, entry_runbits)
    if rung_exchange is not None:
        entry_runbits = rung_exchange(exit_runbits)
        oldrung = jnp.concatenate([entry_runbits[None, :], rung[:-1]], axis=0)
    rung0 = bitsused <= 1
    active = ~rung0

    # ---- candidates
    plain_codes, plain_lens, plain_eb, plain_el = value_codes_arith(
        m, rung, skipstep=False)
    cs_code32, cs_len = csw_arith(rung, oldrung, ubits)
    cs_code = cs_code32.astype(W)
    plain_size = cs_len + jnp.sum(plain_lens + plain_el, axis=-1)

    cfd = cf_candidate(m, rung, oldrung, ubits)
    (ipc, ipl, icodes, ilens, ucodes, ulens, isize, ivalid) = index_candidate(
        m, rung, oldrung, ubits)

    # ---- index-trial gating (QB3encode.h:700-713)
    thr = 36 + 3 * ubits + 2 * rung
    idx_range = active & (rung > 3) & (rung < 63) & ivalid
    base_same = jnp.where(cfd["has_cf"], cfd["size_same"], plain_size)
    base_diff = jnp.where(cfd["has_cf"], cfd["size_diff"], plain_size)
    win_same = idx_range & (base_same >= thr) & (isize < base_same)
    win_diff = idx_range & (base_diff >= thr) & (isize < base_diff)

    # ---- pcf chain: transition is identity iff the index trial would win
    # against the different-CF candidate; otherwise set to cf-2
    is_set = active & cfd["has_cf"] & ~win_diff
    entry_cf_w = (cf_exchange(is_set, cfd["cfm"]) if cf_exchange is not None
                  else entry_cf.astype(W))
    pcf_in, exit_cf = pcf_scan(is_set, cfd["cfm"], entry_cf_w)
    same = pcf_in == cfd["cfm"]

    use_cf = active & cfd["has_cf"]
    base_size = jnp.where(use_cf, jnp.where(same, cfd["size_same"], cfd["size_diff"]),
                          plain_size)
    win = jnp.where(same, win_same, win_diff)

    # ---- final symbol selection
    # S0 prefix
    flag = (bitsused & 1).astype(W)
    p_rung0 = cs_code | (flag << cs_len.astype(W))
    l_rung0 = cs_len + 1
    cf_p1 = jnp.where(same, cfd["p1_same"], cfd["p1_diff"])
    cf_l1 = jnp.where(same, cfd["l1_same"], cfd["l1_diff"])
    s0_code = jnp.where(rung0, p_rung0,
              jnp.where(win, ipc,
              jnp.where(use_cf, cf_p1, cs_code)))
    s0_len = jnp.where(rung0, l_rung0,
             jnp.where(win, ipl,
             jnp.where(use_cf, cf_l1, cs_len)))
    # S1/S2: only for diff-CF
    diff_cf = use_cf & ~same & ~win
    s1_code = jnp.where(diff_cf, cfd["s1_code_diff"], W(0))
    s1_len = jnp.where(diff_cf, cfd["s1_len_diff"], 0)
    s2_code = jnp.where(diff_cf, cfd["s2_code_diff"], W(0))
    s2_len = jnp.where(diff_cf, cfd["s2_len_diff"], 0)
    # V0..15
    r0b = rung0[..., None]
    winb = win[..., None]
    cfb = use_cf[..., None]
    v_code = jnp.where(r0b, m.astype(W) & 1,
             jnp.where(winb, icodes,
             jnp.where(cfb, cfd["body_codes"], plain_codes)))
    v_len = jnp.where(r0b, jnp.where((bitsused == 1)[..., None], 1, 0),
            jnp.where(winb, ilens,
            jnp.where(cfb, cfd["body_lens"], plain_lens)))
    # extras (u64 rung-63 overflow): only the plain path can produce them
    e_code = jnp.where(r0b | winb | cfb, W(0), plain_eb.astype(W))
    e_len = jnp.where(r0b | winb | cfb, 0, plain_el)
    # U0..7 unique values: only when the index encoding wins
    u_code = jnp.where(winb, ucodes, W(0))[..., : B2 // 2]
    u_len = jnp.where(winb, ulens, 0)[..., : B2 // 2]

    parts_c = [s0_code[..., None], s1_code[..., None], s2_code[..., None]]
    parts_l = [s0_len[..., None], s1_len[..., None], s2_len[..., None]]
    if int(tbits) == 64:
        vi = jnp.stack([v_code, e_code], axis=-1).reshape(*v_code.shape[:-1], 2 * B2)
        li = jnp.stack([v_len, e_len], axis=-1).reshape(*v_len.shape[:-1], 2 * B2)
        parts_c.append(vi)
        parts_l.append(li)
    else:
        parts_c.append(v_code)
        parts_l.append(v_len)
    parts_c.append(u_code)
    parts_l.append(u_len)
    codes = jnp.concatenate(parts_c, axis=-1)
    lens = jnp.concatenate(parts_l, axis=-1)
    nsym = codes.shape[-1]

    # ---- per-group decode metadata for the "ib" sidecar (offsets.py kinds):
    # meta16 = kind | vrung << 3 | prefix_len << 9; cfv = resolved CF (cf-2+2)
    from ..offsets import (KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL,
                           KIND_ZERO)
    is_cf_grp = ~rung0 & ~win & use_cf
    trung0_m = cfd["trung"] == 0
    kind = jnp.where(rung0,
                     jnp.where(bitsused == 1, KIND_BITS, KIND_ZERO),
           jnp.where(win, KIND_IDX,
           jnp.where(is_cf_grp,
                     jnp.where(trung0_m, KIND_CF0, KIND_CF), KIND_NORMAL)))
    vrung_meta = jnp.where(rung0, 0,
                 jnp.where(win, rung,
                 jnp.where(is_cf_grp, cfd["trung"], rung)))
    prefix_len = s0_len + s1_len + s2_len
    meta16 = (kind.astype(jnp.int32) | (vrung_meta.astype(jnp.int32) << 3)
              | (prefix_len << 9))
    cfv = jnp.where(is_cf_grp, cfd["cfm"], 0)
    # decoder-observable state chains, for the self-contained "ic" anchors:
    # the decoder recomputes runbits after CF0 groups from the CF value
    # (QB3decode.h:664 / offsets.py) — everywhere else they equal `rung`
    cf0_run = topbit((2 * (cfd["cfm"] + W(2)) - 1) | W(1))
    post_runbits = jnp.where(kind == KIND_CF0, cf0_run, rung)
    return (codes.reshape(-1, nsym), lens.reshape(-1, nsym),
            exit_prev, exit_runbits, exit_cf,
            meta16.reshape(-1), cfv.reshape(-1),
            post_runbits, pcf_in)
