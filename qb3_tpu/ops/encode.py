"""Vectorized QB3 group encoding.

The reference encoder is one serial loop: per 4x4 block, per band, gather in
curve order, running delta, mag-sign, codeswitch, variable-length push
(QB3encode.h:376-451).  Every serial dependency in that loop is data-defined,
so the design here is a two-phase data-parallel pipeline:

  Phase A (this module): for *all* microblocks at once, compute the exact
    code words and bit lengths of every emitted symbol.
  Phase B (bitpack.py): exclusive prefix-sum of the lengths -> absolute bit
    offsets -> scatter the codes into the output words.

Serial state becomes tensor algebra:
  * the per-band previous-value chain (QB3encode.h:422-438) is a lag-1 shift
    of the band's scan sequence;
  * the per-band rung chain (QB3encode.h:439-441) is a lag-1 shift of the
    per-block rung tensor;
  * bit positions are a cumulative sum of the per-symbol lengths.

Symbols per block/band: 1 prefix (codeswitch [+ all-zero flag]) + 16 value
codes [+ 16 overflow bits for 64-bit data at rung 63].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables as T
from ..constants import B, B2, curve_offsets, ubits_for
from .bitutils import mags, step_flip_index, topbit

# Device-resident copies of the generated tables
_ENC_GROUP_LEN = jnp.asarray(T.ENC_GROUP[:, :, 0].astype(np.int32))
_ENC_GROUP_CODE = jnp.asarray(T.ENC_GROUP[:, :, 1].astype(np.uint32))
_CSW_LEN = jnp.asarray(T.CSW[:, :, 0].astype(np.int32))
_CSW_CODE = jnp.asarray(T.CSW[:, :, 1].astype(np.uint32))


def block_origins(size: int) -> np.ndarray:
    """Block origin coordinates along one axis: 0,4,... with the last block
    shifted up/left to fit (QB3encode.h:409-416)."""
    n = (size + B - 1) // B
    out = np.arange(n, dtype=np.int32) * B
    out[-1] = size - B
    return out


def gather_blocks(img, order: int, cband: tuple[int, ...]):
    """(H, W, C) unsigned image -> (nblocks, C, B2) band-decorrelated values.

    Blocks enumerate row-major over (block-row, block-col); values within a
    block follow the scan curve; band decorrelation subtracts the core band
    (QB3encode.h:423-430).
    """
    h, w, nb = img.shape
    offs = curve_offsets(order)
    if h % B == 0 and w % B == 0:
        # aligned: blocks tile the image exactly; the curve gather becomes a
        # static permutation over the 16-lane axis (pure layout, no gather)
        perm = np.array([dy * B + dx for dy, dx in offs], dtype=np.int32)
        if img.dtype.itemsize == 8:
            # the block transpose moves u32 lane pairs instead of u64
            # elements; same permutation, pair-split
            i32 = jax.lax.bitcast_convert_type(img, jnp.uint32)
            t = i32.reshape(h // B, B, w // B, B, nb, 2)
            t = t.transpose(0, 2, 4, 1, 3, 5).reshape(-1, nb, B2, 2)
            vals = jax.lax.bitcast_convert_type(t[:, :, perm], jnp.uint64)
        else:
            t = img.reshape(h // B, B, w // B, B, nb)
            t = t.transpose(0, 2, 4, 1, 3).reshape(-1, nb, B2)
            vals = t[:, :, perm]
    else:
        ys = block_origins(h)
        xs = block_origins(w)
        dy = np.array([o[0] for o in offs], dtype=np.int32)
        dx = np.array([o[1] for o in offs], dtype=np.int32)
        iy = ys[:, None] + dy[None, :]  # (nby, B2)
        ix = xs[:, None] + dx[None, :]  # (nbx, B2)
        # vals[by, bx, i, c] = img[iy[by, i], ix[bx, i], c]
        vals = img[iy[:, None, :], ix[None, :, :], :]
        vals = vals.reshape(-1, B2, nb).transpose(0, 2, 1)  # (nblocks, C, B2)
    cb = np.asarray(cband, dtype=np.int32)
    core = vals[:, cb, :]
    keep = jnp.asarray((cb == np.arange(nb)).astype(img.dtype))[None, :, None]
    return vals - core * (1 - keep)


def delta_mags(vals, entry_prev, lanewise=None):
    """Running per-band delta in scan order, then mag-sign transform.

    vals: (nblocks, C, B2); entry_prev: (C,) persisted band state
    (QB3common.h:63-65).  Returns (mags, exit_prev).

    Two byte-identical formulations: ``lanewise`` computes the lag-1 shift
    without the transpose to the (C, nblocks*B2) sequence layout (lane i's
    predecessor is lane i-1 of the same block; lane 0's, lane B2-1 of the
    previous block).  Default: lanewise for itemsize > 1; batch kernels
    force it.  Which form is faster on the GPU is not measured yet.
    """
    if lanewise is None:
        lanewise = vals.dtype.itemsize > 1
    if lanewise:
        last = vals[:, :, B2 - 1]  # (nblocks, C)
        prev_block = jnp.concatenate([entry_prev[None, :], last[:-1]], axis=0)
        prev = jnp.concatenate([prev_block[:, :, None], vals[:, :, :-1]],
                               axis=2)
        m = mags(vals - prev)
        return m, last[-1]
    nblocks, nb, _ = vals.shape
    seq = vals.transpose(1, 0, 2).reshape(nb, nblocks * B2)
    prev = jnp.concatenate([entry_prev[:, None], seq[:, :-1]], axis=1)
    m = mags(seq - prev)
    return m.reshape(nb, nblocks, B2).transpose(1, 0, 2), seq[:, -1]


def block_rungs(m, entry_runbits):
    """Per-block bitsused/rung and the lag-1 rung chain (QB3encode.h:439-441).

    Returns (bitsused (nblocks,C), rung (nblocks,C) int32, oldrung int32,
    exit_runbits (C,)).
    """
    bitsused = m[..., 0]
    for i in range(1, B2):
        bitsused = bitsused | m[..., i]
    rung = topbit(bitsused | jnp.ones_like(bitsused))
    oldrung = jnp.concatenate([entry_runbits[None, :].astype(jnp.int32), rung[:-1]], axis=0)
    return bitsused, rung, oldrung, rung[-1]


def value_codes(m, rung, skipstep: bool):
    """Per-value (code, length) in group context, all rungs.

    m: (nblocks, C, B2) mag-sign values (native unsigned dtype);
    rung: (nblocks, C) int32.  Handles the step flip (QB3encode.h:169-176),
    table rungs 0-7 and the computed code with the rung-63 65-bit case
    (QB3encode.h:248-276).  Returns (codes u64, lens i32, ebits u32, elens i32)
    where (ebits, elens) carry the 65th bit emitted after the code.
    """
    tbits = jnp.iinfo(m.dtype).bits
    if not skipstep:
        match, ones = step_flip_index(m, rung)
        flip_ok = match & (rung >= 0) & (ones > 0)
        flip_idx = ones - 1
        lane = jnp.arange(B2, dtype=jnp.int32)
        do_flip = flip_ok[..., None] & (lane == flip_idx[..., None]) & (rung[..., None] >= 1)
        m = m ^ (jnp.where(do_flip, 1, 0).astype(m.dtype) << rung[..., None].astype(m.dtype))

    rung_b = rung[..., None]  # broadcast over lanes
    m64 = m.astype(jnp.uint64)

    # table path (rung <= 7): values < 256 guaranteed
    tr = jnp.clip(rung_b, 0, 7)
    tv = jnp.clip(m64, 0, 255).astype(jnp.int32)
    tbl_len = _ENC_GROUP_LEN[tr, tv]
    tbl_code = _ENC_GROUP_CODE[tr, tv].astype(jnp.uint64)

    if tbits > 8:
        # computed path (rung >= 8): qb3csz (QB3encode.h:132-141)
        r64 = rung_b.astype(jnp.uint64)
        nxt = (m64 >> (r64 - 1)) & 1
        top = m64 >> r64
        tb = jnp.uint64(1) << r64
        comp_len = rung_b + (top + (top | nxt)).astype(jnp.int32)
        c_short = m64 << 1
        c_nom = (((m64 << 1) ^ tb) << 1) | 1
        c_long = ((m64 ^ tb) << 2) | 3
        comp_code = jnp.where(top == 1, c_long, jnp.where(nxt == 1, c_nom, c_short))
        use_tbl = rung_b <= 7
        lens = jnp.where(use_tbl, tbl_len, comp_len)
        codes = jnp.where(use_tbl, tbl_code, comp_code)
        if tbits == 64:
            # rung-63 long code is 65 bits: emit low 64 then bit 62 of the value
            ovf = lens == 65
            ebits = jnp.where(ovf, (m64 >> 62) & 1, 0).astype(jnp.uint32)
            elens = ovf.astype(jnp.int32)
            lens = lens - elens
        else:
            ebits = jnp.zeros_like(tbl_code, dtype=jnp.uint32)
            elens = jnp.zeros_like(tbl_len)
    else:
        lens, codes = tbl_len, tbl_code
        ebits = jnp.zeros_like(tbl_code, dtype=jnp.uint32)
        elens = jnp.zeros_like(tbl_len)

    # rung-0 class blocks (bitsused <= 1): value bits emitted in the prefix path
    return codes, lens, ebits, elens


def _work_dtype(tbits: int):
    """Math width for code construction: u32 for 8/16-bit types (codes are at
    most 17+1 bits), u64 for 32/64-bit."""
    return jnp.uint32 if tbits <= 16 else jnp.uint64


def value_codes_arith(m, rung, skipstep: bool):
    """Arithmetic (gather-free) group value codes.

    Equivalent to value_codes(): the per-rung tables are just the base VLC
    (QB3encode.h:132-141) composed with a value swap (rung 1: 1<->2, rung 2:
    3<->4, rungs 3..7: 2^r-1 <-> 2^r), so both are computed branchlessly
    instead of gathered from 256-entry tables.
    """
    tbits = jnp.iinfo(m.dtype).bits
    W = _work_dtype(tbits)
    if not skipstep:
        match, ones = step_flip_index(m, rung)
        flip_ok = match & (ones > 0)
        lane = jnp.arange(B2, dtype=jnp.int32)
        do_flip = flip_ok[..., None] & (lane == (ones - 1)[..., None]) & (rung[..., None] >= 1)
        m = m ^ (jnp.where(do_flip, 1, 0).astype(m.dtype) << rung[..., None].astype(m.dtype))

    v = m.astype(W)
    rung_b = rung[..., None]
    rw = rung_b.astype(W)
    one = jnp.ones((), W)

    # group-context value swap (rungs 1..7 only)
    a = jnp.where(rung_b == 1, one, jnp.where(rung_b == 2, one * 3,
                  (one << jnp.clip(rw, 0, 7)) - 1))
    do_swap = (rung_b >= 1) & (rung_b <= 7)
    v = jnp.where(do_swap & (v == a), a + 1,
        jnp.where(do_swap & (v == a + 1), a, v))

    # base VLC (works for rung >= 1; rung-0 groups take the prefix path)
    r = jnp.maximum(rung_b, 1)
    rwc = r.astype(W)
    nxt = (v >> (rwc - 1)) & 1
    top = v >> rwc
    tb = one << rwc
    lens = r + (top + (top | nxt)).astype(jnp.int32)
    codes = jnp.where(top == 1, ((v ^ tb) << 2) | 3,
            jnp.where(nxt == 1, (((v << 1) ^ tb) << 1) | 1, v << 1))

    if tbits == 64:
        ovf = lens == 65
        ebits = jnp.where(ovf, (v >> 62) & 1, 0).astype(jnp.uint32)
        elens = ovf.astype(jnp.int32)
        lens = lens - elens
    else:
        ebits = jnp.zeros(lens.shape, dtype=jnp.uint32)
        elens = jnp.zeros_like(lens)
    return codes, lens, ebits, elens


def csw_arith(rung, oldrung, ubits: int):
    """Arithmetic codeswitch code (tables.py CSW equivalent): delta 0 is one
    0 bit, otherwise flag + base VLC of the biased mag-sign delta at rung
    ubits-1 (attic/tables.py:115-133)."""
    mask = (1 << ubits) - 1
    sb = 1 << (ubits - 1)
    d = (rung - oldrung) & mask
    msv = jnp.where(d & sb, 2 * ((1 << ubits) - d) - 1, 2 * ((d - 1) & (sb - 1)))
    r = ubits - 1  # static, >= 2
    nxt = (msv >> (r - 1)) & 1
    top = msv >> r
    tb = 1 << r
    ln = r + top + (top | nxt) + 1
    code = jnp.where(top == 1, ((msv ^ tb) << 2) | 3,
           jnp.where(nxt == 1, (((msv << 1) ^ tb) << 1) | 1, msv << 1))
    code = (code << 1) | 1
    return (jnp.where(d == 0, 0, code).astype(jnp.uint32),
            jnp.where(d == 0, 1, ln))


def fast_symbols(m, bitsused, rung, oldrung, ubits: int, skipstep: bool):
    """Symbols for the fast encoder (FTL / BASE): per block/band
    [prefix, v0..v15 (, e0..e15)] codes and lengths.

    Returns (codes u64, lens i32) of shape (nblocks, C, nsym) in stream order.
    """
    tbits = int(jnp.iinfo(m.dtype).bits)
    W = _work_dtype(tbits)
    cs_code32, cs_len = csw_arith(rung, oldrung, ubits)
    cs_code = cs_code32.astype(W)

    rung0 = bitsused <= 1  # all-zero or single-bit group (QB3encode.h:159-165)
    flag = (bitsused & 1).astype(W)
    prefix_code = jnp.where(rung0, cs_code | (flag << cs_len.astype(W)), cs_code)
    prefix_len = jnp.where(rung0, cs_len + 1, cs_len)

    codes, lens, ebits, elens = value_codes_arith(m, rung, skipstep)
    # rung-0 class: each value is a single bit when bitsused==1, nothing if 0
    r0 = rung0[..., None]
    bit1 = (bitsused == 1)[..., None]
    codes = jnp.where(r0, m.astype(W) & 1, codes)
    lens = jnp.where(r0, jnp.where(bit1, 1, 0), lens)
    elens = jnp.where(r0, 0, elens)

    parts_codes = [prefix_code[..., None], codes]
    parts_lens = [prefix_len[..., None], lens]
    if tbits == 64:
        # interleave value codes and their 65th bits: v0,e0,v1,e1,...
        vi = jnp.stack([codes, ebits.astype(W)], axis=-1).reshape(*codes.shape[:-1], 2 * B2)
        li = jnp.stack([lens, elens], axis=-1).reshape(*lens.shape[:-1], 2 * B2)
        parts_codes = [prefix_code[..., None], vi]
        parts_lens = [prefix_len[..., None], li]
    return (
        jnp.concatenate(parts_codes, axis=-1),
        jnp.concatenate(parts_lens, axis=-1),
    )


def encode_fast_blocks(img, entry_prev, entry_runbits, order: int,
                       cband: tuple[int, ...], skipstep: bool,
                       with_rungs: bool = False, lanewise=None):
    """Full phase-A for the fast encoder on one image.

    img: (H, W, C) unsigned; returns (codes, lens, exit_prev, exit_runbits)
    with codes/lens flattened to (nsymbols,) in stream order.
    with_rungs=True appends the per-block rung tensor (nblocks, C) int32 —
    the running runbits state, needed by the "ic" chunked-index sidecar.
    lanewise passes through to delta_mags (batch kernels force True).
    """
    ubits = ubits_for(img.dtype.itemsize)
    vals = gather_blocks(img, order, cband)
    m, exit_prev = delta_mags(vals, entry_prev, lanewise)
    bitsused, rung, oldrung, exit_runbits = block_rungs(m, entry_runbits)
    codes, lens = fast_symbols(m, bitsused, rung, oldrung, ubits, skipstep)
    nsym = codes.shape[-1]
    out = (codes.reshape(-1, nsym), lens.reshape(-1, nsym),
           exit_prev, exit_runbits)
    if with_rungs:
        out = out + (rung,)
    return out
