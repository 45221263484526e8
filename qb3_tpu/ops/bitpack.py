"""Phase B: parallel variable-length bit packing.

Replaces the serial oBits writer (bitstream.h:66-126).  Every symbol's
absolute bit position is the exclusive prefix sum of the symbol lengths, so
all symbols can be placed at once.  pack_groups does it in two levels: the
symbols of each group fold into a few 32-bit words already shifted to the
group's bit phase, and one scatter-add lands those slabs in the output.
Contributions of different symbols touch disjoint bits, so the sums equal
the serial stream's ORs exactly and the order of the adds does not matter.

The stream is little-endian at bit level: bit position p lives in byte p>>3
at weight 1<<(p&7); uint32 words view as 4 little-endian bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_M32_64 = jnp.uint64(0xFFFFFFFF)


def group_bits_bound(tbits: int, best: bool) -> int:
    """Static bound on one group's emitted bits (prefix + values [+ extras /
    CF header / index uniques])."""
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    if not best:
        return (ubits + 2) + 1 + 16 * (tbits + 2) + (16 if tbits == 64 else 0)
    # best: signal+cs+flags + own-rung csw + cf code + values + extras + uniques
    return (ubits + 2) * 3 + 2 + (tbits + 2) + 16 * (tbits + 2) + \
        (16 if tbits == 64 else 0) + 8 * (tbits + 2)


def maxbits_bucket(max_glen: int, tbits: int, best: bool = False) -> int:
    """Tightened static pack bound from a stream's observed max group
    length (e.g. ``max(glens)`` of an ix sidecar), rounded up to 64 bits
    to bound the kernel-variant count.  Exact for any stream whose groups
    stay within the bucket; re-encoding the SAME data is always safe."""
    return min(group_bits_bound(tbits, best), -(-int(max_glen) // 64) * 64)


def pack_groups(codes, lens, n_words: int, max_group_bits: int):
    """Pack (ngroups, S) symbols in stream order into uint32 words.

    Each group's symbols fold into a W-word slab at the group's bit phase
    (off % 32); W is static from max_group_bits.  The slab then lands at
    word off >> 5 with a single scatter-add of ngroups*W updates.
    Returns (words uint32 (n_words,), total bits, per-group bit lengths).
    """
    wide = codes.dtype == jnp.uint64
    il = jnp.cumsum(lens, axis=1, dtype=jnp.int32)
    glen = il[:, -1]
    gend = jnp.cumsum(glen.astype(jnp.int64))
    total = gend[-1]
    goff = gend - glen
    bitpos = (goff & 31).astype(jnp.int32)[:, None] + il - lens
    W = (31 + max_group_bits + 31) // 32

    k = bitpos >> 5
    sh = (bitpos & 31).astype(jnp.uint64)
    t = codes.astype(jnp.uint64) << sh
    lo = (t & _M32_64).astype(jnp.uint32)
    mid = (t >> jnp.uint64(32)).astype(jnp.uint32)
    if wide:
        hi = jnp.where(sh == 0, jnp.uint64(0),
                       codes >> ((jnp.uint64(64) - sh) & 63)).astype(jnp.uint32)

    def jbody(_, j):
        # slab word j: masked sum over the group's symbols
        acc = jnp.sum(jnp.where(k == j, lo, 0), axis=1, dtype=jnp.uint32)
        acc = acc + jnp.sum(jnp.where(k == j - 1, mid, 0), axis=1, dtype=jnp.uint32)
        if wide:
            acc = acc + jnp.sum(jnp.where(k == j - 2, hi, 0), axis=1, dtype=jnp.uint32)
        return None, acc

    _, slabs = jax.lax.scan(jbody, None, jnp.arange(W, dtype=jnp.int32))
    slab = jnp.moveaxis(slabs, 0, 1)  # (ngroups, W)
    base = (goff >> 5).astype(jnp.int32)
    idx = base[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    out = jnp.zeros((n_words,), dtype=jnp.uint32)
    out = out.at[idx.reshape(-1)].add(slab.reshape(-1), mode="drop")
    return out, total, glen.astype(jnp.uint16)


def pack_symbols_scatter(codes, lens, n_words: int):
    """Reference scatter-add implementation (kept for cross-checking)."""
    lens64 = lens.astype(jnp.int64)
    ends = jnp.cumsum(lens64)
    total = ends[-1]
    offs = ends - lens64
    codes = codes.astype(jnp.uint64)
    words = jnp.zeros((n_words,), dtype=jnp.uint32)
    for k in (0, 1):
        c = (codes >> jnp.uint64(32 * k)) & _M32_64
        o = offs + 32 * k
        live = lens > 32 * k
        w = jnp.where(live, (o >> 5).astype(jnp.int32), 0)
        s = jnp.where(live, o & 31, 0).astype(jnp.uint64)
        t = jnp.where(live, c << s, 0)
        words = words.at[w].add((t & _M32_64).astype(jnp.uint32), mode="drop")
        words = words.at[w + 1].add((t >> jnp.uint64(32)).astype(jnp.uint32), mode="drop")
    return words, total


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: uint32 words -> the byte stream (padded to a whole byte)."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words)
    if raw.dtype.byteorder == ">":
        raw = raw.byteswap()
    return raw.view(np.uint8)[:nbytes].tobytes()
