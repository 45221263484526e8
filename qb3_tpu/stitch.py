"""Bit-granularity stream concatenation, vectorized.

QB3 payloads are bit-dense: appending one sub-stream after another lands at
arbitrary bit phase.  Each part is concatenated with two vectorized u64
shift/OR passes (O(words) numpy ops, no Python bigint), so multi-strip and
multi-shard assembly stays off the critical path.  reference analog: the
shared oBits accumulator across sub-encodes (QB3encode.cpp:405-455).
"""

from __future__ import annotations

import numpy as np


def _as_u64(words: np.ndarray, nbits: int) -> np.ndarray:
    """View any word array as little-endian u64 words, masked to nbits."""
    b = np.ascontiguousarray(words).view(np.uint8)
    nbytes = (nbits + 7) // 8
    nw = (nbits + 63) // 64
    buf = np.zeros(nw * 8, np.uint8)
    buf[:nbytes] = b[:nbytes]
    w = buf.view("<u8").copy()
    tail = nbits & 63
    if nw and tail:
        w[-1] &= np.uint64((1 << tail) - 1)
    return w


def stitch_words(parts) -> tuple[np.ndarray, int]:
    """parts: iterable of (words_array, nbits) -> (u64 words, total_bits).

    Bits of part k start at sum(nbits of parts < k); unused tail bits of the
    result are zero.
    """
    parts = [(w, int(n)) for w, n in parts]
    total = sum(n for _, n in parts)
    out = np.zeros(total // 64 + 2, np.uint64)
    off = 0
    for words, nbits in parts:
        if nbits == 0:
            continue
        w = _as_u64(words, nbits)
        base, s = off >> 6, off & 63
        nw = w.shape[0]
        if s == 0:
            out[base : base + nw] |= w
        else:
            s64 = np.uint64(s)
            out[base : base + nw] |= w << s64
            out[base + 1 : base + nw + 1] |= w >> np.uint64(64 - s)
        off += nbits
    return out, total


def stitch_bytes(parts) -> bytes:
    """stitch_words, returned as the payload byte string."""
    words, total = stitch_words(parts)
    return words.view(np.uint8)[: (total + 7) // 8].tobytes()


def scatter_stitch_shard(words32, nbits, axis):
    """Multi-device stitch, run INSIDE shard_map: each shard phase-shifts its
    packed bits to the global bit offset and keeps its OWN word span; the
    only inter-device data is the all-gather of per-shard bit totals (8 B
    each) and one boundary word.  Replaces the post-shard_map stitch
    (stitch_words_device), whose implicit all-gather moves O(stream bytes)
    to every device (doc/SCALING.md item 1).

    words32: (NW32,) uint32 local packed stream (bits past nbits garbage);
    nbits: local bit count (scalar).  Returns (own (NW64+1,) u64 words,
    n_own, nbits) — global words base..base+n_own, where own[n_own] is the
    partial boundary word shared with the NEXT shard's word 0 (host-side
    assemble_scatter ORs the overlap; doing it on device would need a
    serial carry chain that breaks when a shard owns zero words)."""
    import jax
    import jax.numpy as jnp

    nw32 = words32.shape[0]
    nw64 = (nw32 + 1) // 2
    w = jax.lax.bitcast_convert_type(
        jnp.pad(words32, (0, nw32 % 2)).reshape(nw64, 2),
        jnp.uint64).reshape(nw64)
    nbits = nbits.astype(jnp.int64)
    all_tot = jax.lax.all_gather(nbits, axis)
    S = all_tot.shape[0]
    my = jax.lax.axis_index(axis)
    off = jnp.sum(jnp.where(jnp.arange(S) < my, all_tot, 0))
    end = off + nbits
    base = off >> 6
    # non-last shards do not own their partial tail word (the next shard's
    # region starts inside it); the last shard owns through the end
    n_own = (jnp.where(my == S - 1, (end + 63) >> 6, end >> 6) - base
             ).astype(jnp.int32)

    nwords = (nbits + 63) >> 6
    lane = jnp.arange(nw64, dtype=jnp.int64)
    tail = (nbits & 63).astype(jnp.uint64)
    tmask = jnp.where(tail == 0, ~jnp.uint64(0), (jnp.uint64(1) << tail) - 1)
    w = jnp.where(lane < nwords - 1, w,
                  jnp.where(lane == nwords - 1, w & tmask, jnp.uint64(0)))
    sh = (off & 63).astype(jnp.uint64)
    lo = jnp.where(sh == 0, w, w << sh)
    prevw = jnp.concatenate([jnp.zeros(1, jnp.uint64), w[:-1]])
    hi = jnp.where(sh == 0, jnp.uint64(0), prevw >> (jnp.uint64(64) - sh))
    spill = jnp.where(sh == 0, jnp.uint64(0), w[-1] >> (jnp.uint64(64) - sh))
    ext = jnp.concatenate([lo | hi, spill[None]])  # global words base..base+nw64
    return ext, n_own, nbits


def assemble_scatter(owns: np.ndarray, n_owns: np.ndarray,
                     totals: np.ndarray) -> bytes:
    """Host assembly of scatter_stitch_shard outputs: word-aligned
    concatenation; consecutive shards share one boundary word, whose
    disjoint-bit halves combine with an OR (so shards owning zero whole
    words — tiny/highly-compressible strips — just OR their bits into the
    shared word instead of corrupting the chain)."""
    total = int(totals.sum())
    out = np.zeros(total // 64 + 2, np.uint64)
    offs = np.cumsum(totals) - totals
    for s in range(owns.shape[0]):
        base = int(offs[s]) >> 6
        n = int(n_owns[s])
        out[base : base + n + 1] |= owns[s][: n + 1]
    return out.view(np.uint8)[: (total + 7) // 8].tobytes()


def stitch_words_device(words, totals, n_out: int):
    """Device-side stitch: per-shard word buffers -> one bit-dense stream.

    words: (S, NW) uint32 on device (per-shard packed streams, bits beyond
    totals[s] unspecified); totals: (S,) bit lengths; n_out: static output
    u64 word count (>= ceil(sum(totals)/64) + 1).  Each shard's words are
    masked, funnel-shifted to its bit phase, and placed at its word offset
    with two dynamic_update_slices; shards combine with one sum.  O(S*n_out)
    vector work, no host roundtrip until the final byte copy.
    """
    import jax
    import jax.numpy as jnp

    S, nw32 = words.shape
    nw64 = (nw32 + 1) // 2
    w64 = jax.lax.bitcast_convert_type(
        jnp.pad(words, ((0, 0), (0, nw32 % 2))).reshape(S, nw64, 2),
        jnp.uint64).reshape(S, nw64)
    totals = totals.astype(jnp.int64)
    offs = jnp.cumsum(totals) - totals  # exclusive prefix

    def place(w, nbits, off):
        # mask bits past nbits (the pack kernels leave garbage there)
        nwords = (nbits + 63) >> 6
        lane = jnp.arange(nw64, dtype=jnp.int64)
        tail = (nbits & 63).astype(jnp.uint64)
        tmask = jnp.where(tail == 0, ~jnp.uint64(0),
                          (jnp.uint64(1) << tail) - 1)
        w = jnp.where(lane < nwords - 1, w,
                      jnp.where(lane == nwords - 1, w & tmask, 0))
        sh = (off & 63).astype(jnp.uint64)
        lo = jnp.where(sh == 0, w, w << sh)
        prev = jnp.concatenate([jnp.zeros(1, jnp.uint64), w[:-1]])
        hi = jnp.where(sh == 0, jnp.uint64(0),
                       prev >> (jnp.uint64(64) - sh))
        part = lo | hi
        spill = jnp.where(sh == 0, jnp.uint64(0),
                          w[-1] >> (jnp.uint64(64) - sh))
        buf = jnp.zeros(n_out + nw64 + 1, jnp.uint64)
        buf = jax.lax.dynamic_update_slice(
            buf, jnp.concatenate([part, spill[None]]), ((off >> 6),))
        return buf[:n_out]

    placed = jax.vmap(place)(w64, totals, offs)
    return jnp.sum(placed, axis=0), jnp.sum(totals)
