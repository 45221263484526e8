"""Small vectorized bit-manipulation primitives shared by encode/decode.

These are the tensor-wide equivalents of the scalar helpers in the reference
(QB3common.h:42-61 topbit, :127-136 mags/smag, :141-166 step): every function
operates on whole tensors of microblocks at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import B2


def topbit(v):
    """floor(log2(v)) per element; undefined for 0 (callers pass v|1).

    Equivalent of QB3common.h:44-60.
    """
    nbits = jnp.iinfo(v.dtype).bits
    return (nbits - 1) - jax.lax.clz(v).astype(jnp.int32)


def mags(v):
    """Two's complement -> mag-sign with sign in bit 0 (QB3common.h:127-130)."""
    nbits = jnp.iinfo(v.dtype).bits
    sign = v >> (nbits - 1)  # 0 or 1 (unsigned shift)
    return (v << 1) ^ (jnp.zeros_like(v) - sign)


def smag(v):
    """Mag-sign -> two's complement (QB3common.h:132-136)."""
    return (v >> 1) ^ (jnp.zeros_like(v) - (v & 1))


def magsabs(v):
    """Absolute value of a mag-sign value (QB3encode.h:92)."""
    return (v >> 1) + (v & 1)


def magsdiv(v, cf):
    """Divide a mag-sign value by a positive factor (QB3encode.h:95)."""
    return ((magsabs(v) // cf) << 1) - (v & 1)


def magsmul(v, m):
    """Multiply a mag-sign value by a positive factor (QB3decode.h:575)."""
    return magsabs(v) * (m << 1) - (v & 1)


def step_flip_index(m, rung):
    """Vectorized step detector (QB3common.h:141-166).

    ``m`` is (..., B2) mag-sign values, ``rung`` is (...,) int32.  Returns
    (match, ones) where ``match`` is True when the per-value rung bits in scan
    order form the pattern 1*0* and ``ones`` counts the set rung bits.
    """
    rungbits = ((m >> rung[..., None].astype(m.dtype)) & 1).astype(jnp.uint32)
    # accumulate LSB-first: bit i = rung bit of value i
    weights = (jnp.uint32(1) << jnp.arange(B2, dtype=jnp.uint32))
    acc = jnp.sum(rungbits * weights, axis=-1, dtype=jnp.uint32)
    match = (acc & (acc + 1)) == 0  # low-ones pattern (incl. all-zero)
    ones = jnp.where(acc == 0, 0, topbit(acc | 1) + 1)  # count of set rung bits
    # encoder flips index ones-1 when match & ones>0 (QB3encode.h:169-176);
    # decoder flips index ones when match (QB3decode.h:285-289)
    return match, ones


def words_u32(words):
    """Flat little-endian uint32 view of the payload words.

    Accepts uint32 (what the decode kernels are given) or uint64."""
    if words.dtype == jnp.uint32:
        return words.reshape(-1)
    return jax.lax.bitcast_convert_type(words, jnp.uint32).reshape(-1)


def words_u64(words):
    """Flat little-endian uint64 view of the payload words (for the
    peek64-based paths); converse of :func:`words_u32`."""
    if words.dtype == jnp.uint64:
        return words.reshape(-1)
    return jax.lax.bitcast_convert_type(
        words.reshape(-1, 2), jnp.uint64).reshape(-1)


def peek64(words64, bitpos):
    """Gather 64 stream bits starting at arbitrary bit positions.

    ``words64`` is the stream as little-endian uint64 words (padded by one
    extra word); ``bitpos`` any-shape int64 bit offsets.  Equivalent of
    iBits::peek (bitstream.h:39-50).
    """
    widx = (bitpos >> 6).astype(jnp.int32)
    sh = (bitpos & 63).astype(jnp.uint32)
    w0 = words64[widx]
    w1 = words64[widx + 1]
    lo = w0 >> sh
    # (w1 << (64-sh)) with sh==0 handled: contribution must be 0
    hi = jnp.where(sh == 0, jnp.uint64(0), w1 << ((jnp.uint32(64) - sh) & 63))
    return lo | hi
