"""Batched multi-tile encode/decode: many same-shape rasters per dispatch.

The serving shape (BASELINE config 4: tile pyramids, 8-band Landsat
scenes): one kernel launch encodes/decodes a whole batch of tiles,
amortizing dispatch and keeping the device busy.  Each tile is an
independent QB3 stream (fresh band state), identical to encoding it alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import container
from .api import DT_FROM_NP, NP_FROM_DT, UNSIGNED, default_cband, max_encoded_size
from .errors import QB3ShapeError
from .constants import B, HILBERT, B2, DType, Mode


@functools.lru_cache(maxsize=32)
def _batch_encode_kernel(n, shape, npdtype, order, cband, skipstep, n_words,
                         maxbits=None):
    from .ops.bitpack import group_bits_bound, pack_groups
    from .ops.encode import encode_fast_blocks

    if maxbits is None:
        maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=False)
    nb = shape[2]

    def one(img):
        zp = jnp.zeros(nb, dtype=img.dtype)
        zr = jnp.zeros(nb, dtype=jnp.int32)
        codes, lens, _, _, rung = encode_fast_blocks(img, zp, zr, order, cband,
                                                     skipstep, with_rungs=True,
                                                     lanewise=True)
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        return words, total, glen, rung

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=32)
def _batch_encode_kernel_ic(n, shape, npdtype, order, cband, skipstep,
                            n_words, k_blocks):
    """Batch encode emitting the "ic" sidecar pieces ON DEVICE: per-chunk
    bit spans (segment sums of glens) and entry rung state (every k-th
    block's runbits).  The host then fetches 14 KB/tile of sidecar instead
    of the full per-group tensors (~300 KB/tile)."""
    from .ops.bitpack import group_bits_bound, pack_groups
    from .ops.encode import encode_fast_blocks

    maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=False)
    h, w, nb = shape
    nblocks = (h // B) * (w // B)
    nchunks = -(-nblocks // k_blocks)

    def one(img):
        zp = jnp.zeros(nb, dtype=img.dtype)
        zr = jnp.zeros(nb, dtype=jnp.int32)
        codes, lens, _, _, rung = encode_fast_blocks(img, zp, zr, order, cband,
                                                     skipstep, with_rungs=True,
                                                     lanewise=True)
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        g = jnp.zeros(nchunks * k_blocks * nb, jnp.int32)
        g = g.at[: nblocks * nb].set(glen.astype(jnp.int32))
        spans = g.reshape(nchunks, -1).sum(axis=1).astype(jnp.uint32)
        entry = jnp.concatenate(
            [jnp.zeros((1, nb), jnp.int32),
             rung[k_blocks - 1: (nchunks - 1) * k_blocks: k_blocks]], axis=0)
        return words, total, spans, entry.astype(jnp.uint8)

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=32)
def _batch_best_kernel(n, shape, npdtype, order, cband, n_words):
    """Best-mode batch encode (plain vmap; keep best batches small).

    The index-trial intermediates ((nblocks, C, 16, 16) eq tensors,
    encode_best.py) scale device memory with the batch."""
    from .ops.bitpack import group_bits_bound, pack_groups
    from .ops.encode_best import encode_best_blocks

    maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=True)
    nb = shape[2]

    def one(img):
        zp = jnp.zeros(nb, dtype=img.dtype)
        zr = jnp.zeros(nb, dtype=jnp.int32)
        codes, lens, _, _, _, meta16, cfv, _, _ = encode_best_blocks(
            img, zp, zr, zp, order, cband)
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        return words, total, glen, meta16, cfv

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=32)
def _batch_best_decode_kernel(n, nblocks, nbands, h, w, order, cband,
                              npdtype, n_words, apply_step=True):
    """Flat multi-tile best-mode decode: val_pos already carries per-tile
    word bases, so one decode_groups_fused pass covers the whole batch."""
    from .ops.decode import decode_groups_fused, reconstruct_batch

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8

    def run(words64_flat, kind, val_pos, vrung, cf):
        g = decode_groups_fused(words64_flat, kind, val_pos, vrung, cf,
                                apply_step, tbits)
        g = g.reshape(n, nblocks, nbands, B2)
        return reconstruct_batch(g, h, w, nbands, order, cband, out_dtype)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _batch_decode_kernel_chunked(n, nblocks, nbands, h, w, order, cband,
                                 apply_step, npdtype, n_words, k_blocks):
    """Flat multi-tile self-contained decode: tiles' chunks concatenate into
    one chunk-parallel walk (starts carry per-tile word bases), so the whole
    batch rides one dispatch."""
    from .ops.decode import reconstruct_batch
    from .ops.decode_chunked import decode_chunked

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8
    nchunks_per = -(-nblocks // k_blocks)

    def run(words64_flat, starts, entry_rungs):
        g = decode_chunked(words64_flat, starts, entry_rungs, k_blocks,
                           n * nchunks_per * k_blocks, nbands, apply_step,
                           tbits)
        g = g.reshape(n, nchunks_per * k_blocks, nbands, B2)[:, :nblocks]
        return reconstruct_batch(g, h, w, nbands, order, cband, out_dtype)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _batch_decode_kernel(n, nblocks, nbands, h, w, order, cband, apply_step,
                         npdtype, n_words, tile_words32=0, nreg=None):
    """Flat multi-tile indexed decode: one gather + wavefront over the
    concatenated batch (ntiles * nblocks * nbands groups)."""
    from .ops.decode import decode_indexed_narrow, reconstruct_batch

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8

    def run(words64_flat, glens_flat):
        g = decode_indexed_narrow(words64_flat, glens_flat, nblocks, nbands,
                                  apply_step, tbits, ntiles=n,
                                  tile_words32=tile_words32, nreg=nreg)
        g = g.reshape(n, nblocks, nbands, B2)
        return reconstruct_batch(g, h, w, nbands, order, cband, out_dtype)

    return jax.jit(run)


def _flat_tile_layout(wlists):
    """Concatenate per-tile u64 payload words at a fixed 64-word-aligned
    stride -> (flat words (n, tw64) u64, tile stride in u32 words)."""
    tw64 = max(len(x) for x in wlists) + 2
    tw64 = -(-tw64 // 64) * 64  # 512-byte aligned tile stride
    flat = np.zeros((len(wlists), tw64), np.uint64)
    for j, x in enumerate(wlists):
        flat[j, : len(x)] = x
    return flat, tw64 * 2


def encode_tiles(imgs: np.ndarray, mode: int = Mode.FTL, coreband=None,
                 index: bool = False) -> list[bytes]:
    """Encode (N, H, W, C) same-shape tiles in one dispatch -> N streams.

    FTL/BASE only (the batch path targets throughput serving); each tile's
    stream is byte-identical to a standalone encode.
    """
    if imgs.ndim != 4:
        raise QB3ShapeError("expected (N, H, W, C) tiles")
    n, h, w, nb = imgs.shape
    best = mode in (Mode.CF_H, Mode.CF)
    if (mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z) and not best) \
            or h < B or w < B:
        raise QB3ShapeError("batch encode supports FTL/BASE/BEST tiles >= 4x4")
    dt = DT_FROM_NP[imgs.dtype]
    cband = tuple(coreband) if coreband is not None else tuple(default_cband(nb))
    zorder = mode in (Mode.BASE_Z, Mode.CF)
    order = 0x0145236789CDABEF if zorder else HILBERT
    uns = imgs.view(UNSIGNED[imgs.dtype.itemsize])
    n_words = (max_encoded_size(w, h, nb, dt) + 3) // 4 + 2
    meta16 = cfv = None
    if best:
        kern = _batch_best_kernel(n, (h, w, nb), uns.dtype.name, order, cband,
                                  n_words)
        words, totals, glens, meta16, cfv = kern(jnp.asarray(uns))
        meta16, cfv = np.asarray(meta16), np.asarray(cfv)
    else:
        kern = _batch_encode_kernel(n, (h, w, nb), uns.dtype.name, order, cband,
                                    mode == Mode.FTL, n_words)
        words, totals, glens, rungs = kern(jnp.asarray(uns))
        rungs = np.asarray(rungs)
    words = np.asarray(words)
    totals = np.asarray(totals)
    glens = np.asarray(glens)
    from .offsets import KIND_CF, KIND_CF0
    from .ops.bitpack import words_to_bytes
    out = []
    for i in range(n):
        idx, sig = None, b"ix"
        if index and best:
            kind = meta16[i] & 7
            cfm = cfv[i][(kind == KIND_CF) | (kind == KIND_CF0)].astype(np.uint64)
            if not (cfm.size and int(cfm.max()) > 0xFFFF):
                idx, sig = (glens[i].astype("<u2").tobytes()
                            + meta16[i].astype("<u2").tobytes()
                            + cfm.astype("<u2").tobytes()), b"ib"
        elif index == "ic":
            from .ops.decode_chunked import IC_DEFAULT_K, chunk_spans, pack_ic

            spans, entry = chunk_spans(glens[i].astype(np.int64), rungs[i],
                                       np.zeros(nb, np.int32), IC_DEFAULT_K)
            if int(spans.sum()) < 1 << 31:
                idx, sig = pack_ic(spans, entry, IC_DEFAULT_K), b"ic"
        elif index:
            idx = glens[i].astype("<u2").tobytes()
        hdr = container.write_headers(
            w, h, nb, dt, mode, list(cband), 1,
            0x0145236789CDABEF if zorder else 0, idx, sig)
        out.append(hdr + words_to_bytes(words[i], int(totals[i])))
    return out


def decode_tiles(streams: list[bytes]) -> np.ndarray:
    """Decode N same-shape indexed FTL/BASE streams in one dispatch."""
    from .ops.decode import payload_words

    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
           (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode) for i in infos):
        raise QB3ShapeError("batch decode requires same-shape streams")
    best = all(i.index_best is not None for i in infos)
    chunked = all(i.index_chunked is not None for i in infos)
    if not best and not chunked and any(i.index is None for i in infos):
        raise QB3ShapeError("batch decode needs the ix, ic or ib sidecar")
    h, w, nb = i0.ysize, i0.xsize, i0.nbands
    if h % B != 0 or w % B != 0:
        raise QB3ShapeError("batch decode requires 4-aligned tiles")
    np_dt = NP_FROM_DT[DType(i0.dtype)]
    uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
    nblocks = (h // B) * (w // B)
    order = i0.order or HILBERT

    wlists = [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)]
    flat, tile_words32 = _flat_tile_layout(wlists)
    n_words = flat.size
    if n_words * 64 >= 1 << 31:
        # the flat walk carries int32 bit cursors (ops/decode.py)
        raise QB3ShapeError(
            "batch exceeds the 2^31-bit flat-decode limit; split the batch")
    tb = np.dtype(uns_dt).itemsize * 8
    n = len(streams)
    if chunked and not best:
        from .ops.decode_chunked import parse_ic

        metas = [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
        if any(m is None for m in metas) or \
                any(m[0] != metas[0][0] for m in metas):
            raise QB3ShapeError("inconsistent ic sidecar")
        k = metas[0][0]
        tbase = (np.arange(n, dtype=np.int64) * tile_words32 * 32)[:, None]
        starts = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
        entry = np.concatenate([m[2] for m in metas])
        kern = _batch_decode_kernel_chunked(
            n, nblocks, nb, h, w, order, tuple(i0.cband),
            i0.mode != Mode.FTL, np.dtype(uns_dt).name, n_words, k)
        out = np.asarray(kern(jnp.asarray(flat.reshape(-1).view(np.uint32)),
                              jnp.asarray(starts.astype(np.int32)),
                              jnp.asarray(entry)))
        return out.view(np_dt)
    if best:
        from .api import _parse_best_sidecar

        metas = [_parse_best_sidecar(i.index_best, nblocks * nb) for i in infos]
        if any(m is None for m in metas):
            raise QB3ShapeError("inconsistent ib sidecar")
        tbase = (np.arange(n, dtype=np.int64) * tile_words32 * 32)[:, None]
        kind = np.stack([m[0] for m in metas]).reshape(-1)
        val_pos = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
        vrung = np.stack([m[2] for m in metas]).reshape(-1)
        cf = np.stack([m[3] for m in metas]).reshape(-1)
        kern = _batch_best_decode_kernel(n, nblocks, nb, h, w,
                                         order, tuple(i0.cband),
                                         np.dtype(uns_dt).name, n_words)
        out = np.asarray(kern(jnp.asarray(flat.reshape(-1).view(np.uint32)), jnp.asarray(kind),
                              jnp.asarray(val_pos), jnp.asarray(vrung),
                              jnp.asarray(cf)))
        return out.view(np_dt)
    glens = np.stack([
        np.frombuffer(i.index, dtype="<u2").astype(np.int32) for i in infos])
    from .api import _indexed_nreg
    kern = _batch_decode_kernel(n, nblocks, nb, h, w, order,
                                tuple(i0.cband), i0.mode != Mode.FTL,
                                np.dtype(uns_dt).name, n_words,
                                tile_words32, _indexed_nreg(glens, tb))
    out = np.asarray(kern(jnp.asarray(flat.reshape(-1).view(np.uint32)),
                          jnp.asarray(glens.reshape(-1))))
    return out.view(np_dt)
