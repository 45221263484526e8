"""Pipelined host-to-host serving API: overlapped upload / compute / fetch.

The one-shot ``encode()``/``decode()`` calls pay the full host-device round
trip per image: upload, dispatch, fetch, each serialized.  This module
streams BATCHES of same-shape tiles through a three-stage software
pipeline:

    upload batch k+1  |  device codec batch k  |  fetch + container batch k-1

JAX's async dispatch gives the overlap for free as long as nothing blocks:
``jax.device_put`` and kernel calls return immediately, and
``copy_to_host_async`` starts the device-to-host fetch early so the later
``np.asarray`` finds the bytes already on host.  Throughput then approaches
the slowest single leg (the line rate) instead of the sum of all legs.

Reference analog: none — the reference is single-call synchronous
(QB3encode.cpp:488); this is the device-serving shape for its
CLI/GDAL-style bulk conversions.
"""

from __future__ import annotations

import numpy as np

from .constants import Mode


def _to_host_async(tree):
    for leaf in tree:
        try:
            leaf.copy_to_host_async()
        except AttributeError:  # pragma: no cover - non-jax leaf
            pass


def encode_tiles_pipelined(batches, mode: int = Mode.FTL, coreband=None,
                           index=False):
    """Encode an iterable of (N, H, W, C) same-shape tile batches ->
    yields one list of container streams per batch, double-buffered.

    Peak rate needs len(batches) >= 3 (fill + steady state + drain)."""
    import jax
    import jax.numpy as jnp

    from . import container
    from .api import DT_FROM_NP, UNSIGNED, default_cband, max_encoded_size
    from .batch import _batch_encode_kernel
    from .constants import HILBERT, B

    kern = None
    pending = None  # (outs, n, shape_meta)

    def finalize(outs, full_words, cap, n, meta):
        h, w, nb, dt, cband, order = meta
        from .ops.bitpack import words_to_bytes
        from .ops.decode_chunked import IC_DEFAULT_K, pack_ic

        streams = []
        if index == "ic":
            words, totals, spans, entry = (np.asarray(o) for o in outs)
        else:
            words, totals, glens = (np.asarray(o) for o in outs[:3])
        need = (np.asarray(totals, np.int64) + 31) >> 5
        if int(need.max()) > cap:
            # rare: a tile compressed worse than the fetch cap — pull its
            # full row from the retained device buffer
            words = np.asarray(full_words)
        for i in range(n):
            idx, sig = None, b"ix"
            if index == "ic":
                if int(spans[i].sum()) < 1 << 31:
                    idx, sig = pack_ic(spans[i], entry[i],
                                       IC_DEFAULT_K), b"ic"
            elif index:
                idx = glens[i].astype("<u2").tobytes()
            hdr = container.write_headers(w, h, nb, dt, mode, list(cband), 1,
                                          0, idx, sig)
            streams.append(hdr + words_to_bytes(words[i], int(totals[i])))
        return streams

    from .batch import _batch_encode_kernel_ic
    from .ops.decode_chunked import IC_DEFAULT_K

    cap_words = None  # adaptive fetch cap, learned from the previous batch

    for tiles in batches:
        n, h, w, nb = tiles.shape
        dt = DT_FROM_NP[tiles.dtype]
        cband = tuple(coreband) if coreband is not None else \
            tuple(default_cband(nb))
        uns = tiles.view(UNSIGNED[tiles.dtype.itemsize])
        n_words = (max_encoded_size(w, h, nb, dt) + 3) // 4 + 2
        if index == "ic":
            kern = _batch_encode_kernel_ic(n, (h, w, nb), uns.dtype.name,
                                           HILBERT, cband, mode == Mode.FTL,
                                           n_words, IC_DEFAULT_K)
        else:
            kern = _batch_encode_kernel(n, (h, w, nb), uns.dtype.name, HILBERT,
                                        cband, mode == Mode.FTL, n_words)
        dev = jax.device_put(jnp.asarray(uns))   # async upload
        outs = kern(dev)                          # async dispatch
        # fetch only the compressed prefix of the words buffer: the cap is
        # last batch's worst ratio + 12.5% headroom, bucketed to n_words/8
        # (finalize falls back to the retained full buffer if exceeded)
        bucket = max(1, n_words // 8)
        if cap_words is None:
            cap = n_words
        else:
            cap = min(n_words, -(-min(n_words, cap_words + bucket) // bucket)
                      * bucket)
        full_words = outs[0]
        if cap < n_words:
            outs = (full_words[:, :cap],) + tuple(outs[1:])
        _to_host_async(outs)                      # early fetch
        if pending is not None:
            streams = finalize(*pending)
            cap_words = max((int(np.asarray(pending[0][1]).max()) + 31) >> 5,
                            1)
            yield streams
        pending = (outs, full_words, cap, n, (h, w, nb, dt, cband, HILBERT))
    if pending is not None:
        yield finalize(*pending)


def decode_tiles_pipelined(stream_batches):
    """Decode an iterable of LISTS of same-shape sidecar-bearing streams ->
    yields one (N, H, W, C) array per list, double-buffered (the dual of
    encode_tiles_pipelined; ix / ic / ib sidecars as in batch.decode_tiles).
    """
    import jax
    import jax.numpy as jnp

    from . import container
    from .api import NP_FROM_DT, UNSIGNED, _indexed_nreg, _parse_best_sidecar
    from .batch import (_batch_best_decode_kernel, _batch_decode_kernel,
                        _batch_decode_kernel_chunked, _flat_tile_layout)
    from .constants import B, DType, HILBERT, Mode
    from .errors import QB3ShapeError
    from .ops.decode import payload_words
    from .ops.decode_chunked import parse_ic

    pending = None  # (out_dev, np_dt, shape)

    for streams in stream_batches:
        infos = [container.parse_headers(s) for s in streams]
        i0 = infos[0]
        if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
               (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode)
               for i in infos):
            raise QB3ShapeError("pipelined decode requires same-shape streams")
        best = all(i.index_best is not None for i in infos)
        chunked = all(i.index_chunked is not None for i in infos)
        if not best and not chunked and any(i.index is None for i in infos):
            raise QB3ShapeError("pipelined decode needs an ix, ic or ib sidecar")
        h, w, nb = i0.ysize, i0.xsize, i0.nbands
        if h % B != 0 or w % B != 0:
            raise QB3ShapeError("pipelined decode requires 4-aligned tiles")
        np_dt = NP_FROM_DT[DType(i0.dtype)]
        uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
        nblocks = (h // B) * (w // B)
        order = i0.order or HILBERT
        n = len(streams)
        wlists = [payload_words(s[i.data_offset:])
                  for s, i in zip(streams, infos)]
        flat, tw32 = _flat_tile_layout(wlists)
        if flat.size * 64 >= 1 << 31:
            raise QB3ShapeError("batch exceeds the 2^31-bit flat-decode limit")
        tb = np.dtype(uns_dt).itemsize * 8
        dwp = jax.device_put(jnp.asarray(flat.reshape(-1).view(np.uint32)))
        if best:
            metas = [_parse_best_sidecar(i.index_best, nblocks * nb)
                     for i in infos]
            if any(m is None for m in metas):
                raise QB3ShapeError("inconsistent ib sidecar")
            tbase = (np.arange(n, dtype=np.int64) * tw32 * 32)[:, None]
            kind = np.stack([m[0] for m in metas]).reshape(-1)
            val_pos = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
            vrung = np.stack([m[2] for m in metas]).reshape(-1)
            cf = np.stack([m[3] for m in metas]).reshape(-1)
            kern = _batch_best_decode_kernel(
                n, nblocks, nb, h, w, order, tuple(i0.cband),
                np.dtype(uns_dt).name, flat.size)
            out = kern(dwp, jnp.asarray(kind), jnp.asarray(val_pos),
                       jnp.asarray(vrung), jnp.asarray(cf))
        elif chunked:
            metas = [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
            if any(m is None for m in metas) or \
                    any(m[0] != metas[0][0] for m in metas):
                raise QB3ShapeError("inconsistent ic sidecar")
            k = metas[0][0]
            tbase = (np.arange(n, dtype=np.int64) * tw32 * 32)[:, None]
            starts = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
            entry = np.concatenate([m[2] for m in metas])
            kern = _batch_decode_kernel_chunked(
                n, nblocks, nb, h, w, order, tuple(i0.cband),
                i0.mode != Mode.FTL, np.dtype(uns_dt).name, flat.size, k)
            out = kern(dwp, jnp.asarray(starts.astype(np.int32)),
                       jnp.asarray(entry))
        else:
            glens = np.stack([np.frombuffer(i.index, dtype="<u2")
                              .astype(np.int32) for i in infos])
            kern = _batch_decode_kernel(n, nblocks, nb, h, w, order,
                                        tuple(i0.cband), i0.mode != Mode.FTL,
                                        np.dtype(uns_dt).name, flat.size,
                                        tw32, _indexed_nreg(glens, tb))
            out = kern(dwp, jnp.asarray(glens.reshape(-1)))
        _to_host_async([out])
        if pending is not None:
            po, pdt = pending
            yield np.asarray(po).view(pdt)
        pending = (out, np_dt)
    if pending is not None:
        po, pdt = pending
        yield np.asarray(po).view(pdt)
