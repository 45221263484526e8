"""Bulk decode of foreign (sidecar-free) QB3 streams at serving rate.

A stream the reference encoder produced carries no sidecar, so recovering
per-group bit offsets is a serial walk (the format's one irreducible serial
dependency, SURVEY 3.3).  One-shot ``qb3_tpu.decode`` pays that walk plus a
full device round trip per image.  This module is the serving path for
bulk tiles:

  * the native walk (native/qb3xs.cpp, a ctypes call that releases the
    GIL) runs THREAD-PARALLEL across streams of a batch;
  * all walked streams decode in ONE device dispatch through the flat
    batched value decoder (batch._batch_best_decode_kernel — the kind/
    val_pos/rung/cf interface covers FTL, BASE and BEST groups alike);
  * batch k+1's walks overlap batch k's device decode + fetch.

Reference bar: QB3decode.h:579 (decode<T>), 354.57 MB/s published /
~170 MB/s on this host single-thread (performance/performance.md:151-155).

Streams with quanta != 1 or STORED payloads fall back to the one-shot
decoder; RLE modes take the native deRLE0 pre-pass in the same worker
threads (QB3decode.cpp:396-413).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import container
from .constants import B, DType, HILBERT, Mode, needs_rle
from .errors import QB3ShapeError


def _walk_one(stream: bytes, info):
    """Host stage for one stream: deRLE + native offset walk."""
    from . import native, rle
    from .ops.decode import payload_words

    h, w, nb = info.ysize, info.xsize, info.nbands
    tsize = (1, 1, 2, 2, 4, 4, 8, 8)[info.dtype]
    payload = stream[info.data_offset:]
    if needs_rle(info.mode):
        payload = rle.rle0_decode(payload, rle.rle0_decoded_size(payload))
    nblocks = (h // B) * (w // B)
    is_ftl = info.mode == Mode.FTL
    meta = native.parse_offsets_native(payload, nblocks, nb, tsize, is_ftl)
    if meta["failed"]:
        raise QB3ShapeError(f"corrupt stream (group {meta['failed_group']})")
    return payload_words(payload), meta


def decode_streams(streams: list[bytes], workers: int | None = None):
    """Decode a batch of same-shape sidecar-free streams -> (N, H, W, C).

    The walk runs across ``workers`` threads (default: CPU count); values
    decode on device in one dispatch.
    """
    import jax
    import jax.numpy as jnp

    from .api import NP_FROM_DT, UNSIGNED
    from .batch import _batch_best_decode_kernel, _flat_tile_layout

    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
           (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode) for i in infos):
        raise QB3ShapeError("bulk foreign decode requires same-shape streams")
    if i0.quanta != 1 or i0.mode == Mode.STORED:
        raise QB3ShapeError("quantized/stored streams: use qb3_tpu.decode")
    h, w, nb = i0.ysize, i0.xsize, i0.nbands
    if h % B or w % B:
        raise QB3ShapeError("bulk foreign decode requires 4-aligned tiles")
    np_dt = NP_FROM_DT[DType(i0.dtype)]
    uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
    nblocks = (h // B) * (w // B)
    order = i0.order or HILBERT
    n = len(streams)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        walked = list(ex.map(_walk_one, streams, infos))

    wlists = [wv for wv, _ in walked]
    flat, tile_words32 = _flat_tile_layout(wlists)
    if flat.size * 64 >= 1 << 31:
        raise QB3ShapeError("batch exceeds the 2^31-bit flat-decode limit")
    tbase = (np.arange(n, dtype=np.int64) * tile_words32 * 32)[:, None]
    kind = np.stack([m["kind"].reshape(-1) for _, m in walked]).reshape(-1)
    val_pos = (np.stack([m["val_pos"].reshape(-1) for _, m in walked])
               + tbase).reshape(-1)
    vrung = np.stack([m["vrung"].reshape(-1) for _, m in walked]).reshape(-1)
    cf = np.stack([m["cf"].reshape(-1) for _, m in walked]).reshape(-1)
    kern = _batch_best_decode_kernel(n, nblocks, nb, h, w, order,
                                     tuple(i0.cband),
                                     np.dtype(uns_dt).name, flat.size,
                                     apply_step=i0.mode != Mode.FTL)
    out = kern(jnp.asarray(flat.reshape(-1).view(np.uint32)), jnp.asarray(kind),
               jnp.asarray(val_pos), jnp.asarray(vrung), jnp.asarray(cf))
    return out, np_dt


def decode_streams_pipelined(stream_batches, workers: int | None = None):
    """Decode an iterable of LISTS of same-shape foreign streams -> yields
    one (N, H, W, C) array per list.

    Software pipeline: batch k+1's thread-parallel walks and upload overlap
    batch k's device decode and fetch (same shape as pipeline.py).
    """
    import numpy as _np

    pending = None
    for streams in stream_batches:
        out, np_dt = decode_streams(streams, workers)
        try:
            out.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        if pending is not None:
            po, pdt = pending
            yield _np.asarray(po).view(pdt)
        pending = (out, np_dt)
    if pending is not None:
        po, pdt = pending
        yield _np.asarray(po).view(pdt)
