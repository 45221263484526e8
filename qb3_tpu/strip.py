"""Streaming strip encoder: bounded-memory encode of arbitrarily tall
images, byte-exact with the whole-image encoder.

The engine's band state (prev value, rung history, previous CF) persists
across kernel calls, exactly like the reference's strip-wise sub-encoding
of quantized images (QB3encode.cpp:405-455, band_state QB3common.h:63-65)
— but surfaced as a public API:

    se = StripEncoder(width, height, bands, DType.U8, mode=Mode.FTL)
    for rows in row_chunks:          # any heights, in order
        se.push(rows)
    stream = se.finish()             # == Encoder(...).encode(whole_image)

Memory is bounded by O(width x strip_rows x bands) regardless of height.
Block rows (4 rows) encode as soon as their rows arrive; sub-streams are
assembled with the vectorized bit stitcher (stitch.py).  The stored-raw
fallback for incompressible images is not available in streaming mode (the
raster is gone by finish()); everything else — quanta, RLE0 post-pass,
core-band mapping, scan order, sidecars — matches Encoder.
"""

from __future__ import annotations

import numpy as np

from . import container, rle
from .api import (NP_FROM_DT, UNSIGNED, Encoder, _best_kernel, _fast_kernel,
                  max_encoded_size)
from .constants import B, HILBERT, B2, DType, Mode, is_best_mode, is_fast_mode, needs_rle
from .errors import QB3DataError, QB3ShapeError
from .stitch import stitch_bytes


class StripEncoder:
    def __init__(self, width: int, height: int, bands: int, dtype: DType,
                 mode: int = Mode.FTL, quanta: int = 1, away: bool = False,
                 coreband=None, strip_rows: int = 64, with_index=False,
                 index_chunk_blocks: int = 0):
        if width < B or height < B:
            raise QB3ShapeError("streaming encode needs width, height >= 4")
        if strip_rows % B:
            raise QB3ShapeError("strip_rows must be a multiple of 4")
        # reuse the Encoder for validation + persistent band state
        self._enc = Encoder(width, height, bands, dtype)
        self._enc.set_mode(mode)
        if quanta != 1 and not self._enc.set_quanta(quanta, away):
            raise QB3ShapeError(f"invalid quanta {quanta}")
        if coreband is not None:
            self._enc.set_coreband(coreband)
        self.mode = self._enc.mode
        self.user_mode = self._enc.mode
        if needs_rle(self.mode):
            self.mode = {Mode.RLE: Mode.BASE_Z, Mode.CF_RLE: Mode.CF,
                         Mode.RLE_H: Mode.BASE_H, Mode.CF_RLE_H: Mode.CF_H}[self.mode]
        self.strip_rows = strip_rows
        self.with_index = with_index
        self.index_chunk_blocks = index_chunk_blocks
        self._np_dt = NP_FROM_DT[self._enc.dtype]
        self._pending = np.zeros((0, width, bands), self._np_dt)
        self._row0 = 0          # absolute row index of _pending[0]
        self._frontier = 0      # next absolute row to encode (B-aligned)
        self._rows_seen = 0
        self._parts = []        # (words u32, nbits) per encoded strip
        self._glens = []
        self._rungs = []
        self._best_meta = []    # (meta16, cfv) per strip, for the "ib" sidecar
        self._done = False

    # ------------------------------------------------------------------ feed

    def push(self, rows: np.ndarray):
        """Append (h, width, bands) rows; encodes completed block rows."""
        e = self._enc
        rows = np.asarray(rows).reshape(-1, e.xsize, e.nbands)
        if rows.dtype != np.dtype(self._np_dt):
            raise QB3ShapeError(f"dtype mismatch: {rows.dtype}")
        if self._rows_seen + rows.shape[0] > e.ysize:
            raise QB3ShapeError("more rows than the declared height")
        self._pending = np.concatenate([self._pending, rows], axis=0)
        self._rows_seen += rows.shape[0]
        self._drain(flush=self._rows_seen == e.ysize)

    def _drain(self, flush: bool = False):
        """Encode aligned strips as their rows become available.

        Without flush, only whole strip_rows chunks encode (stable kernel
        shapes); flush encodes everything up to the last aligned block row.
        """
        e = self._enc
        aligned_end = (e.ysize // B) * B
        while True:
            avail_end = self._row0 + self._pending.shape[0]
            take = min(avail_end, aligned_end) - self._frontier
            if not flush:
                take -= take % self.strip_rows
            if take <= 0:
                break
            i0 = self._frontier - self._row0
            self._encode_strip(self._pending[i0 : i0 + take])
            self._frontier += take
            keep_abs = self._frontier
            if e.ysize % B:  # the shifted tail block row re-reads these rows
                keep_abs = min(keep_abs, e.ysize - B)
            drop = max(0, keep_abs - self._row0)
            self._pending = self._pending[drop:]
            self._row0 += drop

    def _encode_strip(self, strip: np.ndarray):
        from .api import quantize

        e = self._enc
        work = strip
        if e.quanta >= 2:
            work = quantize(work, e.quanta, e.away)
        uns = work.view(UNSIGNED[work.dtype.itemsize])
        h, w, nb = uns.shape
        order = e.order or HILBERT
        n_words = (max_encoded_size(w, h, nb, e.dtype) + 3) // 4 + 2
        if is_fast_mode(self.mode):
            kern = _fast_kernel((h, w, nb), uns.dtype.name, order,
                                tuple(e.cband), self.mode == Mode.FTL, n_words)
            words, total, xp, xr, glen, rung = kern(
                uns, e.band_prev.astype(uns.dtype), e.band_runbits)
            e.band_prev = np.asarray(xp).astype(np.uint64)
            e.band_runbits = np.asarray(xr)
        elif is_best_mode(self.mode):
            kern = _best_kernel((h, w, nb), uns.dtype.name, order,
                                tuple(e.cband), n_words)
            (words, total, xp, xr, xcf, glen, meta16, cfv,
             _post_run, _pcf_in) = kern(
                uns, e.band_prev.astype(uns.dtype), e.band_runbits,
                e.band_cf.astype(uns.dtype))
            e.band_prev = np.asarray(xp).astype(np.uint64)
            e.band_runbits = np.asarray(xr)
            e.band_cf = np.asarray(xcf).astype(np.uint64)
            if self.with_index:
                self._best_meta.append((np.asarray(meta16), np.asarray(cfv)))
            rung = None
        else:
            raise QB3ShapeError(f"unsupported streaming mode {self.mode}")
        self._parts.append((np.asarray(words), int(total)))
        if self.with_index:
            self._glens.append(np.asarray(glen))
            if rung is not None:
                self._rungs.append(np.asarray(rung))

    # ---------------------------------------------------------------- finish

    def finish(self) -> bytes:
        e = self._enc
        if self._done:
            raise QB3ShapeError("finish() called twice")
        if self._rows_seen != e.ysize:
            raise QB3ShapeError(
                f"got {self._rows_seen} rows, declared {e.ysize}")
        self._drain(flush=True)
        if e.ysize % B:  # final shifted block row (QB3encode.h:409-416)
            i0 = (e.ysize - B) - self._row0
            self._encode_strip(self._pending[i0 : i0 + B])
        self._done = True
        payload = stitch_bytes(self._parts)

        index, index_sig = None, b"ix"
        if self.with_index and self._glens:
            glens = np.concatenate([g.reshape(-1) for g in self._glens])
            if self.with_index == "ic" and self._rungs:
                from .ops.decode_chunked import IC_DEFAULT_K, chunk_spans, pack_ic

                rungs = np.concatenate(self._rungs, axis=0)
                k = self.index_chunk_blocks or IC_DEFAULT_K
                spans, entry = chunk_spans(glens.astype(np.int64), rungs,
                                           np.zeros(e.nbands, np.int32), k)
                if int(spans.sum()) < 1 << 31:
                    index, index_sig = pack_ic(spans, entry, k), b"ic"
            elif is_best_mode(self.mode) and self._best_meta:
                # same "ib" payload as Encoder._best_sidecar (api.py),
                # assembled from the per-strip meta/cf streams
                from .offsets import KIND_CF, KIND_CF0

                meta16 = np.concatenate([m for m, _ in self._best_meta])
                cfv = np.concatenate([c for _, c in self._best_meta])
                kind = meta16 & 7
                cfm = cfv[(kind == KIND_CF) | (kind == KIND_CF0)].astype(np.uint64)
                if not (cfm.size and int(cfm.max()) > 0xFFFF):
                    index, index_sig = (glens.astype("<u2").tobytes()
                                        + meta16.astype("<u2").tobytes()
                                        + cfm.astype("<u2").tobytes()), b"ib"
            else:
                index = glens.astype("<u2").tobytes()
        header = container.write_headers(
            e.xsize, e.ysize, e.nbands, e.dtype, self.mode, e.cband,
            e.quanta, e.order, index, index_sig)
        result = header + payload
        if needs_rle(self.user_mode):
            if len(result) <= e.max_encoded_size() // 2:
                packed = rle.rle0_encode(payload)
                if len(packed) < len(payload) and \
                        len(packed) <= e.max_encoded_size() - len(result):
                    header = container.write_headers(
                        e.xsize, e.ysize, e.nbands, e.dtype, self.user_mode,
                        e.cband, e.quanta, e.order, index, index_sig)
                    return header + packed
        return result


class StripDecoder:
    """Bounded-memory streaming decode — the read-side mirror of
    StripEncoder (no reference equivalent: QB3decode.cpp decodes whole
    images).  The stream is walked strip-by-strip with carried band state
    (bit cursor, per-band rung history, previous CF, running prev values);
    memory is O(width x strip_rows x bands) plus the compressed payload.

        sd = StripDecoder(stream)
        while (rows := sd.read(64)) is not None:
            consume(rows)        # rows arrive in order, dequantized
    """

    def __init__(self, stream: bytes, strip_rows: int = 64):
        import jax.numpy as jnp

        from .ops.decode import payload_words

        if strip_rows % B:
            raise QB3ShapeError("strip_rows must be a multiple of 4")
        self.info = info = container.parse_headers(stream)
        self.strip_rows = strip_rows
        self._np_dt = NP_FROM_DT[DType(info.dtype)]
        self._uns_dt = UNSIGNED[np.dtype(self._np_dt).itemsize]
        h, w = info.ysize, info.xsize
        self._whole = None
        if w < B or h < B or info.mode == Mode.STORED:
            from .api import Decoder  # tiny/stored: nothing to stream

            self._whole = Decoder(stream).read_data()
            self._row = 0
            return
        data = stream[info.data_offset:]
        if needs_rle(info.mode):
            expected = rle.rle0_decoded_size(data)
            if expected > h * w * info.nbands * np.dtype(self._np_dt).itemsize:
                raise QB3DataError("RLE expansion exceeds image size")
            data = rle.rle0_decode(data, expected)
        self._data = data
        words = payload_words(data)
        nw = 1 << max(4, int(np.ceil(np.log2(len(words)))))
        wpad = np.zeros(nw, np.uint64)
        wpad[: len(words)] = words
        self._dwords = jnp.asarray(wpad.view(np.uint32))
        self._n_words = nw
        # carried band state
        nb = info.nbands
        self._bit = 0
        self._runbits = np.zeros(nb, np.int32)
        self._pcf = np.zeros(nb, np.uint64)
        self._prev = np.zeros(nb, np.uint64)
        self._row = 0
        self._pending = np.zeros((0, w, nb), self._np_dt)

    def read(self, n_rows: int | None = None):
        """Next <= n_rows rows (default strip_rows), or None at the end."""
        h = self.info.ysize
        want = min(n_rows or self.strip_rows, h - self._row)
        if want <= 0:
            return None
        if self._whole is not None:
            out = self._whole[self._row : self._row + want]
            self._row += want
            return out
        while self._pending.shape[0] < want and self._decoded_until() < h:
            self._decode_next_strip()
        out = self._pending[:want]
        self._pending = self._pending[want:]
        self._row += out.shape[0]
        return out if out.shape[0] else None

    def _decoded_until(self) -> int:
        return self._row + self._pending.shape[0]

    def _decode_next_strip(self):
        import jax.numpy as jnp

        from . import native
        from .api import _decode_kernel, dequantize
        from .offsets import parse_offsets

        info = self.info
        h, w, nb = info.ysize, info.xsize, info.nbands
        aligned_end = (h // B) * B
        # the shifted tail block row (h % B != 0) overwrites rows
        # [h-B, aligned_end): regular strips emit only rows < h-B, the tail
        # strip emits all of [h-B, h) — matching "later blocks win"
        tail_start = h - B if h % B else h
        at = self._decoded_until()
        if at < tail_start:
            hs = min(self.strip_rows, aligned_end - at)
            emit_count = min(hs, tail_start - at)
            last = at + hs >= h
        else:  # tail
            hs = B
            emit_count = B
            last = True
        nblocks = (hs // B) * (w // B)
        tsize = np.dtype(self._uns_dt).itemsize
        if native.available():
            meta = native.parse_offsets_native(
                self._data, nblocks, nb, tsize, info.mode == Mode.FTL,
                self._runbits, self._pcf, self._bit)
        else:
            meta = parse_offsets(self._data, nblocks, nb, tsize, info.mode,
                                 self._runbits, self._pcf, self._bit)
        img = None
        kern = _decode_kernel(nblocks, nb, hs, w, info.order or HILBERT,
                              tuple(info.cband), info.mode != Mode.FTL,
                              np.dtype(self._uns_dt).name, self._n_words)
        img, exit_prev = kern(
            self._dwords,
            jnp.asarray(meta["kind"].reshape(-1)),
            jnp.asarray(meta["val_pos"].reshape(-1)),
            jnp.asarray(meta["vrung"].reshape(-1)),
            jnp.asarray(meta["cf"].reshape(-1)),
            jnp.asarray(self._prev))
        img = np.asarray(img)
        if meta.get("failed"):
            raise QB3DataError(f"corrupt stream (group {meta['failed_group']})",
                               partial=img)
        # advance carried state
        self._bit = meta["end_pos"]
        self._runbits = meta["rung"].reshape(nblocks, nb)[-1].astype(np.int32)
        self._prev = np.asarray(exit_prev).astype(np.uint64)
        kinds = meta["kind"].reshape(nblocks, nb)
        cfs = meta["cf"].reshape(nblocks, nb)
        from .offsets import KIND_CF, KIND_CF0
        for c in range(nb):
            iscf = (kinds[:, c] == KIND_CF) | (kinds[:, c] == KIND_CF0)
            if iscf.any():
                self._pcf[c] = cfs[iscf, c][-1] - 2
        # end-of-stream rule on the final strip (QB3decode.h:411)
        if last:
            leftover = len(self._data) * 8 - meta["end_pos"]
            if leftover > 7:
                raise QB3DataError(f"{leftover} leftover bits", partial=img)
        out = img.view(self._np_dt)[:emit_count]
        if info.quanta > 1:
            out = dequantize(out, info.quanta)
        self._pending = np.concatenate([self._pending, out], axis=0)
