"""Public encoder/decoder API, mirroring the reference C API surface
(QB3.h:88-162) with a Pythonic face.

    enc = Encoder(width, height, bands, DType.U8)
    enc.set_mode(Mode.FTL)
    stream = enc.encode(img)          # bytes, bit-exact QB3 v2

    info, img = decode(stream)        # full decode

The heavy lifting runs as jitted JAX kernels (ops/encode.py, ops/bitpack.py);
this module is the host-side orchestration: validation, quantization, small
image repacking, container framing, RLE0 post-pass and fallbacks, mirroring
qb3_encode (QB3encode.cpp:488-574).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import container, rle
from .errors import QB3DataError, QB3Error, QB3HeaderError, QB3ShapeError
from .constants import (
    B,
    B2,
    HILBERT,
    QB3_MAXBANDS,
    TYPESIZES,
    ZCURVE,
    DType,
    Error,
    Mode,
    is_best_mode,
    is_fast_mode,
    mode_uses_zcurve,
    needs_rle,
)

NP_FROM_DT = {
    DType.U8: np.uint8, DType.I8: np.int8, DType.U16: np.uint16, DType.I16: np.int16,
    DType.U32: np.uint32, DType.I32: np.int32, DType.U64: np.uint64, DType.I64: np.int64,
}
DT_FROM_NP = {np.dtype(v): k for k, v in NP_FROM_DT.items()}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def default_cband(nbands: int) -> list[int]:
    """RGB(A) default: R-G, G, B-G (QB3encode.cpp:40-45)."""
    cband = list(range(nbands))
    if nbands in (3, 4):
        cband[0] = cband[2] = 1
    return cband


def normalize_cband(nbands: int, cband) -> list[int]:
    """Clamp invalid entries and force core bands independent
    (QB3encode.cpp:63-77)."""
    cb = [cband[i] if cband[i] < nbands else i for i in range(nbands)]
    for i in range(nbands):
        if cb[i] != i:
            cb[cb[i]] = cb[i]
    return cb


def max_encoded_size(xsize: int, ysize: int, nbands: int, dtype: int) -> int:
    """Worst-case output bytes (QB3encode.cpp:112-118)."""
    n = 16 * ((xsize + 3) // 4) * ((ysize + 3) // 4) * nbands
    bits_per_value = 17.0 / 16.0 + 8 * TYPESIZES[dtype]
    return 1024 + int(bits_per_value * n / 8)


# ---------------------------------------------------------------- quantization

def _tdiv(n, d):
    """C-style truncating integer division (toward zero)."""
    q = n // d
    return q + ((n % d != 0) & (n < 0))


def _tmod(n, d):
    return n - _tdiv(n, d) * d


def quantize(arr: np.ndarray, q: int, away: bool) -> np.ndarray:
    """In the signed domain, round-to/away-from-zero (QB3encode.cpp:137-186)."""
    v = arr
    d = np.array(q, dtype=arr.dtype)
    if q == 2:
        return (_tdiv(v, d) + _tmod(v, d)).astype(arr.dtype) if away else _tdiv(v, d).astype(arr.dtype)
    if q == 3:
        return (_tdiv(v, d) + _tdiv(_tmod(v, d), np.array(2, arr.dtype))).astype(arr.dtype)
    if q == 4:
        sub = 2 if away else 3
        return (_tdiv(v, d) + _tdiv(_tmod(v, d), np.array(sub, arr.dtype))).astype(arr.dtype)
    m = _tmod(v, d)
    if away:
        h = _tdiv(d, np.array(2, arr.dtype)) + _tmod(d, np.array(2, arr.dtype))
        return (_tdiv(v, d) + (~(v < 0) & (m >= h)) - ((v < 0) & ((m + h) <= 0))).astype(arr.dtype)
    h = _tdiv(d, np.array(2, arr.dtype))
    return (_tdiv(v, d) + (~(v < 0) & (m > h)) - ((v < 0) & ((m + h) < 0))).astype(arr.dtype)


def dequantize(arr: np.ndarray, q: int) -> np.ndarray:
    """Clamped multiply-back (QB3decode.cpp:77-107)."""
    info = np.iinfo(arr.dtype)
    qa = np.array(q, dtype=arr.dtype)
    mai = np.array(info.max // q, dtype=arr.dtype)
    out = np.where(arr <= mai, arr * qa, np.array(info.max, arr.dtype))
    if info.min < 0 and q > 2:
        # trunc(min/q), matching the C division semantics
        mii = np.array(int(info.min) // q + (1 if int(info.min) % q else 0), arr.dtype)
        out = np.where(arr < mii, np.array(info.min, arr.dtype), out)
    return out.astype(arr.dtype)


# -------------------------------------------------------------- small images

def repack_small(img: np.ndarray) -> np.ndarray:
    """Repack an image with a dimension < 4 into a B-aligned layout
    (QB3encode.cpp:351-389)."""
    h, w, nb = img.shape
    ngroups = (h * w + B2 - 1) // B2
    flat = np.zeros((ngroups * B2 * nb,), dtype=img.dtype)
    if w < B:  # narrow and tall: row by row
        data = img.reshape(-1)
        flat[: data.size] = data
        return flat.reshape(ngroups * B, B, nb)
    # short and wide: column by column
    data = img.transpose(1, 0, 2).reshape(-1)
    flat[: data.size] = data
    return flat.reshape(B, ngroups * B, nb)


def unpack_small(img: np.ndarray, h: int, w: int, nb: int) -> np.ndarray:
    """Inverse of repack_small (QB3decode.cpp:337-353)."""
    flat = img.reshape(-1)[: h * w * nb]
    if w < B:
        return flat.reshape(h, w, nb)
    return flat.reshape(w, h, nb).transpose(1, 0, 2)


# ------------------------------------------------------------------- encoder

@functools.lru_cache(maxsize=64)
def _fast_kernel(shape, npdtype, order, cband, skipstep, n_words,
                 maxbits=None):
    """maxbits: optional tighter static bound on the per-group bit length
    (e.g. the max of a known stream's glens, rounded up) — sizes the pack's
    slab width to the data instead of the dtype worst case.  Any value
    >= the stream's true max group length is exact; the default is the
    dtype bound."""
    from .ops.bitpack import group_bits_bound, pack_groups
    from .ops.encode import encode_fast_blocks

    if maxbits is None:
        maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=False)
    def run(img, entry_prev, entry_runbits):
        codes, lens, exit_prev, exit_runbits, rung = encode_fast_blocks(
            img, entry_prev, entry_runbits, order, cband, skipstep,
            with_rungs=True)
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        return words, total, exit_prev, exit_runbits, glen, rung

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _best_kernel(shape, npdtype, order, cband, n_words, maxbits=None):
    from .ops.bitpack import group_bits_bound, pack_groups
    from .ops.encode_best import encode_best_blocks

    if maxbits is None:
        maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=True)

    def run(img, entry_prev, entry_runbits, entry_cf):
        (codes, lens, exit_prev, exit_runbits, exit_cf,
         meta16, cfv, post_run, pcf_in) = encode_best_blocks(
            img, entry_prev, entry_runbits, entry_cf, order, cband)
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        return (words, total, exit_prev, exit_runbits, exit_cf, glen, meta16,
                cfv, post_run, pcf_in)

    return jax.jit(run)


class Encoder:
    """Mirror of the encsp handle (QB3encode.cpp:26-57)."""

    def __init__(self, width: int, height: int, bands: int, dtype: DType):
        # band cap: the reference encoder stops at 16 (QB3.h:34); this
        # engine accepts the container's full 256 range (constants.py
        # QB3_MAXBANDS_EXT) — streams with >16 bands are an extension the
        # reference decoder will refuse (REFERENCE_BUGS.md documents the
        # boundary)
        from .constants import QB3_MAXBANDS_EXT

        if not (0 < width <= 0x10000 and 0 < height <= 0x10000
                and 0 < bands <= QB3_MAXBANDS_EXT and 0 <= dtype <= DType.I64):
            raise ValueError("invalid encoder parameters")
        self.xsize = width
        self.ysize = height
        self.nbands = bands
        self.dtype = DType(dtype)
        self.quanta = 1
        self.away = False
        self.mode = Mode.FTL
        self.order = 0
        self.stride = 0
        self.cband = default_cband(bands)
        self.error = Error.OK
        # decode-sidecar chunk selection: False, True/"ix" (per-group bit
        # lengths; "ib" for best modes), or "ic" (chunked anchors, ~1%)
        self.with_index = False
        self.index_chunk_blocks = 0  # 0 = IC_DEFAULT_K
        self._last_glens = None
        self._last_rungs = None
        self._last_pcf = None
        self._last_best_meta = None
        self.reset()

    def reset(self):
        """qb3_reset_encoder: clear persisted band state."""
        self.band_prev = np.zeros(self.nbands, dtype=np.uint64)
        self.band_runbits = np.zeros(self.nbands, dtype=np.int32)
        self.band_cf = np.zeros(self.nbands, dtype=np.uint64)
        self.error = Error.OK

    def set_mode(self, mode: int) -> Mode:
        if 0 <= mode < Mode.END:
            self.mode = Mode(mode)
        if mode_uses_zcurve(self.mode):
            self.order = ZCURVE  # sticky, like QB3encode.cpp:120-134
        return self.mode

    def set_quanta(self, q: int, away: bool = False) -> bool:
        if q < 1:
            return False
        self.quanta = int(q)
        self.away = bool(away)
        if q == 1:
            return True
        np_dt = NP_FROM_DT[self.dtype]
        return q <= np.iinfo(np_dt).max

    def set_coreband(self, cband) -> list[int]:
        self.cband = normalize_cband(self.nbands, list(cband))
        return self.cband

    def set_stride(self, stride: int):
        self.stride = stride

    def max_encoded_size(self) -> int:
        return max_encoded_size(self.xsize, self.ysize, self.nbands, self.dtype)

    # ---------------------------------------------------------------- encode

    def _source_view(self, source: np.ndarray) -> np.ndarray:
        """Apply stride and shape checks -> contiguous (H, W, C) array."""
        np_dt = NP_FROM_DT[self.dtype]
        src = np.asarray(source)
        if src.dtype != np.dtype(np_dt):
            raise QB3ShapeError(f"dtype mismatch: {src.dtype} vs {np_dt}")
        if self.stride:
            flat = src.reshape(-1)
            rows = [flat[y * self.stride:(y * self.stride) + self.xsize * self.nbands]
                    for y in range(self.ysize)]
            src = np.stack(rows).reshape(self.ysize, self.xsize, self.nbands)
        else:
            src = src.reshape(self.ysize, self.xsize, self.nbands)
        return np.ascontiguousarray(src)

    def _stored(self, raw: np.ndarray) -> bytes:
        hdr = container.write_headers(
            self.xsize, self.ysize, self.nbands, self.dtype, Mode.STORED,
            self.cband, self.quanta, self.order)
        return hdr + raw.tobytes()

    def encode(self, source: np.ndarray) -> bytes:
        """qb3_encode (QB3encode.cpp:488-574).

        The error state is sticky like the reference handle's
        (qb3_get_encoder_state, QB3encode.cpp:338): a failed encode sets
        `self.error` and further encodes raise until reset()."""
        if self.error != Error.OK:
            raise QB3Error(f"encoder in error state {self.error!r}; reset() first")
        try:
            return self._encode(source)
        except QB3Error:
            self.error = Error.EINV
            raise

    def _encode(self, source: np.ndarray) -> bytes:
        src = self._source_view(source)
        raw_size = src.nbytes
        if self.xsize * self.ysize <= B2:
            return self._stored(src)

        user_mode = self.mode
        mode = user_mode
        if needs_rle(mode):
            mode = {Mode.RLE: Mode.BASE_Z, Mode.CF_RLE: Mode.CF,
                    Mode.RLE_H: Mode.BASE_H, Mode.CF_RLE_H: Mode.CF_H}[mode]

        work = src
        if self.quanta >= 2:
            work = quantize(work, self.quanta, self.away)
        uns = work.view(UNSIGNED[work.dtype.itemsize])

        if self.xsize < B or self.ysize < B:
            uns = repack_small(uns)

        entry_runbits = self.band_runbits.copy()
        entry_cf = self.band_cf.copy()
        payload, state = self._encode_payload(uns, mode)
        index, index_sig = None, b"ix"
        if self.with_index:
            if is_best_mode(mode):
                if self.with_index == "ic":
                    index, index_sig = \
                        self._chunked_sidecar_best(entry_runbits,
                                                   entry_cf), b"ic"
                if index is None:
                    index, index_sig = self._best_sidecar(), b"ib"
            elif self.with_index == "ic":
                index, index_sig = self._chunked_sidecar(entry_runbits), b"ic"
            else:
                index = self._last_glens.astype("<u2").tobytes()
        header = container.write_headers(
            self.xsize, self.ysize, self.nbands, self.dtype, mode,
            self.cband, self.quanta, self.order, index, index_sig)
        result = header + payload

        if needs_rle(user_mode):
            # RLE post-pass: only if reasonable and it shrinks (QB3encode.cpp:536-566)
            if len(result) <= self.max_encoded_size() // 2:
                packed = rle.rle0_encode(payload)
                if len(packed) < len(payload) and \
                        len(packed) <= self.max_encoded_size() - len(result):
                    header2 = container.write_headers(
                        self.xsize, self.ysize, self.nbands, self.dtype, user_mode,
                        self.cband, self.quanta, self.order, index, index_sig)
                    self._commit_state(state)
                    return header2 + packed
            self._commit_state(state)
            return result

        if raw_size > len(result):
            self._commit_state(state)
            return result
        return self._stored(src)

    def _encode_payload(self, uns: np.ndarray, mode: Mode):
        h, w, nb = uns.shape
        order = self.order or HILBERT
        n_words = (max_encoded_size(w, h, nb, self.dtype) + 3) // 4 + 2
        if is_fast_mode(mode):
            kern = _fast_kernel((h, w, nb), uns.dtype.name, order,
                                tuple(self.cband), mode == Mode.FTL, n_words)
            words, total, xprev, xrun, glen, rung = kern(
                jnp.asarray(uns),
                jnp.asarray(self.band_prev.astype(uns.dtype)),
                jnp.asarray(self.band_runbits))
            state = (np.asarray(xprev), np.asarray(xrun), None)
            self._last_rungs = np.asarray(rung)
        elif is_best_mode(mode):
            kern = _best_kernel((h, w, nb), uns.dtype.name, order,
                                tuple(self.cband), n_words)
            (words, total, xprev, xrun, xcf, glen, meta16, cfv,
             post_run, pcf_in) = kern(
                jnp.asarray(uns),
                jnp.asarray(self.band_prev.astype(uns.dtype)),
                jnp.asarray(self.band_runbits),
                jnp.asarray(self.band_cf.astype(uns.dtype)))
            state = (np.asarray(xprev), np.asarray(xrun), np.asarray(xcf))
            self._last_best_meta = (np.asarray(meta16), np.asarray(cfv))
            self._last_rungs = np.asarray(post_run)
            self._last_pcf = np.asarray(pcf_in)
        else:
            raise ValueError(f"unsupported mode {mode}")
        from .ops.bitpack import words_to_bytes
        self._last_glens = np.asarray(glen)
        return words_to_bytes(np.asarray(words), int(total)), state

    def _best_sidecar(self) -> bytes | None:
        """"ib" chunk payload: per-group u16 glen, u16 meta
        (kind | vrung << 3 | prefix_len << 9), then u16 biased CF (cf-2) for
        CF/CF0 groups only, all little-endian in group order.  None when a CF
        exceeds 16 bits (decoder falls back to the serial walk)."""
        from .offsets import KIND_CF, KIND_CF0

        meta16, cfv = self._last_best_meta
        kind = meta16 & 7
        cfm = cfv[(kind == KIND_CF) | (kind == KIND_CF0)].astype(np.uint64)
        if cfm.size and int(cfm.max()) > 0xFFFF:
            return None
        return (self._last_glens.astype("<u2").tobytes()
                + meta16.astype("<u2").tobytes()
                + cfm.astype("<u2").tobytes())

    def _chunked_sidecar(self, entry_runbits: np.ndarray) -> bytes | None:
        """"ic" chunk payload: per-chunk bit spans + entry rung state
        (decode_chunked.py docstring has the format)."""
        from .ops.decode_chunked import IC_DEFAULT_K, chunk_spans, pack_ic

        k = self.index_chunk_blocks or IC_DEFAULT_K
        spans, entry = chunk_spans(self._last_glens.astype(np.int64),
                                   self._last_rungs, entry_runbits, k)
        if int(spans.sum()) >= 1 << 31:
            return None  # int32 bit cursors in the device walk
        return pack_ic(spans, entry, k)

    def _chunked_sidecar_best(self, entry_runbits: np.ndarray,
                              entry_cf: np.ndarray) -> bytes | None:
        """"ic" chunk payload for best-mode streams: spans + entry rungs +
        entry pcf per band (decode_chunked.pack_ic_best).  None when a CF
        exceeds 16 bits or the stream is too long for int32 cursors."""
        from .ops.decode_chunked import (IC_DEFAULT_K, chunk_spans_best,
                                         pack_ic_best)

        k = self.index_chunk_blocks or IC_DEFAULT_K
        nb = self.nbands
        pieces = chunk_spans_best(
            self._last_glens.astype(np.int64),
            self._last_rungs.reshape(-1, nb),
            self._last_pcf.reshape(-1, nb).astype(np.int64),
            entry_runbits, entry_cf.astype(np.int64), k)
        if pieces is None:
            return None
        spans, entry, pcf = pieces
        if int(spans.sum()) >= 1 << 31:
            return None
        return pack_ic_best(spans, entry, pcf, k)

    def _commit_state(self, state):
        xprev, xrun, xcf = state
        self.band_prev = xprev.astype(np.uint64)
        self.band_runbits = xrun.astype(np.int32)
        if xcf is not None:
            self.band_cf = xcf.astype(np.uint64)


def _parse_best_sidecar(buf: bytes, ngroups: int):
    """Inverse of Encoder._best_sidecar -> (kind, val_pos, vrung, cf) flat
    arrays for _decode_kernel, or None if the sidecar is inconsistent."""
    from .offsets import KIND_CF, KIND_CF0

    arr = np.frombuffer(buf, dtype="<u2")
    if arr.size < 2 * ngroups:
        return None
    glens = arr[:ngroups].astype(np.int64)
    meta = arr[ngroups : 2 * ngroups].astype(np.int32)
    kind = (meta & 7).astype(np.uint8)
    vrung = (meta >> 3) & 63
    prefix = (meta >> 9) & 127
    iscf = (kind == KIND_CF) | (kind == KIND_CF0)
    if arr.size != 2 * ngroups + int(iscf.sum()):
        return None
    cf = np.zeros(ngroups, np.uint64)
    cf[iscf] = arr[2 * ngroups :].astype(np.uint64) + 2
    ends = np.cumsum(glens)
    val_pos = ends - glens + prefix
    return kind, val_pos, vrung.astype(np.int32), cf


# ------------------------------------------------------------------- decoder

def _indexed_nreg(glens: np.ndarray, tbits: int) -> int:
    """Register-window word count from the stream's ACTUAL max group span
    (the format-worst count, 36 words for u64, lengthens every select
    chain; bucketed to limit recompiles)."""
    from .ops.decode import _NREG_IX

    if glens.size == 0:
        return _NREG_IX[tbits]
    need = (31 + int(glens.max()) + 1 + 31) // 32 + 1
    return min(_NREG_IX[tbits], max(4, -(-need // 4) * 4))


@functools.lru_cache(maxsize=64)
def _decode_kernel_indexed(nblocks, nbands, h, w, order, cband, apply_step,
                           npdtype, n_words, nreg=None):
    from .constants import ubits_for
    from .ops.decode import reconstruct

    out_dtype = np.dtype(npdtype)
    ubits = ubits_for(out_dtype.itemsize)
    tbits = out_dtype.itemsize * 8

    def run(words64, glens, entry_prev):
        from .ops.decode import decode_indexed_narrow
        g = decode_indexed_narrow(words64, glens, nblocks, nbands,
                                  apply_step, tbits, nreg=nreg)
        g = g.reshape(nblocks, nbands, B2)
        img, exit_prev = reconstruct(g, entry_prev, h, w, nbands, order, cband, out_dtype)
        return img, exit_prev

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _decode_kernel_chunked_best(nblocks, nbands, h, w, order, cband,
                                npdtype, n_words, k_blocks):
    from .ops.decode import reconstruct
    from .ops.decode_chunked import decode_chunked_best

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8

    def run(words64, starts, entry_rungs, entry_pcf, entry_prev):
        g = decode_chunked_best(words64, starts, entry_rungs, entry_pcf,
                                k_blocks, nblocks, nbands, tbits)
        g = g.reshape(nblocks, nbands, B2)
        img, exit_prev = reconstruct(g, entry_prev, h, w, nbands, order,
                                     cband, out_dtype)
        return img, exit_prev

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _decode_kernel_chunked(nblocks, nbands, h, w, order, cband, apply_step,
                           npdtype, n_words, k_blocks):
    from .ops.decode import reconstruct
    from .ops.decode_chunked import decode_chunked

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8

    def run(words64, starts, entry_rungs, entry_prev):
        g = decode_chunked(words64, starts, entry_rungs, k_blocks, nblocks,
                           nbands, apply_step, tbits)
        g = g.reshape(nblocks, nbands, B2)
        img, exit_prev = reconstruct(g, entry_prev, h, w, nbands, order,
                                     cband, out_dtype)
        return img, exit_prev

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _decode_kernel(nblocks, nbands, h, w, order, cband, apply_step, npdtype,
                   n_words):
    from .ops.decode import decode_groups, decode_groups_fused, reconstruct

    out_dtype = np.dtype(npdtype)
    tbits = out_dtype.itemsize * 8

    def run(words64, kind, val_pos, vrung, cf, entry_prev):
        if tbits <= 16:
            g = decode_groups_fused(words64, kind, val_pos, vrung, cf,
                                    apply_step, tbits)
        else:
            g, _ = decode_groups(words64, kind, val_pos, vrung, cf, apply_step)
        g = g.reshape(nblocks, nbands, B2)
        img, exit_prev = reconstruct(g, entry_prev, h, w, nbands, order, cband, out_dtype)
        return img, exit_prev

    return jax.jit(run)


class Decoder:
    """Mirror of the 3-stage decsp reader (QB3decode.cpp:130-264).

    After read_data: `decode_path` records which decode engine ran
    ("stored", "ic", "ix", "ib", "native-walk", "python-walk") so callers
    can observe sidecar fallbacks; `failed` mirrors the reference's decode
    failure flag when read_data(partial=True) returned best-effort output.
    """

    def __init__(self, stream: bytes):
        self.stream = stream
        self.info = container.parse_headers(stream)  # read_start + read_info
        self.stride = 0
        self.failed = False
        self.decode_path = None

    @property
    def image_size(self):
        return self.info.xsize, self.info.ysize, self.info.nbands

    def decoded_size(self) -> int:
        i = self.info
        return i.xsize * i.ysize * i.nbands * TYPESIZES[i.dtype]

    def set_stride(self, stride: int):
        self.stride = stride

    def read_data(self, partial: bool = False) -> np.ndarray:
        """qb3_read_data -> (H, W, C) array in the stream's dtype.

        On payload corruption, raises QB3DataError by default; with
        partial=True it instead sets `self.failed` and returns the
        best-effort output, mirroring the reference's qb3_read_data (returns
        0 but leaves partial data in the destination, QB3decode.h:713-716).
        """
        info = self.info
        np_dt = NP_FROM_DT[DType(info.dtype)]
        uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
        data = self.stream[info.data_offset:]
        h, w, nb = info.ysize, info.xsize, info.nbands

        if info.mode == Mode.STORED:
            self.decode_path = "stored"
            if len(data) != self.decoded_size():
                raise QB3DataError("stored payload size mismatch")
            out = np.frombuffer(data, dtype=np_dt).reshape(h, w, nb).copy()
            return self._finish(out)

        if h * w < B2:
            raise QB3HeaderError("tiny images must be stored")

        if needs_rle(info.mode):
            expected = rle.rle0_decoded_size(data)
            if expected > self.decoded_size():
                # malicious-input guard (QB3decode.cpp:399-404)
                raise QB3DataError("RLE expansion exceeds image size")
            data = rle.rle0_decode(data, expected)

        dh, dw = h, w
        if w < B or h < B:
            ngroups = (h * w + B2 - 1) // B2
            dw, dh = (B, ngroups * B) if w < B else (ngroups * B, B)

        try:
            uns = self._decode_core(data, dh, dw, nb, uns_dt)
        except QB3DataError as e:
            if not partial or e.partial is None:
                raise
            self.failed = True
            uns = e.partial
        if (dh, dw) != (h, w):
            uns = unpack_small(uns, h, w, nb)
        out = uns.view(np_dt)
        if info.quanta > 1:
            out = dequantize(out, info.quanta)
        return self._finish(out)

    def _decode_core(self, data: bytes, h: int, w: int, nb: int, uns_dt) -> np.ndarray:
        from .offsets import parse_offsets
        from .ops.decode import payload_words

        info = self.info
        order = info.order or HILBERT
        nby = (h + B - 1) // B
        nbx = (w + B - 1) // B
        nblocks = nby * nbx
        words = payload_words(data)
        n_words = 1 << max(4, int(np.ceil(np.log2(len(words)))))
        wpad = np.zeros(n_words, np.uint64)
        wpad[: len(words)] = words
        # the kernels read the payload as u32 words (ops/bitutils.words_u32)
        wpad32 = wpad.view(np.uint32)

        if info.index_chunked is not None and is_fast_mode(info.mode):
            from .ops.decode_chunked import parse_ic
            meta = parse_ic(info.index_chunked, nblocks, nb)
            if meta is not None:
                k, starts, entry, total = meta
                kern = _decode_kernel_chunked(
                    nblocks, nb, h, w, order, tuple(info.cband),
                    info.mode != Mode.FTL, np.dtype(uns_dt).name, n_words, k)
                img, _ = kern(jnp.asarray(wpad32),
                              jnp.asarray(starts.astype(np.int32)),
                              jnp.asarray(entry),
                              jnp.zeros(nb, dtype=jnp.uint64))
                self.decode_path = "ic"
                return self._end_check(np.asarray(img), len(data) * 8 - total)

        if info.index_chunked is not None and is_best_mode(info.mode):
            from .ops.decode_chunked import parse_ic_best
            meta = parse_ic_best(info.index_chunked, nblocks, nb)
            if meta is not None:
                k, starts, entry, pcf, total = meta
                kern = _decode_kernel_chunked_best(
                    nblocks, nb, h, w, order, tuple(info.cband),
                    np.dtype(uns_dt).name, n_words, k)
                img, _ = kern(jnp.asarray(wpad32),
                              jnp.asarray(starts.astype(np.int32)),
                              jnp.asarray(entry), jnp.asarray(pcf),
                              jnp.zeros(nb, dtype=jnp.uint64))
                self.decode_path = "ic-best"
                return self._end_check(np.asarray(img),
                                       len(data) * 8 - total)

        glens = None
        if info.index is not None and is_fast_mode(info.mode):
            cand = np.frombuffer(info.index, dtype="<u2")
            if cand.size == nblocks * nb and \
                    int(cand.astype(np.int64).sum()) < 1 << 31:
                glens = cand.astype(np.int32)
        if glens is not None:
            kern = _decode_kernel_indexed(
                nblocks, nb, h, w, order, tuple(info.cband),
                info.mode != Mode.FTL, np.dtype(uns_dt).name, n_words,
                _indexed_nreg(glens, np.dtype(uns_dt).itemsize * 8))
            img, _ = kern(jnp.asarray(wpad32), jnp.asarray(glens),
                          jnp.zeros(nb, dtype=jnp.uint64))
            self.decode_path = "ix"
            return self._end_check(np.asarray(img),
                                   len(data) * 8 - int(glens.sum()))

        if info.index_best is not None and is_best_mode(info.mode):
            meta = _parse_best_sidecar(info.index_best, nblocks * nb)
            if meta is not None:
                kind, val_pos, vrung, cf = meta
                kern = _decode_kernel(nblocks, nb, h, w, order, tuple(info.cband),
                                      True, np.dtype(uns_dt).name, n_words)
                img, _ = kern(jnp.asarray(wpad32), jnp.asarray(kind),
                              jnp.asarray(val_pos), jnp.asarray(vrung),
                              jnp.asarray(cf), jnp.zeros(nb, dtype=jnp.uint64))
                arr = np.frombuffer(info.index_best, dtype="<u2")
                total = int(arr[: nblocks * nb].astype(np.int64).sum())
                self.decode_path = "ib"
                return self._end_check(np.asarray(img), len(data) * 8 - total)

        from . import native
        if native.available():
            meta = native.parse_offsets_native(
                data, nblocks, nb, np.dtype(uns_dt).itemsize,
                info.mode == Mode.FTL)
            self.decode_path = "native-walk"
        else:
            meta = parse_offsets(data, nblocks, nb, np.dtype(uns_dt).itemsize, info.mode)
            self.decode_path = "python-walk"
        kern = _decode_kernel(nblocks, nb, h, w, order, tuple(info.cband),
                              info.mode != Mode.FTL, np.dtype(uns_dt).name,
                              n_words)
        img, _ = kern(
            jnp.asarray(wpad32),
            jnp.asarray(meta["kind"].reshape(-1)),
            jnp.asarray(meta["val_pos"].reshape(-1)),
            jnp.asarray(meta["vrung"].reshape(-1)),
            jnp.asarray(meta["cf"].reshape(-1)),
            jnp.zeros(nb, dtype=jnp.uint64),
        )
        img = np.asarray(img)
        if meta.get("failed"):
            raise QB3DataError(
                f"corrupt stream (group {meta['failed_group']})", partial=img)
        return self._end_check(img, len(data) * 8 - meta["end_pos"])

    def _end_check(self, img: np.ndarray, leftover: int) -> np.ndarray:
        """The reference end-of-stream rule: >7 bits of extra input fail
        (QB3decode.h:411, :744); truncated input decodes as zeros."""
        if leftover > 7:
            raise QB3DataError(f"{leftover} leftover bits", partial=img)
        return img

    def _finish(self, out: np.ndarray) -> np.ndarray:
        if self.stride:
            h, w, nb = out.shape
            buf = np.zeros((h * self.stride,), dtype=out.dtype)
            line = w * nb
            for y in range(h):
                buf[y * self.stride : y * self.stride + line] = out[y].reshape(-1)
            return buf
        return out


def decode(stream: bytes):
    """One-shot decode -> (array (H, W, C), StreamInfo)."""
    dec = Decoder(stream)
    return dec.read_data(), dec.info


def encode(img: np.ndarray, mode: int = Mode.FTL, quanta: int = 1,
           away: bool = False, coreband=None, index: bool = False) -> bytes:
    """One-shot convenience encoder for (H, W[, C]) arrays."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    enc = Encoder(w, h, c, DT_FROM_NP[img.dtype])
    enc.set_mode(mode)
    enc.with_index = index
    if quanta != 1:
        enc.set_quanta(quanta, away)
    if coreband is not None:
        enc.set_coreband(coreband)
    return enc.encode(img)
