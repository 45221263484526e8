"""ctypes wrapper around the reference libQB3.so — the conformance oracle.

Used only by the test/bench suite to produce golden streams and to verify
that streams emitted by this engine decode bit-exactly with the original
implementation.  Build the library first:

    cmake -S /root/reference -B /root/repo/.ref_build -G Ninja \
        -DCMAKE_BUILD_TYPE=Release && cmake --build /root/repo/.ref_build
"""

from __future__ import annotations

import ctypes as ct
import os

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", ".ref_build", "QB3lib", "libQB3.so"),
]

NP_FROM_DT = {
    0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
    4: np.uint32, 5: np.int32, 6: np.uint64, 7: np.int64,
}
DT_FROM_NP = {np.dtype(v): k for k, v in NP_FROM_DT.items()}


def _load():
    for p in _LIB_PATHS:
        if os.path.exists(p):
            lib = ct.CDLL(os.path.abspath(p))
            break
    else:
        return None
    lib.qb3_create_encoder.restype = ct.c_void_p
    lib.qb3_create_encoder.argtypes = [ct.c_size_t] * 3 + [ct.c_int]
    lib.qb3_destroy_encoder.argtypes = [ct.c_void_p]
    lib.qb3_reset_encoder.argtypes = [ct.c_void_p]
    lib.qb3_set_encoder_mode.restype = ct.c_int
    lib.qb3_set_encoder_mode.argtypes = [ct.c_void_p, ct.c_int]
    lib.qb3_set_encoder_quanta.restype = ct.c_bool
    lib.qb3_set_encoder_quanta.argtypes = [ct.c_void_p, ct.c_uint64, ct.c_bool]
    lib.qb3_set_encoder_coreband.restype = ct.c_bool
    lib.qb3_set_encoder_coreband.argtypes = [ct.c_void_p, ct.c_size_t, ct.POINTER(ct.c_size_t)]
    lib.qb3_set_encoder_stride.argtypes = [ct.c_void_p, ct.c_size_t]
    lib.qb3_max_encoded_size.restype = ct.c_size_t
    lib.qb3_max_encoded_size.argtypes = [ct.c_void_p]
    lib.qb3_encode.restype = ct.c_size_t
    lib.qb3_encode.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
    lib.qb3_get_encoder_state.restype = ct.c_int
    lib.qb3_get_encoder_state.argtypes = [ct.c_void_p]

    lib.qb3_read_start.restype = ct.c_void_p
    lib.qb3_read_start.argtypes = [ct.c_void_p, ct.c_size_t, ct.POINTER(ct.c_size_t)]
    lib.qb3_read_info.restype = ct.c_bool
    lib.qb3_read_info.argtypes = [ct.c_void_p]
    lib.qb3_read_data.restype = ct.c_size_t
    lib.qb3_read_data.argtypes = [ct.c_void_p, ct.c_void_p]
    lib.qb3_destroy_decoder.argtypes = [ct.c_void_p]
    lib.qb3_decoded_size.restype = ct.c_size_t
    lib.qb3_decoded_size.argtypes = [ct.c_void_p]
    lib.qb3_get_type.restype = ct.c_int
    lib.qb3_get_type.argtypes = [ct.c_void_p]
    lib.qb3_get_mode.restype = ct.c_int
    lib.qb3_get_mode.argtypes = [ct.c_void_p]
    lib.qb3_get_quanta.restype = ct.c_uint64
    lib.qb3_get_quanta.argtypes = [ct.c_void_p]
    lib.qb3_get_order.restype = ct.c_uint64
    lib.qb3_get_order.argtypes = [ct.c_void_p]
    lib.qb3_get_coreband.restype = ct.c_bool
    lib.qb3_get_coreband.argtypes = [ct.c_void_p, ct.POINTER(ct.c_size_t)]
    lib.qb3_set_decoder_stride.argtypes = [ct.c_void_p, ct.c_size_t]
    return lib


LIB = _load()


def available() -> bool:
    return LIB is not None


def ref_encode(
    img: np.ndarray,
    mode: int = 8,
    quanta: int = 1,
    away: bool = False,
    coreband=None,
    stride: int = 0,
) -> bytes:
    """Encode (H, W, C) or (H, W) array with the reference library."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    dt = DT_FROM_NP[img.dtype]
    img = np.ascontiguousarray(img)
    p = LIB.qb3_create_encoder(w, h, c, dt)
    assert p, "qb3_create_encoder failed"
    try:
        got = LIB.qb3_set_encoder_mode(p, mode)
        assert got == mode, f"mode {mode} not accepted (got {got})"
        if quanta != 1:
            assert LIB.qb3_set_encoder_quanta(p, quanta, away)
        if coreband is not None:
            arr = (ct.c_size_t * c)(*coreband)
            assert LIB.qb3_set_encoder_coreband(p, c, arr)
        if stride:
            LIB.qb3_set_encoder_stride(p, stride)
        dst = ct.create_string_buffer(LIB.qb3_max_encoded_size(p))
        # the reference may quantize in place; pass a copy
        src = np.copy(img)
        n = LIB.qb3_encode(p, src.ctypes.data_as(ct.c_void_p), dst)
        assert n > 0 and LIB.qb3_get_encoder_state(p) == 0, "reference encode failed"
        return dst.raw[:n]
    finally:
        LIB.qb3_destroy_encoder(p)


def ref_decode(stream: bytes, stride: int = 0):
    """Decode a QB3 stream with the reference library -> (array, info dict)."""
    buf = ct.create_string_buffer(stream, len(stream))
    sizes = (ct.c_size_t * 3)()
    p = LIB.qb3_read_start(buf, len(stream), sizes)
    assert p, "qb3_read_start failed"
    try:
        assert LIB.qb3_read_info(p), "qb3_read_info failed"
        w, h, c = sizes[0], sizes[1], sizes[2]
        dt = LIB.qb3_get_type(p)
        cband = (ct.c_size_t * c)()
        LIB.qb3_get_coreband(p, cband)
        info = {
            "mode": LIB.qb3_get_mode(p),
            "quanta": LIB.qb3_get_quanta(p),
            "order": LIB.qb3_get_order(p),
            "coreband": list(cband),
            "dtype": dt,
        }
        if stride:
            LIB.qb3_set_decoder_stride(p, stride)
        out = np.zeros((h, w, c), dtype=NP_FROM_DT[dt])
        n = LIB.qb3_read_data(p, out.ctypes.data_as(ct.c_void_p))
        assert n == out.nbytes, f"qb3_read_data returned {n}, expected {out.nbytes}"
        return out, info
    finally:
        LIB.qb3_destroy_decoder(p)
