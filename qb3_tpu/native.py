"""ctypes bindings for the native helper (native/qb3xs.cpp).

The helper covers the two host-side serial pieces of the codec: the stream
offset walk that feeds the parallel device decoder, and the RLE0 byte
post-pass.  offsets.py / rle.py keep portable Python paths for hosts
without a C++ toolchain.

The library is built for the host that loads it: the first use in a
process runs ``make -C native``, which does nothing when the library is
current and rebuilds it when the sources, the CPU or the compiler changed.
A failed build is reported as a warning with the compiler's output, and the
portable paths take over.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import functools
import os
import subprocess
import warnings

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_DIR, "libqb3xs.so")


def _build() -> bool:
    """make -C native, serialized across processes by a file lock."""
    try:
        with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            r = subprocess.run(["make", "-C", _DIR, "-s"], capture_output=True,
                               text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"native helper build did not run: {e}")
        return False
    if r.returncode != 0:
        warnings.warn("native helper build failed (make -C native):\n"
                      + r.stdout + r.stderr)
        return False
    return True


@functools.lru_cache(maxsize=1)
def _lib():
    """The loaded library, built first if needed; None if unavailable."""
    if not _build():
        return None
    try:
        lib = ct.CDLL(os.path.abspath(_LIB_PATH))
    except OSError as e:
        warnings.warn(f"native helper did not load: {e}")
        return None
    lib.qb3xs_parse.restype = ct.c_int64
    lib.qb3xs_parse.argtypes = [
        ct.c_void_p, ct.c_size_t, ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_int64]
    lib.qb3xs_rle0_encode.restype = ct.c_int64
    lib.qb3xs_rle0_encode.argtypes = [ct.c_void_p, ct.c_int64, ct.c_void_p]
    lib.qb3xs_rle0_decode.restype = ct.c_int64
    lib.qb3xs_rle0_decode.argtypes = [ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64]
    lib.qb3xs_rle0_size.restype = ct.c_int64
    lib.qb3xs_rle0_size.argtypes = [ct.c_void_p, ct.c_int64]
    return lib


def available() -> bool:
    return _lib() is not None


def parse_offsets_native(payload: bytes, nblocks: int, nbands: int, tsize: int,
                         is_ftl: bool, entry_runbits=None, entry_cf=None,
                         start_bit: int = 0):
    n = nblocks * nbands
    kind = np.zeros(n, np.uint8)
    val_pos = np.zeros(n, np.int64)
    vrung = np.zeros(n, np.int32)
    cf = np.zeros(n, np.uint64)
    rung = np.zeros(n, np.int32)
    buf = np.frombuffer(payload + b"\x00" * 16, np.uint8)  # padded peek window
    erb = np.asarray(entry_runbits, np.int32) if entry_runbits is not None else None
    ecf = np.asarray(entry_cf, np.uint64) if entry_cf is not None else None
    end = _lib().qb3xs_parse(
        buf.ctypes.data, len(payload), nblocks, nbands, tsize, int(is_ftl),
        erb.ctypes.data if erb is not None else None,
        ecf.ctypes.data if ecf is not None else None,
        kind.ctypes.data, val_pos.ctypes.data, vrung.ctypes.data,
        cf.ctypes.data, rung.ctypes.data, start_bit)
    failed = end < 0  # -(failed_group + 1); remaining kinds already zeroed
    shape = (nblocks, nbands)
    return dict(kind=kind.reshape(shape), val_pos=val_pos.reshape(shape),
                vrung=vrung.reshape(shape), cf=cf.reshape(shape),
                rung=rung.reshape(shape), end_pos=0 if failed else int(end),
                failed=failed, failed_group=int(-end - 1) if failed else -1)


def rle0_encode(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    # worst case expands 3/2 (every 0xff pair becomes a triple)
    dst = np.zeros(len(data) * 3 // 2 + 16, np.uint8)
    n = _lib().qb3xs_rle0_encode(src.ctypes.data, len(data), dst.ctypes.data)
    return dst[:n].tobytes()


def rle0_decode(data: bytes, expected: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.zeros(expected, np.uint8)
    n = _lib().qb3xs_rle0_decode(src.ctypes.data, len(data), dst.ctypes.data, expected)
    if n < 0:
        raise ValueError("RLE0 length mismatch")
    return dst.tobytes()


def rle0_size(data: bytes) -> int:
    src = np.frombuffer(data, np.uint8)
    return int(_lib().qb3xs_rle0_size(src.ctypes.data, len(data)))
