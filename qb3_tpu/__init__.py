"""qb3_tpu — a data-parallel QB3 raster codec engine in JAX.

Bit-exact QB3 v2 streams (see doc/QB3.md of the reference library), produced
and consumed by data-parallel kernels instead of the reference's serial loop.
The package name is historical; the engine runs wherever JAX does, and its
accelerator target is an NVIDIA GPU.
"""

import os as _os

import jax as _jax

# The codec operates on 8..64-bit integers; 64-bit lane support is required.
_jax.config.update("jax_enable_x64", True)

# Kernel graphs are large, so compiled executables persist across processes.
# JAX_COMPILATION_CACHE_DIR, when set, places the cache (JAX reads it
# itself); otherwise it lives at a fixed path in the checkout.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", _os.path.abspath(
        _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .constants import B, B2, HILBERT, ZCURVE, DType, Error, Mode  # noqa: E402,F401
from .errors import (QB3DataError, QB3Error, QB3HeaderError,  # noqa: E402,F401
                     QB3ShapeError)
from .api import Decoder, Encoder, decode, encode, max_encoded_size  # noqa: E402,F401
from .strip import StripDecoder, StripEncoder  # noqa: E402,F401

__version__ = "0.2.0"
