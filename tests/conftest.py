import os

# Tests run on the host platform with a virtual 8-device mesh so that the
# multi-device sharding paths compile and execute without a GPU.  jax.config
# is set as well as the variable, in case jax was imported before this file.
# The GPU is exercised by chip_smoke.py and by the tests marked `gpu`.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
