"""Device identification and timing helpers for the measuring scripts.

JAX dispatches asynchronously, so a timing that does not end in
``jax.block_until_ready`` measures the enqueue, not the work.  The timing
helpers queue ``iters`` calls (device pipelining stays on) and block once
on the last result.  A measurement names the card it ran on and refuses to
run on anything but a GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, from a
    child process that stays off JAX; exits the program without a card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        sys.exit(f"no NVIDIA GPU: nvidia-smi did not run ({e})")
    if r.returncode != 0 or not r.stdout.strip():
        sys.exit(f"no NVIDIA GPU: nvidia-smi failed ({r.stderr.strip()})")
    return r.stdout.strip()


def require_gpu(devices) -> None:
    """Exit non-zero unless JAX's devices are GPUs: never fall back."""
    if not devices or devices[0].platform != "gpu":
        kinds = sorted({d.platform for d in devices})
        sys.exit(f"no GPU: JAX found only {kinds} devices")


def device_info() -> dict:
    """{"platform", "kind", "count", "card"} of the GPU this process uses;
    exits the program when there is none."""
    card = card_line()
    import jax

    devices = jax.devices()
    require_gpu(devices)
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices),
            "card": card}


def sustained(fn, iters: int = 20) -> float:
    """Steady seconds/call: one warm-up call (compiles), then ``iters``
    queued calls ended by one ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def sustained_stats(fn, iters: int = 20, windows: int = 3):
    """(mean seconds/call, relative sigma) over ``windows`` timing windows
    of ``iters`` calls each, after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / iters)
    mean = float(np.mean(ts))
    return mean, float(np.std(ts) / mean) if mean else 0.0
