"""Capture a jax.profiler trace of the FTL encode and ix decode kernels
(512x512x3 u8) on the GPU and summarize time per trace event (no
TensorBoard needed).  Prints the device and the trace directory; needs a
GPU.

    python tools/trace_bench.py
"""

import glob
import gzip
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from qb3_tpu.benchutil import device_info

    print("device:", json.dumps(device_info()), flush=True)
    import jax
    import jax.numpy as jnp

    import qb3_tpu
    from qb3_tpu import container
    from qb3_tpu.api import _decode_kernel_indexed, _fast_kernel, max_encoded_size
    from qb3_tpu.constants import HILBERT
    from qb3_tpu.ops.decode import payload_words
    from bench import natural_image

    h, w, nb = 512, 512, 3
    img = natural_image(h, w, nb)

    n_words = (max_encoded_size(w, h, nb, 0) + 3) // 4 + 2
    ek = _fast_kernel((h, w, nb), "uint8", HILBERT, (1, 1, 1), True, n_words)
    dimg = jax.device_put(jnp.asarray(img))
    p0 = jnp.zeros(nb, jnp.uint8)
    r0 = jnp.zeros(nb, jnp.int32)
    jax.block_until_ready(ek(dimg, p0, r0))

    stream = qb3_tpu.encode(img, mode=qb3_tpu.Mode.FTL, index=True)
    info = container.parse_headers(stream)
    payload = stream[info.data_offset:]
    wordsv = payload_words(payload)
    nw = 1 << max(4, int(np.ceil(np.log2(len(wordsv)))))
    wpad = np.zeros(nw, np.uint64)
    wpad[: len(wordsv)] = wordsv
    glens = np.frombuffer(info.index, dtype="<u2").astype(np.int32)
    nblocks = (h // 4) * (w // 4)
    dk = _decode_kernel_indexed(nblocks, nb, h, w, HILBERT, tuple(info.cband),
                                False, "uint8", nw)
    dwords = jax.device_put(jnp.asarray(wpad))
    dglens = jax.device_put(jnp.asarray(glens))
    zprev = jnp.zeros(nb, dtype=jnp.uint64)
    jax.block_until_ready(dk(dwords, dglens, zprev))

    tdir = tempfile.mkdtemp(prefix="qb3trace-")
    with jax.profiler.trace(tdir):
        for _ in range(3):
            jax.block_until_ready(ek(dimg, p0, r0))
        for _ in range(3):
            jax.block_until_ready(dk(dwords, dglens, zprev))
        time.sleep(0.2)

    # parse the trace
    files = glob.glob(f"{tdir}/**/*.trace.json.gz", recursive=True)
    print("trace directory:", tdir)
    print("trace files:", files)
    agg = defaultdict(float)
    cnt = defaultdict(int)
    for f in files:
        with gzip.open(f, "rt") as fh:
            data = json.load(fh)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            pidname = ev.get("pid")
            name = ev.get("name", "")
            dur = ev.get("dur", 0)
            # keep device-side ops only: heuristic on thread/process naming
            # is messy; just aggregate everything and sort by total time
            agg[name] += dur
            cnt[name] += 1
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:60]
    for name, dur in top:
        print(f"{dur/3:12.1f} us  x{cnt[name]:4d}  {name[:140]}")


if __name__ == "__main__":
    main()
