"""Device time of each codec stage, alone, at the web-map tile size.

    python tools/stage_times.py

Times the plain XLA implementation of every stage on a batch of 512x512x3
u8 tiles (the shape chip_smoke.py's tiles phase serves), each stage jitted
on its own, its inputs already on the device, ended by block_until_ready:

  phase_a      encode_fast_blocks (delta, mag-sign, rungs, symbol codes)
  pack         bitpack.pack_groups (slab fold + one scatter-add)
  ic_walk      decode_chunked, the self-contained "ic" chunk walk
  ix_wave      decode_indexed_narrow, the "ix" sidecar wavefront
  ib_wave      decode_groups_fused, the BEST "ib" sidecar wavefront
  reconstruct  reconstruct_batch (un-delta, inverse curve, band add)

These are the bars a hand-written GPU kernel for a stage has to beat.
Prints one JSON line per stage, then the device; needs a GPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(n: int = 256, seed: int = 0, iters: int = 10):
    from qb3_tpu.benchutil import device_info, sustained

    device = device_info()
    import jax
    import jax.numpy as jnp

    from chip_smoke import natural
    from qb3_tpu import batch, container
    from qb3_tpu.api import _indexed_nreg, _parse_best_sidecar, max_encoded_size
    from qb3_tpu.constants import B2, HILBERT, Mode
    from qb3_tpu.ops.bitpack import group_bits_bound, pack_groups
    from qb3_tpu.ops.decode import (decode_groups_fused, decode_indexed_narrow,
                                    payload_words, reconstruct_batch)
    from qb3_tpu.ops.decode_chunked import decode_chunked, parse_ic
    from qb3_tpu.ops.encode import encode_fast_blocks

    h, w, nb = 512, 512, 3
    cband = (1, 1, 1)
    nblocks = (h // 4) * (w // 4)
    tiles = natural(n, h, w, nb, seed)
    raw = tiles.nbytes

    def report(stage, fn, *xs):
        t = sustained(lambda: fn(*xs), iters)
        print(json.dumps({"stage": stage, "shape": f"{n}x{h}x{w}x{nb} u8",
                          "seconds": t, "raw_MBps": raw / 1e6 / t}),
              flush=True)

    zp = jnp.zeros(nb, jnp.uint8)
    zr = jnp.zeros(nb, jnp.int32)
    phase_a = jax.jit(jax.vmap(lambda im: encode_fast_blocks(
        im, zp, zr, HILBERT, cband, True, with_rungs=True, lanewise=True)[:2]))
    dtiles = jax.device_put(jnp.asarray(tiles))
    report("phase_a", phase_a, dtiles)
    codes, lens = phase_a(dtiles)
    n_words = (max_encoded_size(w, h, nb, 0) + 3) // 4 + 2
    pack = jax.jit(jax.vmap(lambda c, ln: pack_groups(
        c, ln, n_words, group_bits_bound(8, best=False))[:2]))
    report("pack", pack, codes, lens)
    del codes, lens

    def flat_payload(streams):
        infos = [container.parse_headers(s) for s in streams]
        flat, tw32 = batch._flat_tile_layout(
            [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)])
        return infos, tw32, jax.device_put(
            jnp.asarray(flat.reshape(-1).view(np.uint32)))

    infos, tw32, words = flat_payload(
        batch.encode_tiles(tiles, mode=Mode.FTL, index="ic"))
    metas = [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
    k = metas[0][0]
    tbase = (np.arange(n, dtype=np.int64) * tw32 * 32)[:, None]
    starts = jnp.asarray(((np.stack([m[1] for m in metas]) + tbase)
                          .reshape(-1)).astype(np.int32))
    entry = jnp.asarray(np.concatenate([m[2] for m in metas]))
    walk = jax.jit(lambda wd, s, e: decode_chunked(
        wd, s, e, k, n * nblocks, nb, False, 8))
    report("ic_walk", walk, words, starts, entry)
    groups = walk(words, starts, entry).reshape(n, nblocks, nb, B2)
    recon = jax.jit(lambda g: reconstruct_batch(g, h, w, nb, HILBERT, cband,
                                                np.uint8))
    report("reconstruct", recon, groups)
    check = np.asarray(recon(groups))
    assert np.array_equal(check, tiles), "ic walk + reconstruct differ"
    del groups

    infos, tw32, words = flat_payload(
        batch.encode_tiles(tiles, mode=Mode.FTL, index=True))
    glens = np.stack([np.frombuffer(i.index, dtype="<u2").astype(np.int32)
                      for i in infos])
    nreg = _indexed_nreg(glens, 8)
    wave = jax.jit(lambda wd, gl: decode_indexed_narrow(
        wd, gl, nblocks, nb, False, 8, ntiles=n, tile_words32=tw32,
        nreg=nreg))
    report("ix_wave", wave, words, jnp.asarray(glens.reshape(-1)))

    infos, tw32, words = flat_payload(
        batch.encode_tiles(tiles, mode=Mode.CF_H, index=True))
    metas = [_parse_best_sidecar(i.index_best, nblocks * nb) for i in infos]
    tbase = (np.arange(n, dtype=np.int64) * tw32 * 32)[:, None]
    meta = [jnp.asarray(np.stack([m[j] for m in metas]).reshape(-1))
            for j in range(4)]
    meta[1] = jnp.asarray((np.stack([m[1] for m in metas]) + tbase)
                          .reshape(-1))
    ib = jax.jit(lambda wd, kind, pos, vr, cf: decode_groups_fused(
        wd, kind, pos, vr, cf, True, 8))
    report("ib_wave", ib, words, *meta)
    print(json.dumps({"device": device}), flush=True)


if __name__ == "__main__":
    main()
