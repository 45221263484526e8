"""Compression + throughput study: QB3 modes vs PNG over a CID22-scale
corpus (reference: performance/performance.md, CID22_sizes.csv — 248 images,
512x512 RGB8).  That dataset isn't redistributable here, so the corpus is
248 seeded photo-statistics synthetics (tests/corpus.photo8: 1/f spectra,
correlated channels, grain) plus any real images found on the system; any
folder of PNGs can substitute via --corpus.

Two sections:
  sizes  — per-image PNG/FTL/BASE/BEST[/deflate] bytes -> sizes.csv (CPU ok)
  rates  — device encode+decode MB/s per mode, measured batched on an
           NVIDIA GPU (the pass fails without one)

    python tools/perf_study.py --n 248 [--skip-rates] [--corpus DIR]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def load_corpus(args):
    if args.corpus:
        from PIL import Image

        for name in sorted(os.listdir(args.corpus))[: args.n]:
            if name.lower().endswith((".png", ".jpg")):
                arr = np.asarray(Image.open(os.path.join(args.corpus, name)))
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                yield name, arr
        return
    from corpus import photo8, real_images

    yield from real_images()
    for i in range(args.n):
        yield f"photo{i:03d}", photo8(args.size, args.size, seed=2000 + i)


def png_codec(img: np.ndarray):
    from PIL import Image

    buf = io.BytesIO()
    t0 = time.perf_counter()
    Image.fromarray(img if img.shape[2] > 1 else img[:, :, 0]).save(
        buf, format="PNG", optimize=False)
    t_enc = time.perf_counter() - t0
    buf.seek(0)
    t0 = time.perf_counter()
    np.asarray(Image.open(buf))
    t_dec = time.perf_counter() - t0
    return buf.getbuffer().nbytes, t_enc, t_dec


def size_study(args, out_dir):
    import qb3_tpu
    from qb3_tpu.batch import encode_tiles
    from qb3_tpu.cli import BANDMIXES

    cols = ["image", "raw", "png", "ftl", "base", "best", "bestband",
            "best_deflate", "bandmix_deflate"]
    times = {m: 0.0 for m in ("png_enc", "png_dec")}
    names, imgs, pngs = [], [], []
    for name, img in load_corpus(args):
        names.append(name)
        imgs.append(img)
        pz, tpe, tpd = png_codec(img)
        times["png_enc"] += tpe
        times["png_dec"] += tpd
        pngs.append(pz)
    total_raw = sum(im.nbytes for im in imgs)
    n = len(imgs)

    def batched_lens(mode, coreband=None):
        """Per-image stream bytes via the batched encoder (32/dispatch for
        same-shape runs; odd shapes one-shot)."""
        out = [None] * n
        by_shape = {}
        for i, im in enumerate(imgs):
            by_shape.setdefault(im.shape, []).append(i)
        for shape, idxs in by_shape.items():
            if len(idxs) < 2:
                for i in idxs:
                    out[i] = len(qb3_tpu.encode(imgs[i], mode=mode,
                                                coreband=coreband))
                continue
            for j in range(0, len(idxs), 32):
                part = idxs[j : j + 32]
                tiles = np.stack([imgs[i] for i in part])
                streams = encode_tiles(tiles, mode=mode, coreband=coreband)
                for i, st in zip(part, streams):
                    out[i] = len(st)
        return out

    ftl = batched_lens(8)
    base = batched_lens(4)
    best = batched_lens(7)
    print("  base modes sized", flush=True)
    # BestBand: the reference CLI's -m x exhaustive RGB core-band search
    # (cqb3.cpp:561-586), smallest of the 10 combos per image
    mix_lens = []
    mix_streams_best = [None] * n
    for mix in BANDMIXES:
        mix_lens.append(batched_lens(7, coreband=mix))
        print(f"  bandmix {mix} sized", flush=True)
    bestband = []
    for i in range(n):
        if imgs[i].shape[2] == 3:
            bestband.append(min(ml[i] for ml in mix_lens))
        else:
            bestband.append(best[i])
    # deflate post-pass rows (zlib stands in for the reference study's zstd)
    best_deflate, bandmix_deflate = [], []
    for i in range(n):
        s_plain = qb3_tpu.encode(imgs[i], mode=7)
        best_deflate.append(len(zlib.compress(s_plain, 6)))
        if imgs[i].shape[2] == 3:
            wins = min(range(len(BANDMIXES)),
                       key=lambda k: mix_lens[k][i])
            s_mix = qb3_tpu.encode(imgs[i], mode=7,
                                   coreband=BANDMIXES[wins])
            bandmix_deflate.append(len(zlib.compress(s_mix, 6)))
        else:
            bandmix_deflate.append(best_deflate[-1])
        if (i + 1) % 50 == 0:
            print(f"  {i + 1} deflate rows", flush=True)

    rows = [[names[i], imgs[i].nbytes, pngs[i], ftl[i], base[i], best[i],
             bestband[i], best_deflate[i], bandmix_deflate[i]]
            for i in range(n)]
    with open(os.path.join(out_dir, "sizes.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    arr = np.array([r[1:] for r in rows], dtype=np.int64)
    return rows, arr.sum(axis=0), total_raw, times


def rate_study(args):
    """Device rates per mode on the GPU (benchutil.sustained, ended by
    block_until_ready): FTL/BASE batched 32/dispatch (flat ix layout +
    self-contained ic chunk walk), BEST as queued single dispatches."""
    from qb3_tpu.benchutil import device_info

    device = device_info()
    import jax
    import jax.numpy as jnp

    import qb3_tpu
    from qb3_tpu import container
    from qb3_tpu.api import (_best_kernel, _decode_kernel,
                             _parse_best_sidecar, max_encoded_size)
    from qb3_tpu.batch import (_batch_decode_kernel,
                               _batch_decode_kernel_chunked,
                               _batch_encode_kernel, _flat_tile_layout,
                               encode_tiles)
    from qb3_tpu.constants import HILBERT, Mode
    from qb3_tpu.ops.decode import payload_words
    from qb3_tpu.ops.decode_chunked import parse_ic
    from corpus import photo8

    def sustained(fn, iters=12):
        from qb3_tpu.benchutil import sustained as _s
        return _s(fn, iters)

    h = w = args.size
    nb = 3
    NBATCH = 32
    tiles = np.stack([photo8(h, w, seed=3000 + i) for i in range(NBATCH)])
    raw_mb = tiles[0].nbytes / 1e6
    n_words = (max_encoded_size(w, h, nb, 0) + 3) // 4 + 2
    nblocks = (h // 4) * (w // 4)
    rates = {}
    for label, mode in (("ftl", Mode.FTL), ("base", Mode.BASE_H)):
        ek = _batch_encode_kernel(NBATCH, (h, w, nb), "uint8", HILBERT,
                                  (1, 1, 1), mode == Mode.FTL, n_words)
        dt = jax.device_put(jnp.asarray(tiles))
        t_enc = sustained(lambda: ek(dt)) / NBATCH
        streams = encode_tiles(tiles, mode=mode, index=True)
        infos = [container.parse_headers(s) for s in streams]
        wl = [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)]
        flat, tw32 = _flat_tile_layout(wl)
        gl = np.stack([np.frombuffer(i.index, dtype="<u2").astype(np.int32)
                       for i in infos])
        dk = _batch_decode_kernel(NBATCH, nblocks, nb, h, w, HILBERT,
                                  tuple(infos[0].cband), mode != Mode.FTL,
                                  "uint8", flat.size, tw32)
        dwp = jax.device_put(jnp.asarray(flat.reshape(-1)))
        dgl = jax.device_put(jnp.asarray(gl.reshape(-1)))
        out = dk(dwp, dgl)
        assert (np.asarray(out) == tiles).all(), label
        t_dec = sustained(lambda: dk(dwp, dgl)) / NBATCH
        rates[label] = (raw_mb / t_enc, raw_mb / t_dec)
        print(f"  {label}: enc {rates[label][0]:.0f} dec {rates[label][1]:.0f} MB/s",
              flush=True)

    # FTL self-contained (ic) decode: the honest no-19%-sidecar rate
    streams = encode_tiles(tiles, mode=Mode.FTL, index="ic")
    infos = [container.parse_headers(s) for s in streams]
    wl = [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)]
    flat, tw32 = _flat_tile_layout(wl)
    metas = [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
    kb = metas[0][0]
    tbase = (np.arange(NBATCH, dtype=np.int64) * tw32 * 32)[:, None]
    bstarts = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
    bentry = np.concatenate([m[2] for m in metas])
    dkc = _batch_decode_kernel_chunked(NBATCH, nblocks, nb, h, w, HILBERT,
                                       tuple(infos[0].cband), False, "uint8",
                                       flat.size, kb)
    dwp = jax.device_put(jnp.asarray(flat.reshape(-1)))
    dst = jax.device_put(jnp.asarray(bstarts.astype(np.int32)))
    den = jax.device_put(jnp.asarray(bentry))
    out = dkc(dwp, dst, den)
    assert (np.asarray(out) == tiles).all(), "ic"
    t_ic = sustained(lambda: dkc(dwp, dst, den)) / NBATCH
    rates["ftl_selfcontained_dec"] = raw_mb / t_ic
    print(f"  ftl ic decode: {raw_mb/t_ic:.0f} MB/s", flush=True)

    # BEST: queued single dispatches (see batch._batch_best_kernel notes)
    img = tiles[0]
    bk = _best_kernel((h, w, nb), "uint8", HILBERT, (1, 1, 1), n_words)
    dimg = jax.device_put(jnp.asarray(img))
    bargs = (dimg, jnp.zeros(nb, jnp.uint8), jnp.zeros(nb, jnp.int32),
             jnp.zeros(nb, jnp.uint8))
    t_enc = sustained(lambda: bk(*bargs))
    sbest = qb3_tpu.encode(img, mode=Mode.CF_H, index=True)
    info = container.parse_headers(sbest)
    words = payload_words(sbest[info.data_offset:])
    nw = 1 << max(4, int(np.ceil(np.log2(len(words)))))
    wp = np.zeros(nw, np.uint64)
    wp[: len(words)] = words
    kind, val_pos, vrung, cf = _parse_best_sidecar(info.index_best,
                                                   nblocks * nb)
    dk = _decode_kernel(nblocks, nb, h, w, HILBERT, tuple(info.cband), True,
                        "uint8", nw)
    dargs = (jax.device_put(jnp.asarray(wp)), jnp.asarray(kind),
             jnp.asarray(val_pos), jnp.asarray(vrung), jnp.asarray(cf),
             jnp.zeros(nb, dtype=jnp.uint64))
    out = dk(*dargs)
    assert (np.asarray(out[0]) == img).all()
    t_dec = sustained(lambda: dk(*dargs))
    rates["best"] = (raw_mb / t_enc, raw_mb / t_dec)
    print(f"  best: enc {rates['best'][0]:.0f} dec {rates['best'][1]:.0f} MB/s",
          flush=True)
    rates["device"] = device
    return rates


def main():
    """Two-pass protocol (backend is fixed per process):
      1. python tools/perf_study.py --skip-sizes           # on the GPU
      2. python tools/perf_study.py --skip-rates --cpu     # sizes + report
    Pass 1 writes performance/rates.json; pass 2 reads it."""
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=248)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--corpus")
    ap.add_argument("--skip-rates", action="store_true")
    ap.add_argument("--skip-sizes", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (the size pass needs no "
                         "GPU)")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "performance"))
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out, exist_ok=True)
    rates_path = os.path.join(args.out, "rates.json")
    rates = None
    if not args.skip_rates:
        print("rates (device, batched):", flush=True)
        rates = rate_study(args)
        with open(rates_path, "w") as f:
            json.dump(rates, f)
    elif os.path.exists(rates_path):
        rates = json.load(open(rates_path))
    if args.skip_sizes:
        return
    print("sizes:", flush=True)
    rows, (raw, png, ftl, base, best, bestband, bestz, mixz), \
        total_raw, times = size_study(args, args.out)
    n = len(rows)
    mb = total_raw / 1e6

    def rate_cols(label):
        if rates and label in rates:
            return f"{rates[label][0]:.0f} | {rates[label][1]:.0f}"
        return "— | —"

    report = f"""# qb3-tpu compression + throughput study (CID22-scale)

Corpus: {n} images, {total_raw:,} raw bytes
({'folder ' + args.corpus if args.corpus else
  f'photo-statistics synthetics, {args.size}x{args.size} RGB8 (tests/corpus.photo8)'}).
Mirrors the reference CID22 study (performance/performance.md:89-155;
reference rates there: FTL 397.76 / BASE 327.44 / BEST 160.93 MB/s encode,
354.57 MB/s decode, one Zen3 core).

| codec | total bytes | vs raw | savings vs PNG | device enc MB/s | device dec MB/s |
|---|---|---|---|---|---|
| PNG (Pillow/zlib) | {png:,} | {100*png/raw:.2f}% | — | {mb/times['png_enc']:.1f} (host) | {mb/times['png_dec']:.1f} (host) |
| QB3 FTL | {ftl:,} | {100*ftl/raw:.2f}% | {100*(png-ftl)/png:.2f}% | {rate_cols('ftl')} |
| QB3 BASE | {base:,} | {100*base/raw:.2f}% | {100*(png-base)/png:.2f}% | {rate_cols('base')} |
| QB3 BEST | {best:,} | {100*best/raw:.2f}% | {100*(png-best)/png:.2f}% | {rate_cols('best')} |
| QB3 BestBand (-m x) | {bestband:,} | {100*bestband/raw:.2f}% | {100*(png-bestband)/png:.2f}% | — | — |
| QB3 BEST + deflate | {bestz:,} | {100*bestz/raw:.2f}% | {100*(png-bestz)/png:.2f}% | — | — |
| QB3 BestBand + deflate | {mixz:,} | {100*mixz/raw:.2f}% | {100*(png-mixz)/png:.2f}% | — | — |

QB3 streams are byte-identical to the reference implementation's, so the
size columns equal the reference codec's on this corpus by construction.
Device rates are batched (32 tiles/dispatch for FTL/BASE; BEST runs as
queued single dispatches) on {(rates or {{}}).get('device', 'no GPU: not measured')},
timed with jax.block_until_ready (qb3_tpu/benchutil.py). FTL decode via the
self-contained "ic" sidecar measures
{(rates or {{}}).get('ftl_selfcontained_dec', 0):.0f} MB/s; the ix figure is in the table.
Per-image sizes: sizes.csv. Reference published numbers: ../BASELINE.md.
"""
    with open(os.path.join(args.out, "REPORT.md"), "w") as f:
        f.write(report)
    print(report)


if __name__ == "__main__":
    main()
