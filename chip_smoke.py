"""Bring-up check: drive the codec's main paths once on one NVIDIA GPU.

    python chip_smoke.py [--seed N]          # five phases, one card
    python chip_smoke.py --four-cards        # the sharded paths, four cards

One process drives the card(s) through the public entry points.  Every
comparison is exact equality (the codec is integer-only):

  golden   the 20 pinned streams of web/test/fixtures.js, re-encoded
           byte for byte and decoded to the pinned pixels
  tiles    256 web-map tiles of 512x512x3 u8 (201 MB) through
           batch.encode_tiles(FTL, "ic") / batch.decode_tiles
  scene    one 2048x2048x8 u16 raster (67 MB) through encode/decode,
           FTL with the "ic" sidecar and BEST with "ib"
  wide     8 tiles of 1024x1024x1 u64 (67 MB), "ix" sidecar, batched
  foreign  24 sidecar-free 512x512x3 streams through foreign.decode_streams

--four-cards runs only parallel.sharded (encode_sharded, decode_fast_sharded,
encode_tiles_sharded on a 2x2 mesh) against single-card results from the
same process.

The first failure ends the run with a non-zero exit and a traceback; so does
a host where JAX finds no GPU.  The timings printed per phase are one-shot
bring-up timings (first call = compile + run; steady = second call), not
benchmark numbers.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time

import numpy as np

from qb3_tpu.benchutil import card_line, require_gpu

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ data

def natural(n: int, h: int, w: int, c: int, seed: int) -> np.ndarray:
    """(n, h, w, c) u8 rasters with tests/corpus.natural8's recipe
    (gradients, blurred noise, hard edges), made in bulk from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    cc = np.arange(c, dtype=np.float32)
    base = (96 + 64 * np.sin(x[..., None] / (9 + 3 * cc))
            + 48 * np.cos(y[..., None] / (13 + 2 * cc)))
    base[(x + 2 * y) % 37 < 2] += 90
    out = np.empty((n, h, w, c), np.uint8)
    for i in range(n):
        z = rng.standard_normal((h, w, c), dtype=np.float32) * 6
        z = (z + np.roll(z, 1, 0) + np.roll(z, 1, 1)) / 3
        out[i] = np.clip(base + z, 0, 255)
    return out


def scene_u16(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A multispectral-like u16 raster: 14-bit range, 4 noisy low bits."""
    rng = np.random.default_rng(seed + 1)
    img = natural(1, h, w, c, seed)[0].astype(np.uint16) * np.uint16(64)
    return img + rng.integers(0, 16, img.shape, dtype=np.uint16)


def wide_u64(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """u64 rasters: the natural pattern in the top byte, 16 noisy low bits."""
    rng = np.random.default_rng(seed + 1)
    img = natural(n, h, w, 1, seed).astype(np.uint64) << np.uint64(40)
    return img | rng.integers(0, 1 << 16, img.shape, dtype=np.uint64)


# ------------------------------------------------------------ measurement

def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(label: str, fn, raw_bytes: int, shapes):
    """Call ``fn`` twice and print one bring-up line; returns the second
    result.  The API calls end in a host fetch, so the wall clock covers
    the device work."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    print(f"  {label}: shapes {shapes}, raw {raw_bytes / 1e6:.1f} MB, "
          f"first call (compile + run) {t1 - t0:.3f} s, "
          f"steady {t2 - t1:.3f} s, "
          f"peak_bytes_in_use since start {_peak_bytes(jax.devices()[0])}",
          flush=True)
    return out


# ---------------------------------------------------------------- phases

def load_fixtures():
    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        src = f.read()
    body = src[src.index("["): src.rindex("]") + 1]
    return json.loads(body)


def phase_golden(seed: int) -> None:
    """Re-encode the pinned conformance cases (fixed seeds, so --seed does
    not apply): byte-equal streams, decodes equal to the pinned pixels."""
    import qb3_tpu

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from gen_web_fixtures import fixture_cases

    cases = fixture_cases()
    pinned = load_fixtures()
    check([c[0] for c in cases] == [p["name"] for p in pinned],
          "golden: fixture cases differ from web/test/fixtures.js")

    def run():
        out = []
        for name, img, mode, kw in cases:
            stream = qb3_tpu.encode(img, mode=mode, **kw)
            dec, _ = qb3_tpu.decode(stream)
            out.append((stream, dec))
        return out

    raw = sum(c[1].nbytes for c in cases)
    got = timed(f"golden encode+decode x{len(cases)}", run, raw,
                "20 cases, 3x3 .. 24x24")
    for (stream, dec), p in zip(got, pinned):
        check(stream == base64.b64decode(p["stream"]),
              f"golden {p['name']}: stream differs from the pinned bytes")
        check(list(dec.shape) == p["shape"] and str(dec.dtype) == p["dtype"]
              and np.ascontiguousarray(dec).tobytes()
              == base64.b64decode(p["raw"]),
              f"golden {p['name']}: decode differs from the pinned pixels")
    print(f"  golden: {len(got)}/{len(pinned)} streams byte-equal, "
          "decodes exact", flush=True)


def phase_tiles(seed: int, n: int = 256, h: int = 512, w: int = 512,
                c: int = 3, samples: int = 4) -> None:
    import qb3_tpu
    from qb3_tpu import batch, lite
    from qb3_tpu.constants import Mode

    tiles = natural(n, h, w, c, seed)
    shapes = f"{n}x{h}x{w}x{c} u8"
    streams = timed("encode_tiles FTL ic", lambda: batch.encode_tiles(
        tiles, mode=Mode.FTL, index="ic"), tiles.nbytes, shapes)
    dec = timed("decode_tiles ic", lambda: batch.decode_tiles(streams),
                tiles.nbytes, shapes)
    exact = int(sum(np.array_equal(dec[i], tiles[i]) for i in range(n)))
    check(exact == n, f"tiles: {exact}/{n} tiles decode exactly")
    pick = np.random.default_rng(seed).choice(n, min(samples, n),
                                              replace=False)
    for i in pick:
        check(streams[i] == qb3_tpu.encode(tiles[i], mode=Mode.FTL,
                                           index="ic"),
              f"tiles: batch stream {i} differs from single-image encode")
        check(np.array_equal(lite.decode(streams[i])[0], tiles[i]),
              f"tiles: lite.decode of stream {i} differs from the input")
    ratio = sum(len(s) for s in streams) / tiles.nbytes
    print(f"  tiles: {exact}/{n} exact, {len(pick)} sampled streams equal "
          f"single encode and lite.decode; stream/raw {ratio:.4f}",
          flush=True)


def phase_scene(seed: int, h: int = 2048, w: int = 2048, c: int = 8) -> None:
    import qb3_tpu
    from qb3_tpu import container, lite
    from qb3_tpu.constants import Mode

    img = scene_u16(h, w, c, seed)
    shapes = f"{h}x{w}x{c} u16"
    for label, mode, index, path in (("FTL ic", Mode.FTL, "ic", "ic"),
                                     ("BEST ib", Mode.CF_H, True, "ib")):
        stream = timed(f"encode {label}", lambda: qb3_tpu.encode(
            img, mode=mode, index=index), img.nbytes, shapes)
        info = container.parse_headers(stream)
        check(info.mode == mode, f"scene {label}: stream mode {info.mode!r}")

        def dec_once():
            d = qb3_tpu.Decoder(stream)
            return d.read_data(), d.decode_path

        out, used = timed(f"decode {label}", dec_once, img.nbytes, shapes)
        check(used == path, f"scene {label}: decode took the {used} path")
        check(np.array_equal(out, img), f"scene {label}: round trip differs")
        check(np.array_equal(lite.decode(stream)[0], img),
              f"scene {label}: lite.decode differs from the input")
        print(f"  scene {label}: exact through the {used} path and "
              f"lite.decode; stream/raw {len(stream) / img.nbytes:.4f}",
              flush=True)


def phase_wide(seed: int, n: int = 8, h: int = 1024, w: int = 1024) -> None:
    from qb3_tpu import batch
    from qb3_tpu.constants import Mode

    tiles = wide_u64(n, h, w, seed)
    shapes = f"{n}x{h}x{w}x1 u64"
    streams = timed("encode_tiles FTL ix", lambda: batch.encode_tiles(
        tiles, mode=Mode.FTL, index=True), tiles.nbytes, shapes)
    dec = timed("decode_tiles ix", lambda: batch.decode_tiles(streams),
                tiles.nbytes, shapes)
    check(np.array_equal(dec, tiles), "wide: u64 batch round trip differs")
    print(f"  wide: {n}/{n} u64 tiles exact", flush=True)


def phase_foreign(seed: int, n: int = 24, h: int = 512, w: int = 512,
                  c: int = 3) -> None:
    import qb3_tpu
    from qb3_tpu import container, foreign, native

    check(native.available(),
          "foreign: the native walk (native/qb3xs.cpp) is not available")
    tiles = natural(n, h, w, c, seed)
    streams = [qb3_tpu.encode(t) for t in tiles]
    check(all(container.parse_headers(s).index is None
              and container.parse_headers(s).index_chunked is None
              for s in streams), "foreign: streams carry a sidecar")

    def run():
        out, np_dt = foreign.decode_streams(streams)
        return np.asarray(out).view(np_dt)

    dec = timed("foreign.decode_streams", run, tiles.nbytes,
                f"{n}x{h}x{w}x{c} u8")
    check(np.array_equal(dec, tiles), "foreign: bulk decode differs")
    print(f"  foreign: {n}/{n} sidecar-free streams exact", flush=True)


def phase_four_cards(seed: int, h: int = 8192, w: int = 8192, c: int = 3,
                     h64: int = 4096, w64: int = 4096, ntiles: int = 8,
                     th: int = 1024, tw: int = 1024, ndev: int = 4) -> None:
    """Sharded encode/decode over ``ndev`` cards, each result byte-equal
    to the single-card result from this process."""
    import jax

    import qb3_tpu
    from qb3_tpu import batch, container
    from qb3_tpu.constants import Mode
    from qb3_tpu.parallel.sharded import (decode_fast_sharded,
                                          encode_sharded,
                                          encode_tiles_sharded)

    check(len(jax.devices()) >= ndev,
          f"four-cards: {len(jax.devices())} devices, need {ndev}")
    scene = natural(1, h, w, c, seed)[0]
    shapes = f"{h}x{w}x{c} u8"
    for label, mode, index in (("FTL ix", Mode.FTL, True),
                               ("FTL ic", Mode.FTL, "ic"),
                               ("BEST ib", Mode.CF_H, True)):
        single = qb3_tpu.encode(scene, mode=mode, index=index)
        sharded = timed(f"encode_sharded {label} x{ndev}",
                        lambda: encode_sharded(scene, ndev, mode=mode,
                                               index=index),
                        scene.nbytes, shapes)
        check(sharded == single,
              f"four-cards: sharded {label} stream differs from single-card")
        dec = timed(f"decode_fast_sharded {label} x{ndev}",
                    lambda: decode_fast_sharded(sharded, ndev),
                    scene.nbytes, shapes)
        check(np.array_equal(dec.reshape(scene.shape), scene),
              f"four-cards: sharded {label} decode differs")
        print(f"  four-cards {label}: sharded stream byte-equal to "
              "single-card, sharded decode exact", flush=True)

    img64 = wide_u64(1, h64, w64, seed)[0]
    single = qb3_tpu.encode(img64, mode=Mode.FTL)
    sharded = timed(f"encode_sharded FTL u64 x{ndev}",
                    lambda: encode_sharded(img64, ndev, mode=Mode.FTL),
                    img64.nbytes, f"{h64}x{w64}x1 u64")
    check(sharded == single, "four-cards: sharded u64 stream differs")
    print("  four-cards FTL u64: sharded stream byte-equal to single-card",
          flush=True)

    tiles = natural(ntiles, th, tw, c, seed + 7)
    cband = tuple(range(c))
    singles = batch.encode_tiles(tiles, mode=Mode.FTL, coreband=cband)
    outs = timed("encode_tiles_sharded 2x2", lambda: encode_tiles_sharded(
        tiles, 2, ndev // 2, cband=cband), tiles.nbytes,
        f"{ntiles}x{th}x{tw}x{c} u8")
    for i, (o, s) in enumerate(zip(outs, singles)):
        check(o == s[container.parse_headers(s).data_offset:],
              f"four-cards: 2x2 mesh tile {i} differs from single-card")
    print(f"  four-cards 2x2 mesh: {len(outs)}/{ntiles} tile payloads "
          "byte-equal to single-card", flush=True)
    for d in jax.devices()[:ndev]:
        print(f"  device {d.id} peak_bytes_in_use {_peak_bytes(d)}",
              flush=True)


PHASES = (("golden", phase_golden), ("tiles", phase_tiles),
          ("scene", phase_scene), ("wide", phase_wide),
          ("foreign", phase_foreign))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    print(f"card: {card_line()}", flush=True)
    import jax

    devices = jax.devices()
    print(f"jax {jax.__version__}: platform {devices[0].platform}, "
          f"device_kind {devices[0].device_kind}, count {len(devices)}",
          flush=True)
    require_gpu(devices)

    from qb3_tpu import native

    print(f"native helper available: {native.available()}", flush=True)
    print("per-phase timings below are one-shot bring-up timings, "
          "not benchmark numbers", flush=True)
    phases = ((("four-cards", phase_four_cards),) if args.four_cards
              else PHASES)
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        fn(args.seed)
        print(f"phase {name} ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
