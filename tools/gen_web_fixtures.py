"""Generate web/test/fixtures.js: base64 QB3 streams + expected raw pixels
for the pure-JS client decoder's conformance page (web/test/run.html)."""

import base64
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def fixture_cases():
    """The pinned conformance cases: [(name, image, mode, encode kwargs)].
    Every dtype, FTL/BASE/BEST, quanta, RLE, small and stored images, core
    bands and the ic sidecar; the images come from fixed seeds."""
    from qb3_tpu.constants import Mode
    from tests import corpus

    cases = []

    def add(name, img, mode, **kw):
        cases.append((name, img, mode, kw))

    add("ftl-u8-rgb", corpus.natural8(24, 20, 3, seed=200), Mode.FTL)
    add("base-h-u8", corpus.natural8(20, 24, 1, seed=201), Mode.BASE_H)
    add("base-z-u8", corpus.natural8(16, 16, 1, seed=202), Mode.BASE_Z)
    add("best-u8", corpus.natural8(24, 24, 2, seed=203), Mode.CF_H)
    cf = corpus.natural8(24, 24, 1, seed=204).astype(np.uint8)
    cf = (cf // 5) * np.uint8(5)
    add("best-cf-u8", cf, Mode.CF_H)
    idx = np.array([0, 1 << 11, 3 << 11, 7 << 11], np.uint16)[
        np.random.default_rng(205).integers(0, 4, (24, 24, 1))]
    add("best-idx-u16", idx, Mode.CF_H)
    add("ftl-u16", corpus.to_type(corpus.natural8(20, 20, 1, seed=206),
                                  np.uint16, 257), Mode.FTL)
    add("ftl-i16", (corpus.natural8(20, 20, 1, seed=207).astype(np.int16)
                    - 100).astype(np.int16), Mode.FTL)
    add("ftl-u32", corpus.to_type(corpus.natural8(16, 16, 1, seed=208),
                                  np.uint32, 65537), Mode.FTL)
    add("ftl-u64", corpus.to_type(corpus.natural8(16, 16, 1, seed=209),
                                  np.uint64, 1 << 40), Mode.FTL)
    u64hi = corpus.natural8(16, 16, 1, seed=210).astype(np.uint64)
    u64hi[0, 0, 0] = (1 << 63) | (1 << 62)
    u64hi[4, 0, 0] = (1 << 64) - 1
    add("ftl-u64-rung63", u64hi, Mode.FTL)
    add("ftl-i64", (corpus.natural8(16, 16, 1, seed=211).astype(np.int64)
                    * -(1 << 30)).astype(np.int64), Mode.FTL)
    add("quanta-u8", corpus.natural8(24, 24, 1, seed=212), Mode.FTL, quanta=4)
    add("quanta-i16", (corpus.natural8(24, 24, 1, seed=213).astype(np.int16)
                       - 120).astype(np.int16), Mode.FTL, quanta=7, away=True)
    rle = np.zeros((32, 32, 1), np.uint8)
    rle[10:14, 10:14] = 99
    add("rle-u8", rle, Mode.RLE_H)
    add("small-narrow", corpus.natural8(20, 2, 1, seed=214), Mode.FTL)
    add("small-wide", corpus.natural8(2, 20, 1, seed=215), Mode.FTL)
    add("stored-tiny", corpus.natural8(3, 3, 1, seed=216), Mode.FTL)
    add("coreband", corpus.natural8(24, 24, 3, seed=217), Mode.FTL,
        coreband=[1, 1, 1])
    add("sidecar-ic", corpus.natural8(24, 24, 1, seed=218), Mode.FTL,
        index="ic")

    return cases


def main():
    import qb3_tpu

    cases = []
    for name, img, mode, kw in fixture_cases():
        stream = qb3_tpu.encode(img, mode=mode, **kw)
        dec, _ = qb3_tpu.decode(stream)
        cases.append({
            "name": name,
            "stream": base64.b64encode(stream).decode(),
            "raw": base64.b64encode(
                np.ascontiguousarray(dec).tobytes()).decode(),
            "dtype": str(img.dtype), "shape": list(dec.shape),
        })

    out = os.environ.get("QB3_FIXTURES_OUT",
                         os.path.join("web", "test", "fixtures.js"))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write("// generated by tools/gen_web_fixtures.py\n")
        f.write("export const FIXTURES = ")
        f.write(json.dumps(cases, indent=0))
        f.write(";\n")
    print(f"wrote {len(cases)} fixtures")


if __name__ == "__main__":
    main()
