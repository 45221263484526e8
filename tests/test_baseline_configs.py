"""The five BASELINE.json benchmark configurations, as conformance tests."""

import numpy as np
import pytest

import qb3_tpu
from qb3_tpu.batch import decode_tiles, encode_tiles
from qb3_tpu.constants import Mode
from qb3_tpu.parallel.sharded import decode_fast_sharded, encode_fast_sharded

from . import corpus, refqb3

pytestmark = pytest.mark.skipif(not refqb3.available(), reason="oracle not built")


def test_config1_gray_base_bit_exact():
    """Single-band 8-bit 512x512 grayscale, QB3M_BASE, bit-exact roundtrip."""
    img = corpus.natural8(512, 512, 1, seed=400)
    ours = qb3_tpu.encode(img, mode=Mode.BASE_H)
    assert ours == refqb3.ref_encode(img, mode=int(Mode.BASE_H))
    dec, _ = qb3_tpu.decode(ours)
    np.testing.assert_array_equal(dec, img)


def test_config2_rgb_ftl_vs_base():
    """3-band natural image: FTL must be within 0.5% of BASE size."""
    sizes = {}
    for name, img in corpus.real_images():
        img = img[: img.shape[0] // 4 * 4, : img.shape[1] // 4 * 4]
        ftl = qb3_tpu.encode(img, mode=Mode.FTL)
        base = qb3_tpu.encode(img, mode=Mode.BASE_H)
        assert ftl == refqb3.ref_encode(img, mode=8)
        assert base == refqb3.ref_encode(img, mode=4)
        sizes[name] = (len(ftl), len(base))
        assert len(ftl) <= len(base) * 1.005, (name, sizes[name])
        break  # one real image suffices for the suite


def test_config3_dem_quanta_best():
    """16-bit DEM raster, lossy quanta=4, QB3M_BEST."""
    dem = corpus.real_dem()
    if dem is None:
        dem = corpus.to_type(corpus.natural8(128, 128, 1, seed=401), np.uint16, 257)
    dem = dem[: dem.shape[0] // 4 * 4, : dem.shape[1] // 4 * 4]
    ours = qb3_tpu.encode(dem, mode=Mode.CF_RLE_H, quanta=4)
    ref = refqb3.ref_encode(dem, mode=int(Mode.CF_RLE_H), quanta=4)
    assert ours == ref
    dec, _ = qb3_tpu.decode(ours)
    ref_dec, _ = refqb3.ref_decode(ref)
    np.testing.assert_array_equal(dec, ref_dec)
    assert np.abs(dec.astype(int) - dem.astype(int)).max() <= 2


def test_config4_landsat_tiles_batch():
    """8-band 16-bit tiles, interleaved, multi-tile batch per device."""
    tiles = np.stack([
        corpus.to_type(corpus.natural8(64, 64, 8, seed=410 + i), np.uint16, 257)
        for i in range(4)])
    streams = encode_tiles(tiles, mode=Mode.FTL, index=True)
    for i in range(4):
        assert streams[i] == qb3_tpu.encode(tiles[i], mode=Mode.FTL, index=True)
    np.testing.assert_array_equal(decode_tiles(streams), tiles)


def test_config5_u64_sharded():
    """64-bit raster sharded across a (virtual) device mesh, byte-exact."""
    img = corpus.to_type(corpus.natural8(64, 64, 1, seed=420), np.uint64, 1 << 40)
    from qb3_tpu import container
    single = qb3_tpu.encode(img, mode=Mode.FTL)
    info = container.parse_headers(single)
    payload, totals = encode_fast_sharded(img, 8, cband=(0,))
    assert payload == single[info.data_offset:]
    s_idx = qb3_tpu.encode(img, mode=Mode.FTL, index=True)
    np.testing.assert_array_equal(decode_fast_sharded(s_idx, 8), img)
