"""The "ic" chunked-anchor sidecar: self-contained parallel decode with ~1%
stream overhead (vs ~19% for the full per-group "ix" index).

Every stream must decode identically through the chunk-parallel device walk
(ops/decode_chunked.py) and stay readable by the reference decoder (the "ic"
chunk is lowercase-skippable, QB3decode.cpp:251-259).
"""

import numpy as np
import pytest

import qb3_tpu
from qb3_tpu import container
from qb3_tpu.constants import Mode

from . import corpus, refqb3


def roundtrip_ic(img, mode, k=0, **kw):
    enc_plain = qb3_tpu.encode(img, mode=mode, **kw)
    if k:
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        from qb3_tpu.api import DT_FROM_NP, Encoder
        e = Encoder(w, h, c, DT_FROM_NP[img.dtype])
        e.set_mode(mode)
        e.with_index = "ic"
        e.index_chunk_blocks = k
        stream = e.encode(img.reshape(h, w, c))
    else:
        stream = qb3_tpu.encode(img, mode=mode, index="ic", **kw)
    info = container.parse_headers(stream)
    assert info.index_chunked is not None
    dec, _ = qb3_tpu.decode(stream)
    np.testing.assert_array_equal(dec.reshape(img.shape), img)
    # the sidecar only adds skippable chunks: payload identical to plain
    assert stream[info.data_offset:] == enc_plain[
        container.parse_headers(enc_plain).data_offset:]
    if refqb3.available():
        ref_dec, _ = refqb3.ref_decode(stream)
        np.testing.assert_array_equal(ref_dec.reshape(img.shape), img)
    return stream, enc_plain


@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.BASE_Z])
def test_modes_u8(mode):
    roundtrip_ic(corpus.natural8(64, 48, 1, seed=80), mode)


def test_rgb_ftl():
    roundtrip_ic(corpus.natural8(72, 60, 3, seed=81), Mode.FTL)


@pytest.mark.parametrize("dtype,mult", [
    (np.uint16, 257), (np.uint32, 65537),
    (np.uint64, 1 << 40), (np.uint64, 1 << 56),
])
def test_wide_types(dtype, mult):
    img = corpus.to_type(corpus.natural8(48, 32, 1, seed=82), dtype, mult)
    roundtrip_ic(img, Mode.FTL)
    roundtrip_ic(img, Mode.BASE_H)


def test_u64_rung63():
    """Max-rung spikes in otherwise smooth data exercise the 65-bit long
    form inside the chunk walk (without tripping the stored fallback)."""
    img = corpus.natural8(32, 32, 1, seed=83).astype(np.uint64)
    spikes = [1 << 63, (1 << 63) | (1 << 62), (1 << 64) - 1, 1 << 62]
    for i, s in enumerate(spikes):
        img[4 * i, 0, 0] = s
    stream, _ = roundtrip_ic(img, Mode.FTL)
    assert container.parse_headers(stream).mode == Mode.FTL


@pytest.mark.parametrize("k", [1, 4, 64])
def test_chunk_sizes(k):
    # 3 bands, not 2: the reference cannot decode its own >=2-band
    # identity-cband streams (REFERENCE_BUGS.md #3); 3 bands get a CB chunk
    roundtrip_ic(corpus.natural8(64, 64, 3, seed=84), Mode.FTL, k=k)


def test_unaligned_shape():
    roundtrip_ic(corpus.natural8(53, 47, 1, seed=85), Mode.FTL)


def test_rle_wrapped():
    """RLE post-pass: sidecar describes the pre-RLE payload."""
    img = np.zeros((64, 64, 1), np.uint8)
    img[10:20, 10:20] = 200
    stream, _ = roundtrip_ic(img, Mode.RLE_H)
    assert container.parse_headers(stream).mode == Mode.RLE_H


def test_overhead_under_2pct():
    img = corpus.natural8(256, 256, 3, seed=86)
    stream, plain = roundtrip_ic(img, Mode.FTL)
    overhead = (len(stream) - len(plain)) / len(plain)
    assert overhead <= 0.02, f"ic sidecar overhead {overhead:.1%}"


def test_signed():
    img = (corpus.natural8(48, 48, 1, seed=87).astype(np.int16) - 100).astype(np.int16)
    roundtrip_ic(img, Mode.FTL)


# ------------------------------------------------------------ chunk walk

def _chunk_walk_case(img, mode):
    """The XLA chunk walk (decode_chunked) must give the same groups as the
    ix-sidecar decode of the same payload, and the ic stream must decode
    to the input through qb3_tpu.decode and lite.decode."""
    import jax.numpy as jnp

    from qb3_tpu import lite
    from qb3_tpu.ops.decode import decode_indexed_narrow, payload_words
    from qb3_tpu.ops.decode_chunked import decode_chunked, parse_ic

    h, w = img.shape[:2]
    nb = img.shape[2] if img.ndim == 3 else 1
    stream = qb3_tpu.encode(img, mode=mode, index="ic")
    info = container.parse_headers(stream)
    info_ix = container.parse_headers(
        qb3_tpu.encode(img, mode=mode, index=True))
    nblocks = ((h + 3) // 4) * ((w + 3) // 4)
    kk, starts, entry, total = parse_ic(info.index_chunked, nblocks, nb)
    words = jnp.asarray(payload_words(stream[info.data_offset:]))
    tbits = img.dtype.itemsize * 8
    got = np.asarray(decode_chunked(words, jnp.asarray(starts.astype(np.int32)),
                                    jnp.asarray(entry), kk, nblocks, nb,
                                    mode != Mode.FTL, tbits))
    glens = np.frombuffer(info_ix.index, dtype="<u2").astype(np.int32)
    ref = np.asarray(decode_indexed_narrow(words, jnp.asarray(glens), nblocks,
                                           nb, mode != Mode.FTL, tbits))
    np.testing.assert_array_equal(got, ref)
    dec = qb3_tpu.Decoder(stream)
    np.testing.assert_array_equal(dec.read_data().reshape(img.shape), img)
    assert dec.decode_path == "ic"
    np.testing.assert_array_equal(lite.decode(stream)[0].reshape(img.shape),
                                  img)


@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.BASE_Z])
def test_chunk_walk_modes(mode):
    _chunk_walk_case(corpus.natural8(64, 48, 3, seed=90), mode)


@pytest.mark.parametrize("mode,mult", [
    (Mode.FTL, 257), (Mode.BASE_H, 300), (Mode.FTL, 65535)])
def test_chunk_walk_u16(mode, mult):
    img = corpus.to_type(corpus.natural8(64, 48, 2, seed=92), np.uint16, mult)
    _chunk_walk_case(img, mode)


def test_chunk_walk_high_rungs():
    # 0<->255 spikes plant rung-7 groups (9-bit codes, the widest u8 form)
    # without tripping the stored fallback on fully random data
    img = corpus.natural8(48, 64, 1, seed=91)
    img[::8, ::8] = 255
    img[4::8, 2::8] = 0
    _chunk_walk_case(img, Mode.FTL)
