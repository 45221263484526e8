"""The group pack (bitpack.pack_groups: per-group slab fold + one
scatter-add) against the per-symbol reference pack_symbols_scatter."""

import jax.numpy as jnp
import numpy as np
import pytest

from qb3_tpu.api import max_encoded_size
from qb3_tpu.constants import HILBERT
from qb3_tpu.ops import bitpack
from qb3_tpu.ops.encode import encode_fast_blocks

from . import corpus


@pytest.mark.parametrize("npdt,mult,dtc,bands", [
    (np.uint8, 1, 0, 1), (np.uint8, 1, 0, 3), (np.uint16, 257, 2, 1),
    (np.uint32, 1 << 16, 4, 1), (np.uint64, 1 << 40, 6, 1),
])
def test_pack_groups_matches_scatter(npdt, mult, dtc, bands):
    img = corpus.to_type(corpus.natural8(24, 20, bands, seed=17), npdt, mult)
    if npdt == np.uint64:
        img[0, 0, 0] = np.uint64((1 << 64) - 1)  # a rung-63 group
    h, w, nb = img.shape
    tbits = np.dtype(npdt).itemsize * 8
    cband = (1, 1, 1) if nb == 3 else tuple(range(nb))
    codes, lens, _, _ = encode_fast_blocks(
        jnp.asarray(img), jnp.zeros(nb, npdt), jnp.zeros(nb, jnp.int32),
        HILBERT, cband, True)
    codes = codes.reshape(-1, codes.shape[-1])
    lens = lens.reshape(-1, lens.shape[-1])
    n_words = (max_encoded_size(w, h, nb, dtc) + 3) // 4 + 2
    maxbits = bitpack.group_bits_bound(tbits, best=False)
    words, total, glen = bitpack.pack_groups(codes, lens, n_words, maxbits)
    ref, ref_total = bitpack.pack_symbols_scatter(
        codes.reshape(-1), lens.reshape(-1), n_words)
    assert int(total) == int(ref_total)
    nw = (int(total) + 31) // 32
    np.testing.assert_array_equal(np.asarray(words)[:nw],
                                  np.asarray(ref)[:nw])
    np.testing.assert_array_equal(np.asarray(glen),
                                  np.asarray(lens).sum(axis=1))
