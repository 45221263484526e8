"""Multi-chip QB3: tile-row sharding over a device mesh.

The reference is strictly single-threaded (SURVEY.md §2.11); extent scaling
over devices is the axis the reference lacks.  The image is sharded in
block-row-aligned strips over a 1-D mesh.  The serial band state at strip
boundaries is *data-defined*, so it needs no sequential chain:

  * entry_prev  = the last scanned (band-decorrelated) value of the previous
    strip — a pure function of that strip's pixels, exchanged with one
    ppermute;
  * entry_runbits = the rung of the previous strip's last block — local to
    that strip once its own entry_prev arrived, one more ppermute.

Each device then runs the ordinary phase A/B on its strip; per-strip bit
lengths are all-gathered and the host (or a follow-up device pass) stitches
the strips into one valid stream by bit-shifting — producing the byte-exact
serial stream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import QB3ShapeError
from ..constants import B, B2, HILBERT, ubits_for
from ..ops.bitpack import group_bits_bound, pack_groups
from ..ops.encode import block_rungs, delta_mags, fast_symbols, gather_blocks


def _shard_encode_fn(order, cband, skipstep, ubits, n_words, axis, maxbits):
    def fn(img_local):
        # phase A needs the neighbor's exit state; both exchanges are pure
        # functions of local pixels (no sequential chain across devices)
        vals = gather_blocks(img_local, order, cband)
        n_dev = jax.lax.axis_size(axis)
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        exit_val = vals[-1, :, -1]  # (C,) last scanned value of this strip
        entry_prev = jax.lax.ppermute(exit_val, axis, perm)
        m, _ = delta_mags(vals, entry_prev)
        bitsused, rung, _, exit_runbits = block_rungs(
            m, jnp.zeros(vals.shape[1], jnp.int32))
        entry_runbits = jax.lax.ppermute(exit_runbits, axis, perm)
        oldrung = jnp.concatenate([entry_runbits[None, :], rung[:-1]], axis=0)
        codes, lens = fast_symbols(m, bitsused, rung, oldrung, ubits, skipstep)
        nsym = codes.shape[-1]
        words, total, glen = pack_groups(codes.reshape(-1, nsym), lens.reshape(-1, nsym),
                                         n_words, maxbits)
        return words[None], total[None], glen[None], rung[None]

    return fn


def _shard_best_fn(order, cband, ubits, n_words, axis, maxbits):
    from ..ops.encode_best import encode_best_blocks

    def fn(img_local):
        n_dev = jax.lax.axis_size(axis)
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        my = jax.lax.axis_index(axis)
        nbands = img_local.shape[-1]

        def prev_exchange(vals):
            return jax.lax.ppermute(vals[-1, :, -1], axis, perm)

        def rung_exchange(exit_runbits):
            return jax.lax.ppermute(exit_runbits, axis, perm)

        def cf_exchange(is_set, set_val):
            # entry pcf = last CF set among shards before me (else 0);
            # "last set wins" composes across shards (module docstring)
            nb_l = is_set.shape[0]
            idx = jnp.where(is_set, jnp.arange(nb_l, dtype=jnp.int32)[:, None], -1)
            last = jnp.max(idx, axis=0)  # (C,)
            val = jnp.take_along_axis(set_val, jnp.clip(last, 0, None)[None, :],
                                      axis=0)[0]
            has = last >= 0
            all_has = jax.lax.all_gather(has, axis)  # (n_dev, C)
            all_val = jax.lax.all_gather(val, axis)
            prior = jnp.arange(all_has.shape[0])[:, None] < my
            elig = all_has & prior
            sidx = jnp.max(jnp.where(elig, jnp.arange(all_has.shape[0])[:, None], -1),
                           axis=0)
            ent = jnp.take_along_axis(all_val, jnp.clip(sidx, 0, None)[None, :],
                                      axis=0)[0]
            return jnp.where(sidx >= 0, ent, jnp.zeros_like(ent))

        z = jnp.zeros(nbands, img_local.dtype)
        zr = jnp.zeros(nbands, jnp.int32)
        codes, lens, _, _, _, meta16, cfv, _, _ = encode_best_blocks(
            img_local, z, zr, z, order, cband, cf_exchange=cf_exchange,
            prev_exchange=prev_exchange, rung_exchange=rung_exchange)
        nsym = codes.shape[-1]
        words, total, glen = pack_groups(codes, lens, n_words, maxbits)
        return words[None], total[None], glen[None], meta16[None], cfv[None]

    return fn


@functools.lru_cache(maxsize=16)
def _sharded_kernel(shape, npdtype, order, cband, best, skipstep, n_words, n_dev):
    """Framed-path encode kernel.  Fast modes stitch INSIDE shard_map via
    scatter_stitch_shard — each link carries only the 8-byte totals
    all-gather, and every device keeps just its own word span (the
    post-shard_map stitch_words_device moved O(stream bytes) per link,
    doc/SCALING.md item 1).  Best mode still uses the device stitch."""
    if len(jax.devices()) < n_dev:
        raise RuntimeError(
            f"need {n_dev} devices, have {len(jax.devices())} "
            "(set --xla_force_host_platform_device_count for CPU testing)")
    from ..stitch import scatter_stitch_shard, stitch_words_device

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("tiles",))
    ubits = ubits_for(np.dtype(npdtype).itemsize)
    maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=best)
    if best:
        fn = _shard_best_fn(order, cband, ubits, n_words, "tiles", maxbits)
        mapped = jax.shard_map(fn, mesh=mesh, in_specs=P("tiles"),
                               out_specs=(P("tiles"),) * 5)
        nw_out = (n_dev * n_words) // 2 + 2

        def run(arr):
            outs = mapped(arr)
            words, totals = outs[0], outs[1]
            stitched, total = stitch_words_device(words, totals, nw_out)
            return (stitched, total, totals) + tuple(outs[2:])

        return jax.jit(run), mesh, False

    base = _shard_encode_fn(order, cband, skipstep, ubits, n_words, "tiles",
                            maxbits)

    def fn(img_local):
        words, total, glen, rung = base(img_local)
        own, n_own, nbits = scatter_stitch_shard(words[0], total[0], "tiles")
        return own[None], n_own[None], nbits[None], glen, rung

    mapped = jax.shard_map(fn, mesh=mesh, in_specs=P("tiles"),
                           out_specs=(P("tiles"),) * 5)
    return jax.jit(mapped), mesh, True


@functools.lru_cache(maxsize=16)
def _sharded_scatter_kernel(shape, npdtype, order, cband, skipstep, n_words,
                            n_dev):
    """Multi-device encode with the stitch inside shard_map via
    scatter_stitch_shard (one boundary u64 per device pair instead of the
    O(stream) implicit all-gather of stitch_words_device)."""
    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"need {n_dev} devices")
    from ..stitch import scatter_stitch_shard

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("tiles",))
    ubits = ubits_for(np.dtype(npdtype).itemsize)
    maxbits = group_bits_bound(np.dtype(npdtype).itemsize * 8, best=False)
    base = _shard_encode_fn(order, cband, skipstep, ubits, n_words, "tiles",
                            maxbits)

    def fn(img_local):
        words, total, glen, rung = base(img_local)
        own, n_own, nbits = scatter_stitch_shard(words[0], total[0], "tiles")
        return own[None], n_own[None], nbits[None], glen, rung

    mapped = jax.shard_map(fn, mesh=mesh, in_specs=P("tiles"),
                           out_specs=(P("tiles"),) * 5)
    return jax.jit(mapped), mesh


def encode_fast_sharded_scatter(img: np.ndarray, n_dev: int,
                                order: int = HILBERT,
                                cband: tuple[int, ...] | None = None,
                                skipstep: bool = True):
    """encode_fast_sharded with the reduce-scatter-style stitch: every
    device keeps only its own word span of the final stream; the host
    concatenates at word granularity.  Stitch traffic per device is
    8 bytes (one boundary word) + the 8-byte totals all-gather, vs
    O(stream bytes) for the all-gather stitch (doc/SCALING.md item 1).
    Byte-exact with the single-device stream."""
    from ..api import DT_FROM_NP, max_encoded_size
    from ..stitch import assemble_scatter

    h, w, nb = img.shape
    if h % (B * n_dev) != 0:
        raise QB3ShapeError("height must split into whole block rows per device")
    if cband is None:
        cband = tuple(range(nb))
    n_words = (max_encoded_size(w, h // n_dev, nb, DT_FROM_NP[img.dtype]) + 3) // 4 + 2
    kern, mesh = _sharded_scatter_kernel((h, w, nb), img.dtype.name, order,
                                         tuple(cband), skipstep, n_words, n_dev)
    arr = jax.device_put(jnp.asarray(img), NamedSharding(mesh, P("tiles")))
    own, n_own, nbits, glen, _ = kern(arr)
    payload = assemble_scatter(np.asarray(own), np.asarray(n_own),
                               np.asarray(nbits))
    return payload, np.asarray(nbits)


def encode_fast_sharded(img: np.ndarray, n_dev: int, order: int = HILBERT,
                        cband: tuple[int, ...] | None = None,
                        skipstep: bool = True):
    """Encode (H, W, C) across n_dev devices; H must be a multiple of 4*n_dev.

    Returns (payload bytes, per-shard bit lengths) — byte-exact with the
    single-device stream.  encode_sharded() adds container framing.
    """
    payload, totals, _, _ = _encode_sharded_payload(img, n_dev, order, cband,
                                                    skipstep, best=False)
    return payload, totals


def _encode_sharded_payload(img, n_dev, order, cband, skipstep, best):
    h, w, nb = img.shape
    if h % (B * n_dev) != 0:
        raise QB3ShapeError("height must split into whole block rows per device")
    if cband is None:
        cband = tuple(range(nb))
    from ..api import max_encoded_size, DT_FROM_NP
    from ..stitch import assemble_scatter
    n_words = (max_encoded_size(w, h // n_dev, nb, DT_FROM_NP[img.dtype]) + 3) // 4 + 2
    kern, mesh, scatter = _sharded_kernel((h, w, nb), img.dtype.name, order,
                                          tuple(cband), best, skipstep,
                                          n_words, n_dev)
    arr = jax.device_put(jnp.asarray(img), NamedSharding(mesh, P("tiles")))
    outs = kern(arr)
    if scatter:
        own, n_own, totals = (np.asarray(outs[0]), np.asarray(outs[1]),
                              np.asarray(outs[2]).reshape(-1))
        payload = assemble_scatter(own, n_own.reshape(-1), totals)
    else:
        stitched, total, totals = (np.asarray(outs[0]), int(outs[1]),
                                   np.asarray(outs[2]))
        payload = stitched.view(np.uint8)[: (total + 7) // 8].tobytes()
    glens = np.asarray(outs[3]).reshape(-1)
    extra = tuple(np.asarray(o) for o in outs[4:])  # rungs / (meta16, cfv)
    return payload, totals, glens, extra


def encode_sharded(img: np.ndarray, n_dev: int, mode: int | None = None,
                   quanta: int = 1, away: bool = False, coreband=None,
                   index=False) -> bytes:
    """Full container encode over an n_dev-device mesh: quanta, RLE
    post-pass, stored fallback, core bands, and the ix/ic/ib sidecars —
    byte-exact with the single-device Encoder (api.py) for every mode."""
    from .. import container, rle
    from ..api import DT_FROM_NP, UNSIGNED, default_cband, max_encoded_size, quantize
    from ..constants import (Mode, ZCURVE, is_best_mode, is_fast_mode,
                             mode_uses_zcurve, needs_rle)

    h, w, nb = img.shape
    dtype = DT_FROM_NP[img.dtype]
    user_mode = Mode(mode if mode is not None else Mode.FTL)
    mode = user_mode
    if needs_rle(mode):
        mode = {Mode.RLE: Mode.BASE_Z, Mode.CF_RLE: Mode.CF,
                Mode.RLE_H: Mode.BASE_H, Mode.CF_RLE_H: Mode.CF_H}[mode]
    order = ZCURVE if mode_uses_zcurve(user_mode) else 0
    cband = tuple(coreband) if coreband is not None else tuple(default_cband(nb))

    work = img
    if quanta >= 2:
        work = quantize(work, quanta, away)
    uns = work.view(UNSIGNED[work.dtype.itemsize])

    best = is_best_mode(mode)
    payload, totals, glens, extra = _encode_sharded_payload(
        uns, n_dev, order or HILBERT, cband, mode == Mode.FTL, best)

    idx_bytes, idx_sig = None, b"ix"
    if index:
        if best:
            from ..offsets import KIND_CF, KIND_CF0

            meta16, cfv = extra[0].reshape(-1), extra[1].reshape(-1)
            kind = meta16 & 7
            cfm = cfv[(kind == KIND_CF) | (kind == KIND_CF0)].astype(np.uint64)
            if not (cfm.size and int(cfm.max()) > 0xFFFF):
                idx_bytes, idx_sig = (glens.astype("<u2").tobytes()
                                      + meta16.astype("<u2").tobytes()
                                      + cfm.astype("<u2").tobytes()), b"ib"
        elif index == "ic":
            from ..ops.decode_chunked import IC_DEFAULT_K, chunk_spans, pack_ic

            rungs = extra[0].reshape(-1, nb)
            spans, entry = chunk_spans(glens.astype(np.int64), rungs,
                                       np.zeros(nb, np.int32), IC_DEFAULT_K)
            if int(spans.sum()) < 1 << 31:
                idx_bytes, idx_sig = pack_ic(spans, entry, IC_DEFAULT_K), b"ic"
        else:
            idx_bytes = glens.astype("<u2").tobytes()

    header = container.write_headers(w, h, nb, dtype, mode, list(cband),
                                     quanta, order, idx_bytes, idx_sig)
    result = header + payload
    max_size = max_encoded_size(w, h, nb, dtype)
    if needs_rle(user_mode) and len(result) <= max_size // 2:
        packed = rle.rle0_encode(payload)
        if len(packed) < len(payload) and len(packed) <= max_size - len(result):
            header = container.write_headers(w, h, nb, dtype, user_mode,
                                             list(cband), quanta, order,
                                             idx_bytes, idx_sig)
            return header + packed
    if img.nbytes <= len(result):
        hdr = container.write_headers(w, h, nb, dtype, Mode.STORED,
                                      list(cband), quanta, order)
        return hdr + img.tobytes()
    return result


@functools.lru_cache(maxsize=16)
def _tiles_sharded_kernel(shape, npdtype, n_batch, n_rows, order, cband,
                          skipstep):
    from ..api import DT_FROM_NP, max_encoded_size
    from ..stitch import stitch_words_device

    n, h, w, nb = shape
    mesh = Mesh(np.array(jax.devices()[: n_batch * n_rows]).reshape(
        n_batch, n_rows), ("batch", "rows"))
    itemsize = np.dtype(npdtype).itemsize
    n_words = (max_encoded_size(w, h // n_rows, nb,
                                DT_FROM_NP[np.dtype(npdtype)]) + 3) // 4 + 2
    fn = _shard_encode_fn(order, cband, skipstep, ubits_for(itemsize),
                          n_words, "rows", group_bits_bound(itemsize * 8,
                                                            best=False))

    def tilewise(batch_local):  # (N_l, H_l, W, C) on this device
        outs = jax.vmap(fn)(batch_local)
        return outs[0], outs[1]  # (N_l, 1, NW), (N_l, 1)

    mapped = jax.shard_map(tilewise, mesh=mesh,
                           in_specs=P("batch", "rows"),
                           out_specs=(P("batch", "rows", None),
                                      P("batch", "rows")))
    nw_out = (n_rows * n_words) // 2 + 2

    def run(arr):
        words, totals = mapped(arr)  # (N, n_rows, NW), (N, n_rows)
        return jax.vmap(lambda ws, ts: stitch_words_device(ws, ts, nw_out))(
            words, totals)

    return jax.jit(run), mesh


def encode_tiles_sharded(tiles: np.ndarray, n_batch: int, n_rows: int,
                         order: int = HILBERT,
                         cband: tuple[int, ...] | None = None,
                         skipstep: bool = True) -> list[bytes]:
    """2-D mesh variant: a (N, H, W, C) batch sharded over a
    ("batch", "rows") mesh — tiles data-parallel on one axis, each tile's
    rows split over the other (fresh per-tile band state, matching
    batch.encode_tiles).  Returns one payload per tile, byte-exact with
    the single-device streams."""
    n, h, w, nb = tiles.shape
    if len(jax.devices()) < n_batch * n_rows:
        raise RuntimeError(f"need {n_batch * n_rows} devices")
    if n % n_batch or h % (B * n_rows):
        raise QB3ShapeError("batch/rows must split evenly over the mesh")
    if cband is None:
        cband = tuple(range(nb))
    kern, mesh = _tiles_sharded_kernel(tiles.shape, tiles.dtype.name,
                                       n_batch, n_rows, order, tuple(cband),
                                       skipstep)
    arr = jax.device_put(jnp.asarray(tiles),
                         NamedSharding(mesh, P("batch", "rows")))
    stitched, total = kern(arr)
    stitched, total = np.asarray(stitched), np.asarray(total)
    return [stitched[i].view(np.uint8)[: (int(total[i]) + 7) // 8].tobytes()
            for i in range(n)]


def _finish_shard(g, nblocks_l, nbands, h_l, w, order, cband, tbits, axis):
    """Shared decode tail: cross-shard prev chain (all-gathered per-shard
    value totals, mod 2^bits) + per-shard reconstruct."""
    from ..ops.bitutils import smag
    from ..ops.decode import reconstruct

    my = jax.lax.axis_index(axis)
    g = g.reshape(nblocks_l, nbands, 16)
    dsum_v = jnp.sum(smag(g).transpose(1, 0, 2).reshape(nbands, -1), axis=1)
    all_v = jax.lax.all_gather(dsum_v, axis)
    n_dev = all_v.shape[0]
    entry_prev = jnp.sum(
        jnp.where(jnp.arange(n_dev)[:, None] < my, all_v, 0), axis=0)
    img, _ = reconstruct(g, entry_prev, h_l, w, nbands, order, cband,
                         np.dtype(f"uint{tbits}"))
    return img


def _shard_decode_fn(order, cband, apply_step, ubits, tbits, nblocks_l, nbands,
                     h_l, w, axis):
    """ix-sidecar shard decode over a LOCAL payload window (win64): each
    shard holds only the word range covering its own groups, not the whole
    replicated stream; winbase holds the window's absolute bit offset."""
    from ..ops.decode import decode_groups_regwindow, decode_groups

    def fn(win64, glens_l, winbase):
        # glens_l: this shard's per-group bit lengths; global offsets need the
        # bit total of preceding shards — an all-gather + masked sum
        my = jax.lax.axis_index(axis)
        local_bits = jnp.sum(glens_l.astype(jnp.int64))
        all_bits = jax.lax.all_gather(local_bits, axis)
        n_dev = all_bits.shape[0]
        entry_bits = jnp.sum(jnp.where(jnp.arange(n_dev) < my, all_bits, 0))
        rel0 = entry_bits - winbase[0]  # window-relative shard start

        nmask = (1 << ubits) - 1
        ends = jnp.cumsum(glens_l.astype(jnp.int64)) + rel0
        goff = (ends - glens_l).reshape(nblocks_l, nbands)
        from ..ops.decode import dsw_arith
        from ..ops.bitutils import peek64
        wv = peek64(win64, goff)
        has_cs = (wv & 1) == 1
        dlen, ddelta = dsw_arith(wv >> 1, ubits)
        cs_len = jnp.where(has_cs, dlen, 1)
        delta = jnp.where(has_cs, ddelta, 0)
        # rung chain: local prefix sum + all-gathered per-shard delta totals
        dsum = jnp.sum(delta, axis=0)
        all_dsum = jax.lax.all_gather(dsum, axis)  # (n_dev, C)
        entry_rung = jnp.sum(jnp.where(jnp.arange(n_dev)[:, None] < my, all_dsum, 0), axis=0)
        rung = (jnp.cumsum(delta, axis=0) + entry_rung[None, :]) & nmask
        rung0 = rung == 0
        from ..offsets import KIND_BITS, KIND_NORMAL, KIND_ZERO
        flag = (peek64(win64, goff + cs_len.astype(jnp.int64)) & 1).astype(jnp.int32)
        kind = jnp.where(rung0, jnp.where(flag == 1, KIND_BITS, KIND_ZERO), KIND_NORMAL)
        val_pos = goff + cs_len.astype(jnp.int64) + jnp.where(rung0, 1, 0)
        cf = jnp.zeros_like(wv)

        if tbits <= 16:
            g, _ = decode_groups_regwindow(win64, kind.reshape(-1).astype(jnp.uint8),
                                           val_pos.reshape(-1), rung.reshape(-1),
                                           cf.reshape(-1), apply_step, tbits)
        else:
            g, _ = decode_groups(win64, kind.reshape(-1).astype(jnp.uint8),
                                 val_pos.reshape(-1), rung.reshape(-1),
                                 cf.reshape(-1), apply_step, has_extended=False)
        return _finish_shard(g, nblocks_l, nbands, h_l, w, order, cband,
                             tbits, axis)

    return fn


def _shard_decode_best_fn(order, cband, tbits, nblocks_l, nbands, h_l, w, axis):
    """ib-sidecar shard decode: kind/val_pos/vrung/cf come pre-sharded from
    the host (val_pos already window-relative), covering CF/index groups."""
    from ..ops.decode import decode_groups, decode_groups_fused

    def fn(win64, kind, val_pos, vrung, cf):
        if tbits <= 16:
            g = decode_groups_fused(win64, kind, val_pos, vrung, cf, True,
                                    tbits)
        else:
            g, _ = decode_groups(win64, kind, val_pos, vrung, cf, True)
        return _finish_shard(g, nblocks_l, nbands, h_l, w, order, cband,
                             tbits, axis)

    return fn


def _shard_decode_chunked_fn(order, cband, apply_step, tbits, k_blocks,
                             nblocks_l, nbands, h_l, w, axis, ncl):
    """ic-sidecar shard decode: each shard walks the ``ncl`` chunks that
    COVER its strip (chunk anchors need not align with shard boundaries —
    the strip's first blocks may sit mid-chunk) and dynamic-slices its own
    nblocks_l block rows out of the decoded range."""
    from ..ops.decode_chunked import decode_chunked

    def fn(win64, starts_l, entry_l, blkoff):
        g = decode_chunked(win64, starts_l, entry_l, k_blocks,
                           ncl * k_blocks, nbands, apply_step, tbits)
        g = g.reshape(ncl * k_blocks, nbands, B2)
        g = jax.lax.dynamic_slice_in_dim(g, blkoff[0], nblocks_l, axis=0)
        return _finish_shard(g.reshape(nblocks_l * nbands, B2), nblocks_l,
                             nbands, h_l, w, order, cband, tbits, axis)

    return fn


@functools.lru_cache(maxsize=16)
def _sharded_decode_kernel(npdtype, order, cband, apply_step, ws64, n_dev,
                           h, w, nbands, sidecar, k_blocks=0, ncl=0):
    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"need {n_dev} devices")
    from ..constants import ubits_for
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("tiles",))
    tsize = np.dtype(npdtype).itemsize
    h_l = h // n_dev
    nblocks_l = (h_l // B) * (w // B)
    tbits = tsize * 8
    if sidecar == "ib":
        fn = _shard_decode_best_fn(order, cband, tbits, nblocks_l, nbands,
                                   h_l, w, "tiles")
        in_specs = (P("tiles"),) * 5
    elif sidecar == "ic":
        fn = _shard_decode_chunked_fn(order, cband, apply_step, tbits,
                                      k_blocks, nblocks_l, nbands, h_l, w,
                                      "tiles", ncl)
        in_specs = (P("tiles"),) * 4
    else:
        fn = _shard_decode_fn(order, cband, apply_step, ubits_for(tsize),
                              tbits, nblocks_l, nbands, h_l, w, "tiles")
        in_specs = (P("tiles"),) * 3

    def squeeze_fn(*args):
        return fn(*(a[0] for a in args))

    mapped = jax.shard_map(squeeze_fn, mesh=mesh, in_specs=in_specs,
                           out_specs=P("tiles"))
    return jax.jit(mapped), mesh


def _shard_windows(words: np.ndarray, start_bits: np.ndarray,
                   end_bits: np.ndarray, slack64: int):
    """Per-shard payload windows: (n_dev, WS) u64 + absolute bit bases."""
    n_dev = len(start_bits)
    base_w = (start_bits >> 6).astype(np.int64)
    end_w = (end_bits >> 6).astype(np.int64) + slack64
    WS = int((end_w - base_w).max()) + 2
    win = np.zeros((n_dev, WS), np.uint64)
    for s in range(n_dev):
        src = words[base_w[s]: min(base_w[s] + WS, len(words))]
        win[s, : len(src)] = src
    return win, base_w * 64


def decode_fast_sharded(stream: bytes, n_dev: int) -> np.ndarray:
    """Decode a sidecar-indexed stream with the image sharded over n_dev
    devices (block-row strips).  Supports all three sidecars: "ix"
    (FTL/BASE per-group lengths), "ib" (best-mode metadata), "ic"
    (chunk anchors).  Each device receives only the payload word window
    covering its own strip (plus register slack) — the stream is never
    replicated — and the rung/prev chains cross shard boundaries via
    all-gathered per-shard totals."""
    from .. import container
    from ..api import NP_FROM_DT, UNSIGNED, _parse_best_sidecar
    from ..constants import DType, Mode, is_best_mode
    from ..ops.decode import _NREG_IX, payload_words
    from ..ops.decode_chunked import parse_ic

    info = container.parse_headers(stream)
    h, w, nb = info.ysize, info.xsize, info.nbands
    if h % (B * n_dev) != 0 or w % B != 0:
        raise QB3ShapeError("image shape must split into whole block rows per device")
    np_dt = NP_FROM_DT[DType(info.dtype)]
    uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
    tbits = np.dtype(uns_dt).itemsize * 8
    words = payload_words(stream[info.data_offset:])
    nblocks = (h // B) * (w // B)
    nblocks_l = nblocks // n_dev
    gpd = nblocks_l * nb  # groups per device
    order = info.order or HILBERT
    slack = _NREG_IX[tbits] // 2 + 2

    if info.index_best is not None and is_best_mode(Mode(info.mode)):
        meta = _parse_best_sidecar(info.index_best, nblocks * nb)
        if meta is None:
            raise QB3ShapeError("oversized CF in ib sidecar")
        kind, val_pos, vrung, cf = meta
        start_bits = val_pos.reshape(n_dev, gpd)[:, 0] - 64  # cs bits precede
        start_bits = np.maximum(start_bits, 0)
        end_bits = np.concatenate([start_bits[1:],
                                   [len(words) * 64 - slack * 64]])
        win, winbase = _shard_windows(words, start_bits, end_bits, slack)
        lpos = (val_pos.reshape(n_dev, gpd)
                - (winbase[:, None])).astype(np.int64)
        kern, mesh = _sharded_decode_kernel(
            np.dtype(uns_dt).name, order, tuple(info.cband), True,
            win.shape[1], n_dev, h, w, nb, "ib")
        sh = NamedSharding(mesh, P("tiles"))
        out = np.asarray(kern(
            jax.device_put(jnp.asarray(win), sh),
            jax.device_put(jnp.asarray(kind.reshape(n_dev, gpd)), sh),
            jax.device_put(jnp.asarray(lpos), sh),
            jax.device_put(jnp.asarray(vrung.reshape(n_dev, gpd)), sh),
            jax.device_put(jnp.asarray(cf.reshape(n_dev, gpd)), sh)))
        return out.view(np_dt)

    if info.index_chunked is not None:
        parsed = parse_ic(info.index_chunked, nblocks, nb)
        if parsed is None:
            raise QB3ShapeError("inconsistent ic sidecar")
        k, starts, entry, _tot = parsed
        nchunks = len(starts)
        # shard s covers chunks [c0, c1): anchors need not align with the
        # strip boundary — the head blocks of a straddling chunk are
        # decoded too and sliced off in-shard (blkoff)
        sidx = np.arange(n_dev, dtype=np.int64)
        c0 = (sidx * nblocks_l) // k
        c1 = -(-((sidx + 1) * nblocks_l) // k)
        ncl = int((c1 - c0).max())
        idx = np.minimum(c0[:, None] + np.arange(ncl)[None, :], nchunks - 1)
        s2 = starts[idx]
        blkoff = (sidx * nblocks_l - c0 * k).astype(np.int32)
        start_bits = s2[:, 0]
        # the window must span through the shard's LAST chunk (it may
        # straddle into the next strip), i.e. to the next anchor after c1-1
        end_bits = np.where(c1 < nchunks,
                            starts[np.minimum(c1, nchunks - 1)], _tot)
        win, winbase = _shard_windows(words, start_bits, end_bits, slack)
        lstarts = (s2 - winbase[:, None]).astype(np.int32)
        kern, mesh = _sharded_decode_kernel(
            np.dtype(uns_dt).name, order, tuple(info.cband),
            info.mode != Mode.FTL, win.shape[1], n_dev, h, w, nb, "ic", k, ncl)
        sh = NamedSharding(mesh, P("tiles"))
        out = np.asarray(kern(
            jax.device_put(jnp.asarray(win), sh),
            jax.device_put(jnp.asarray(lstarts), sh),
            jax.device_put(jnp.asarray(entry[idx]), sh),
            jax.device_put(jnp.asarray(blkoff.reshape(n_dev, 1)), sh)))
        return out.view(np_dt)

    if info.index is None or info.mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z):
        raise QB3ShapeError("sharded decode needs an ix/ib/ic-indexed stream")
    glens = np.frombuffer(info.index, dtype="<u2").astype(np.int32)
    bits = np.cumsum(glens.astype(np.int64))
    start_bits = np.concatenate([[0], bits[gpd - 1::gpd][:-1]])
    end_bits = bits[gpd - 1::gpd]
    win, winbase = _shard_windows(words, start_bits, end_bits, slack)
    kern, mesh = _sharded_decode_kernel(
        np.dtype(uns_dt).name, order, tuple(info.cband),
        info.mode != Mode.FTL, win.shape[1], n_dev, h, w, nb, "ix")
    sh = NamedSharding(mesh, P("tiles"))
    out = np.asarray(kern(
        jax.device_put(jnp.asarray(win), sh),
        jax.device_put(jnp.asarray(glens.reshape(n_dev, gpd)), sh),
        jax.device_put(jnp.asarray(winbase.reshape(n_dev, 1)), sh)))
    return out.view(np_dt)


def stitch_streams(words: np.ndarray, totals: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Concatenate per-shard bitstreams at bit granularity (vectorized u64
    shift/OR passes, stitch.py — not a Python bigint loop).

    words: (n_shards, n_words) uint32; totals: (n_shards,) bit lengths.
    """
    from ..stitch import stitch_bytes

    return stitch_bytes(
        (words[s], int(totals[s])) for s in range(words.shape[0])), totals
