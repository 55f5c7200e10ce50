"""Unit tests of binning's building blocks and the rasterizer backends.

The binning/render suites cover these end to end; these pin the contracts
in isolation: the slot expansion against numpy.repeat, the tile sort
against numpy.lexsort (ties, duplicate and mega-duplicate runs), the packed
sort-payload format, and the per-Gaussian gradient sums of the Pallas
backward (interpret mode) against the plain XLA reference rasterizer.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gsplat_jax.kernels.packing import (
    pack_bf16_pair, pack_f16_pair, pack_rgb_e5, unpack_bf16_pair,
    unpack_f16_pair, unpack_rgb_e5,
)
from gsplat_jax.ops.binning import segment_ids, tile_sort


def _counts_offsets(rng, n, max_count=7, zero_tail=2):
    # Every record owns >= 1 slot except a zero-count tail (binning's
    # level-2 layout: rows past the valid total own no candidate).
    counts = rng.integers(1, max_count, n).astype(np.int32)
    counts[np.sort(rng.choice(n - 2, 3, replace=False))] += 11
    if zero_tail:
        counts[-zero_tail:] = 0
    off = np.cumsum(counts) - counts
    return counts, off.astype(np.int32), int(counts.sum())


def _expand(vals, off, cap):
    ids = segment_ids(jnp.asarray(off), cap)
    return np.asarray(jnp.asarray(vals)[:, ids]), np.asarray(ids)


def test_segment_expand_matches_numpy_repeat(rng):
    n, s_cap = 1900, 4096
    counts, off, total = _counts_offsets(rng, n, max_count=2, zero_tail=0)
    vals = rng.standard_normal((3, n)).astype(np.float32)
    out, ids = _expand(vals, off, s_cap)
    np.testing.assert_array_equal(out[:, :total],
                                  np.repeat(vals, counts, axis=1))
    # Slots past the total belong to the last record.
    assert (ids[total:] == n - 1).all()


def test_segment_expand_dual_dtype(rng):
    # f32 and bf16 columns gathered by the same slot owners, with a
    # zero-count tail whose records own no slot.
    n, s_cap = 300, 2048
    counts, off, total = _counts_offsets(rng, n)
    vals = rng.standard_normal((2, n)).astype(np.float32)
    side = jnp.asarray(rng.standard_normal((5, n)), jnp.bfloat16)
    out, ids = _expand(vals, off, s_cap)
    out_b = jnp.asarray(side)[:, ids]
    np.testing.assert_array_equal(out[:, :total],
                                  np.repeat(vals, counts, axis=1))
    assert out_b.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(out_b.astype(jnp.float32))[:, :total],
        np.repeat(np.asarray(side.astype(jnp.float32)), counts, axis=1),
    )
    assert (ids[total:] == n - 1).all()


def test_payload_words_roundtrip(rng):
    a, b = (rng.standard_normal(4096).astype(np.float32) * 10
            for _ in range(2))
    hi, lo = unpack_bf16_pair(pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        np.asarray(hi), np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                   .astype(jnp.float32)))
    np.testing.assert_array_equal(
        np.asarray(lo), np.asarray(jnp.asarray(b).astype(jnp.bfloat16)
                                   .astype(jnp.float32)))
    # f16 tile-relative positions: exact for f16-representable values.
    u = np.round(rng.uniform(-300, 300, 4096) * 64) / 64
    v = np.round(rng.uniform(-300, 300, 4096) * 64) / 64
    fu, fv = unpack_f16_pair(pack_f16_pair(jnp.asarray(u, jnp.float32),
                                           jnp.asarray(v, jnp.float32)))
    np.testing.assert_array_equal(np.asarray(fu), u.astype(np.float16))
    np.testing.assert_array_equal(np.asarray(fv), v.astype(np.float16))
    # Packing unpacked values again is bit-stable (idempotent).
    w = pack_bf16_pair(hi, lo)
    np.testing.assert_array_equal(
        np.asarray(pack_bf16_pair(*unpack_bf16_pair(w))), np.asarray(w))


def test_rgb_e5_skewed_channels(rng):
    # e5s9 shares one exponent across r/g/b: every channel's error is
    # bounded by the LARGEST channel's amax/256, so a 1e4x smaller sibling
    # may lose all its relative precision.
    p = 4096
    rgb = np.stack([rng.standard_normal(p),
                    rng.standard_normal(p) * 1e-4,
                    rng.uniform(0, 1, p)]).astype(np.float32)
    back = np.asarray(jnp.stack(unpack_rgb_e5(
        pack_rgb_e5(*(jnp.asarray(c) for c in rgb)))))
    amax = np.abs(rgb).max(axis=0)
    assert (np.abs(back - rgb) <= amax / 256 + 1e-12).all()
    word = pack_rgb_e5(*(jnp.asarray(c) for c in back))
    np.testing.assert_array_equal(
        np.asarray(jnp.stack(unpack_rgb_e5(word))), back)


def _sort_case(rng, case):
    n = 8192
    if case == "heavy_ties":  # many equal keys, unique (key, gid)
        key = rng.integers(0, 1 << 6, n)
        gid = rng.permutation(n)
    elif case == "wide_keys":
        key = rng.integers(0, 1 << 28, n)
        gid = rng.integers(0, 1 << 20, n)
    elif case == "clustered_tail":  # tile-coherent keys + invalid tail
        base = np.repeat(rng.integers(0, 1 << 10, 16), n // 16)
        key = base * 1024 + rng.integers(0, 1 << 10, n)
        key[-1000:] = 1 << 24
        gid = rng.permutation(n)
    elif case == "duplicate_keys":  # one key per Gaussian run, ids differ
        key = rng.integers(0, 500, n)
        gid = np.arange(n)
    else:  # "mega_duplicate": 75% identical (key, gid) sentinel tuples
        key = rng.integers(0, 1 << 20, n)
        gid = rng.integers(0, 1 << 20, n)
        key[n // 4:] = 1 << 24
        gid[n // 4:] = 1 << 23
    return key.astype(np.int32), gid.astype(np.int32)


@pytest.mark.parametrize("case", ["heavy_ties", "wide_keys", "clustered_tail",
                                  "duplicate_keys", "mega_duplicate"])
def test_tile_sort_matches_lexsort(rng, case):
    key, gid = _sort_case(rng, case)
    pay = np.arange(key.size, dtype=np.int32)
    ks, gs, ps = (np.asarray(x) for x in tile_sort(
        jnp.asarray(key), jnp.asarray(gid), (jnp.asarray(pay),)))
    order = np.lexsort((gid, key))
    np.testing.assert_array_equal(ks, key[order])
    np.testing.assert_array_equal(gs, gid[order])
    # The payload follows its element: exactly where (key, gid) is
    # unique, as a multiset inside duplicate runs.
    np.testing.assert_array_equal(np.sort(ps), pay)
    np.testing.assert_array_equal(key[ps], ks)
    np.testing.assert_array_equal(gid[ps], gs)


def _stream_scene(rng, packed):
    from gsplat_jax.ops.binning import build_tile_tables
    from gsplat_jax.ops.render import pack_attrs
    from test_render import TILE, _make_scene

    width, height, n = 48, 32, 60
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    attrs = pack_attrs(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
                       jnp.asarray(opa))
    tables = build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.ones(n, bool), attrs=attrs, num_tiles_x=width // TILE,
        num_tiles_y=height // TILE, tile_size=TILE, pair_cap=4096,
        bf16_colors=packed,
    )
    return tables, n, width // TILE, (width // TILE) * (height // TILE)


def _backward_both(rng, packed, bg, k, interpret=True):
    """Per-Gaussian gradient sums of the Pallas backward (interpret mode,
    or compiled on the card) and of the plain reference on the same
    forward output and cotangent."""
    from gsplat_jax.kernels import rasterize as kern
    from gsplat_jax.ops import raster_ref

    tables, n, ntx, nt = _stream_scene(rng, packed)
    geom = dict(num_tiles_x=ntx, num_tiles=nt, tile=16, k=k)
    args = (tables.stream, tables.tile_start, tables.tile_count,
            jnp.float32(bg))
    out = kern.rasterize_forward(*args, **geom, interpret=interpret)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(raster_ref.raster_forward_ref(*args,
                                                                  **geom)),
        rtol=1e-5, atol=1e-6)
    di = jnp.asarray(rng.standard_normal((nt, 3, 256)).astype(np.float32))
    tfin = out[:, 3:4]
    pix = jnp.concatenate([
        di, tfin, out[:, 4:5], bg * jnp.sum(di, 1, keepdims=True),
        jnp.sum(di * (out[:, 0:3] - tfin * bg), 1, keepdims=True),
        jnp.zeros_like(tfin)], axis=1)
    bargs = (tables.stream, tables.splat_gid, pix, tables.tile_start,
             tables.tile_count, n)
    g_kernel = kern.rasterize_backward(*bargs, **geom, grad_scale=(24., 16.),
                                       interpret=interpret)
    g_ref = raster_ref.raster_backward_ref(*bargs, **geom,
                                           grad_scale=(24., 16.))
    return np.asarray(g_kernel), np.asarray(g_ref)


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_segment_sum_by_gid_f32_and_packed(rng, packed):
    # Per-Gaussian sums accumulated by Gaussian id (per-pair rows then a
    # segment sum for the kernel, a scatter-add in the reference) over both
    # stream forms.
    g_kernel, g_ref = _backward_both(rng, packed, bg=0.0, k=16)
    assert np.abs(g_ref).max() > 0
    scale = np.abs(g_ref).max(axis=0) + 1e-12
    np.testing.assert_allclose(g_kernel / scale, g_ref / scale, atol=2e-5)


def test_segment_sum_by_gid_multi_chunk(rng):
    # Chunks of 4 splats: every tile's range spans many chunks, so the
    # carried transmittance and colour prefix cross chunk boundaries.
    g_kernel, g_ref = _backward_both(rng, True, bg=0.6, k=4)
    scale = np.abs(g_ref).max(axis=0) + 1e-12
    np.testing.assert_allclose(g_kernel / scale, g_ref / scale, atol=2e-5)


@pytest.mark.gpu
def test_compiled_kernels_match_reference(gpu, rng):
    # The Triton-compiled kernels on the card, at the default chunk.
    g_kernel, g_ref = _backward_both(rng, True, bg=0.2, k=32, interpret=False)
    scale = np.abs(g_ref).max(axis=0) + 1e-12
    np.testing.assert_allclose(g_kernel / scale, g_ref / scale, atol=2e-5)
