"""Rasterizer parity tests: Pallas kernels (interpret mode) vs numpy oracle.

The oracle (gsplat_jax.ops.oracle) is a line-by-line transcription of the
reference CUDA compositing semantics; these tests gate the Pallas kernels'
forward images, T_final / splats-per-pixel bookkeeping, and all five backward
gradient families against it, and the binning tables against brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_jax.ops import oracle
from gsplat_jax.ops.binning import TileTables, build_tile_tables
from gsplat_jax.ops.render import rasterize

TILE = 16
CHUNK = 16  # small, so tiles span several chunks


def _make_scene(rng, n, width, height, opa_range=(-2.0, 3.0)):
    uv = rng.uniform([-5, -5], [width + 5, height + 5], size=(n, 2))
    theta = rng.uniform(0, np.pi, size=n)
    s1 = rng.uniform(1.5, 8.0, size=n)
    s2 = rng.uniform(1.5, 8.0, size=n)
    c, s = np.cos(theta), np.sin(theta)
    # cov = R diag(s1^2, s2^2) R^T  (+0.3 dilation as in the pipeline)
    cov00 = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
    cov01 = c * s * (s1 ** 2 - s2 ** 2)
    cov11 = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
    det = cov00 * cov11 - cov01 ** 2
    conic = np.stack([cov11 / det, -cov01 / det, cov00 / det], axis=1)
    # radius record like gaussian.cu:161-174
    mid = 0.5 * (cov00 + cov11)
    lam_t = np.sqrt(np.maximum(0.1, mid * mid - det))
    r_major = np.ceil(3.0 * np.sqrt(mid + lam_t))
    r_minor = np.ceil(3.0 * np.sqrt(np.maximum(mid - lam_t, 0)))
    ang = 0.5 * np.arctan2(2 * cov01, cov00 - cov11)
    radius = np.stack([r_major, r_minor, np.sin(ang), np.cos(ang)], axis=1)
    z = rng.uniform(0.5, 20.0, size=n)
    opacity = rng.uniform(*opa_range, size=n)
    rgb = rng.uniform(0, 1, size=(n, 3))
    return (
        uv.astype(np.float32), conic.astype(np.float32),
        radius.astype(np.float32), z.astype(np.float32),
        opacity.astype(np.float32), rgb.astype(np.float32),
    )


def _tables(uv, z, radius, mask, width, height, conic, opa, rgb,
            pair_cap=4096):
    from gsplat_jax.ops.render import pack_attrs

    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    attrs = pack_attrs(
        jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
        jnp.asarray(opa),
    )
    return build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.asarray(mask), attrs=attrs,
        num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
        pair_cap=pair_cap,
        bf16_colors=False,  # exact f32 for oracle-parity comparisons
    ), ntx, nty


def _oracle_lists(tables: TileTables, num_tiles):
    gid = np.asarray(tables.splat_gid)
    start = np.asarray(tables.tile_start)
    count = np.asarray(tables.tile_count)
    return [
        [int(g) for g in gid[start[t] : start[t] + count[t]]]
        for t in range(num_tiles)
    ]


def test_binning_membership_and_depth_order(rng):
    width = height = 64
    uv, conic, radius, z, opa, rgb = _make_scene(rng, 30, width, height)
    mask = np.ones(30, bool)
    tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    lists = _oracle_lists(tables, ntx * nty)

    # Each tile's list must be sorted by ascending depth.
    for t, lst in enumerate(lists):
        zs = z[lst]
        assert np.all(np.diff(zs) >= 0), f"tile {t} not depth sorted"

    # Membership must equal the brute-force SAT test over all pairs.
    from gsplat_jax.ops.binning import obb_tile_intersects, tile_spans

    tx0, ty0, nx, ny, counts = map(
        np.asarray,
        tile_spans(jnp.asarray(uv), jnp.asarray(radius), jnp.asarray(mask),
                   ntx, nty, TILE),
    )
    # Vectorized brute force over the full (gaussian, tile) grid.
    n, t_total = 30, ntx * nty
    tx = np.arange(t_total) % ntx
    ty = np.arange(t_total) // ntx
    gg, tt = np.meshgrid(np.arange(n), np.arange(t_total), indexing="ij")
    # extent=TILE-1: the product binning tests the PIXEL rect (centers at
    # integer offsets 0..15) — value-exact and tighter than the full rect.
    hits = np.asarray(
        obb_tile_intersects(
            jnp.asarray(uv[gg.ravel(), 0]), jnp.asarray(uv[gg.ravel(), 1]),
            jnp.asarray(radius[gg.ravel()]),
            jnp.asarray(tx[tt.ravel()]), jnp.asarray(ty[tt.ravel()]), TILE,
            extent=TILE - 1.0,
        )
    ).reshape(n, t_total)
    in_span = (
        (tx0[:, None] <= tx[None, :]) & (tx[None, :] < tx0[:, None] + nx[:, None])
        & (ty0[:, None] <= ty[None, :]) & (ty[None, :] < ty0[:, None] + ny[:, None])
    )
    expected_grid = hits & in_span
    for t in range(t_total):
        expected = set(np.nonzero(expected_grid[:, t])[0].tolist())
        assert set(lists[t]) == expected, f"tile {t} membership mismatch"


def test_binning_mask_and_overflow(rng):
    width = height = 32
    uv, conic, radius, z, opa, rgb = _make_scene(rng, 10, width, height)
    mask = np.zeros(10, bool)
    mask[::2] = True
    tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    lists = _oracle_lists(tables, ntx * nty)
    present = {g for lst in lists for g in lst}
    assert present.issubset(set(range(0, 10, 2)))
    # tile ranges partition [0, num_pairs) (pair slot == sorted slot)
    starts = np.asarray(tables.tile_start)
    counts = np.asarray(tables.tile_count)
    assert starts[0] == 0
    assert np.all(starts[1:] == starts[:-1] + counts[:-1])
    assert starts[-1] + counts[-1] == int(tables.num_pairs)
    # overflow reports a usable capacity estimate
    assert int(tables.overflow) >= int(tables.num_pairs)


def _render_kw(impl):
    # The Pallas kernels in interpret mode, or the plain XLA reference.
    if impl == "kernel":
        return dict(interpret=True)
    return dict(impl="reference")


@pytest.mark.parametrize("bg", [0.0, 0.6])
def test_forward_matches_oracle(rng, bg):
    _check_forward(rng, bg, "kernel")


@pytest.mark.parametrize("bg", [0.0, 0.6])
def test_reference_forward_matches_oracle(rng, bg):
    _check_forward(rng, bg, "reference")


def _check_forward(rng, bg, impl):
    width, height = 48, 32
    n = 40
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    lists = _oracle_lists(tables, ntx * nty)

    out = rasterize(
        jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
        jnp.asarray(opa), tables, jnp.float32(bg),
        width=width, height=height, tile=TILE, chunk=CHUNK,
        **_render_kw(impl),
    )
    ref_img, ref_t, ref_n = oracle.oracle_render_forward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg
    )
    np.testing.assert_allclose(np.asarray(out.image), ref_img,
                               rtol=2e-4, atol=2e-5)
    # padded-tile layout -> crop T_final / n_splats for comparison
    tfin = np.asarray(out.t_final).reshape(nty, ntx, TILE, TILE)
    tfin = tfin.transpose(0, 2, 1, 3).reshape(nty * TILE, ntx * TILE)
    nspl = np.asarray(out.n_splats).reshape(nty, ntx, TILE, TILE)
    nspl = nspl.transpose(0, 2, 1, 3).reshape(nty * TILE, ntx * TILE)
    # T accumulates via log-space scans (kernel) or chunked prefix products
    # (reference) vs sequential products (oracle): fp32 rounding differs.
    np.testing.assert_allclose(tfin[:height, :width], ref_t, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_array_equal(
        nspl[:height, :width].astype(np.int32), ref_n
    )


def test_backward_matches_oracle(rng):
    _check_backward(rng, "kernel")


def test_reference_backward_matches_oracle(rng):
    _check_backward(rng, "reference")


def test_backward_uv_scale_is_the_image_size(rng):
    # 24 px is 1.5 tile rows: the v-gradient scale is 0.5 * 24 (the
    # image), not 0.5 * 32 (the tile grid), as in the reference and the
    # tile-sharded step.
    _check_backward(rng, "kernel", width=40, height=24)


def _check_backward(rng, impl, width=32, height=16):
    n = 16
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    lists = _oracle_lists(tables, ntx * nty)
    bg = 0.4
    grad_image = rng.normal(size=(height, width, 3)).astype(np.float32)

    def loss_fn(uv_, conic_, rgb_, opa_):
        out = rasterize(
            uv_, conic_, rgb_, opa_, tables, jnp.float32(bg),
            width=width, height=height, tile=TILE, chunk=CHUNK,
            **_render_kw(impl),
        )
        return jnp.sum(out.image * grad_image)

    g_uv, g_conic, g_rgb, g_opa = jax.grad(loss_fn, argnums=(0, 1, 2, 3))(
        jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb), jnp.asarray(opa)
    )

    ref_img, ref_t, ref_n = oracle.oracle_render_forward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg
    )
    o_rgb, o_opa, o_uv, o_conic = oracle.oracle_render_backward(
        uv, opa, conic, rgb, lists, width, height, TILE, bg,
        ref_t, ref_n, grad_image, n,
    )
    np.testing.assert_allclose(np.asarray(g_rgb), o_rgb, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g_opa), o_opa, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g_uv), o_uv, rtol=2e-3, atol=3e-3)
    np.testing.assert_allclose(np.asarray(g_conic), o_conic, rtol=2e-3,
                               atol=3e-3)


def test_forward_early_termination_and_saturation(rng):
    """Stack many opaque gaussians on one spot: T must freeze below 1e-4."""
    width = height = 16
    n = 64
    uv = np.full((n, 2), 8.0, np.float32) + rng.normal(size=(n, 2)) * 0.5
    conic = np.tile(np.array([[0.5, 0.0, 0.5]], np.float32), (n, 1))
    radius = np.tile(np.array([[6.0, 6.0, 0.0, 1.0]], np.float32), (n, 1))
    z = np.arange(1, n + 1, dtype=np.float32)
    opa = np.full((n,), 4.0, np.float32)  # sigmoid ~ 0.982
    rgb = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    tables, ntx, nty = _tables(uv, z, radius, mask, width, height, conic, opa, rgb)
    lists = _oracle_lists(tables, ntx * nty)

    out = rasterize(
        jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
        jnp.asarray(opa), tables, jnp.float32(1.0),
        width=width, height=height, tile=TILE, chunk=CHUNK, interpret=True,
    )
    ref_img, ref_t, ref_n = oracle.oracle_render_forward(
        uv, opa, conic, rgb, lists, width, height, TILE, 1.0
    )
    np.testing.assert_allclose(np.asarray(out.image), ref_img, rtol=3e-4,
                               atol=3e-5)
    # early-exit: center pixels saw far fewer than n splats
    assert ref_n[8, 8] < n
    nspl = np.asarray(out.n_splats).reshape(nty, ntx, TILE, TILE)[0, 0]
    np.testing.assert_array_equal(nspl.astype(np.int32), ref_n)


def test_opacity_aware_radius_is_pixel_exact(rng):
    """Tightening the binning radius to the alpha=1/255 isocontour must not
    change the rendered image: the kernel skips sub-cutoff contributions."""
    import jax

    from gsplat_jax.ops.covariance import conic_and_radius, sigma_from_quat_scale

    width = height = 64
    n = 60
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.05, 0.3, (n, 3))).astype(np.float32)
    xyz_c = rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3)).astype(np.float32)
    opa = rng.uniform(-4.0, 0.5, n).astype(np.float32)  # mostly low opacity
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    view = jnp.eye(4, dtype=jnp.float32)

    from gsplat_jax.ops import projection

    jac = projection.projection_jacobian(
        jnp.asarray(xyz_c), 50.0, 50.0, 1.0, 1.0
    )
    sigma = sigma_from_quat_scale(jnp.asarray(quat), jnp.asarray(scale))
    uv = np.asarray(
        projection.project_to_screen(
            jnp.asarray(xyz_c),
            jnp.asarray(np.diag([1.0, 1, 1, 1]).astype(np.float32)),
            width, height,
        )
    )
    uv = rng.uniform(0, [width, height], (n, 2)).astype(np.float32)
    z = xyz_c[:, 2]
    mask = np.ones(n, bool)

    conic, rad_plain = conic_and_radius(sigma, jac, view, 3.0)
    _, rad_tight = conic_and_radius(
        sigma, jac, view, 3.0, opacity_logit=jnp.asarray(opa)
    )
    # the tightening must actually do something for this low-opacity scene
    assert float(jnp.sum(rad_tight[:, 0])) < float(jnp.sum(rad_plain[:, 0]))

    imgs = []
    for rad in (rad_plain, rad_tight):
        tables, ntx, nty = _tables(
            uv, z, np.asarray(rad), mask, width, height,
            np.asarray(conic), opa, rgb,
        )
        out = rasterize(
            jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
            jnp.asarray(opa), tables, jnp.float32(0.2),
            width=width, height=height, tile=TILE, chunk=CHUNK,
            interpret=True,
        )
        imgs.append(np.asarray(out.image))
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-6)

def test_ellipse_cut_is_pixel_exact_and_subset(rng):
    """The elliptical pair cut (radius col 4 = ell_scale) must (a) produce
    a SUBSET of the pure-OBB pair set, (b) keep every pair with any pixel
    above the 1/255 alpha cutoff, and (c) leave the rendered image and
    T_final bit-identical (dropped pairs have zero contribution)."""
    from gsplat_jax.kernels.rasterize import ALPHA_CUTOFF
    from gsplat_jax.ops.covariance import (
        conic_and_radius, sigma_from_quat_scale,
    )
    from gsplat_jax.ops import projection

    width = height = 64
    n = 80
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.05, 0.4, (n, 3))).astype(np.float32)
    xyz_c = rng.uniform([-2, -2, 2], [2, 2, 8], (n, 3)).astype(np.float32)
    opa = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    view = jnp.eye(4, dtype=jnp.float32)
    jac = projection.projection_jacobian(
        jnp.asarray(xyz_c), 50.0, 50.0, 1.0, 1.0
    )
    sigma = sigma_from_quat_scale(jnp.asarray(quat), jnp.asarray(scale))
    uv = rng.uniform(0, [width, height], (n, 2)).astype(np.float32)
    z = xyz_c[:, 2]
    mask = np.ones(n, bool)
    conic, rad = conic_and_radius(
        sigma, jac, view, 3.0, opacity_logit=jnp.asarray(opa)
    )
    rad = np.asarray(rad)
    assert rad.shape[1] == 5 and (rad[:, 4] >= 1.0).all()
    rad_obb = rad[:, :4]  # (N, 4): ellipse disabled, pure OBB

    outs = []
    lists = []
    for r in (rad_obb, rad):
        tables, ntx, nty = _tables(
            uv, z, r, mask, width, height, np.asarray(conic), opa, rgb
        )
        out = rasterize(
            jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
            jnp.asarray(opa), tables, jnp.float32(0.2),
            width=width, height=height, tile=TILE, chunk=CHUNK,
            interpret=True,
        )
        outs.append(out)
        lists.append(_oracle_lists(tables, ntx * nty))

    # (c) value-identical image and T_final. Not BIT-identical: dropping a
    # zero-contribution pair shifts later pairs' lane positions, changing
    # the f32 summation grouping of the deferred (PIX, K) partials by a
    # few ulps (measured max 1.2e-7).
    np.testing.assert_allclose(
        np.asarray(outs[0].image), np.asarray(outs[1].image), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(outs[0].t_final), np.asarray(outs[1].t_final), atol=1e-5
    )

    conic_np = np.asarray(conic)
    sig = 1.0 / (1.0 + np.exp(-opa))
    dropped = kept = 0
    for t in range(ntx * nty):
        obb_set, ell_set = set(lists[0][t]), set(lists[1][t])
        assert ell_set <= obb_set, f"tile {t}: ellipse added pairs"
        dropped += len(obb_set - ell_set)
        kept += len(ell_set)
        # (b) safety: every dropped pair must have max pixel alpha below
        # the cutoff (checked on the tile's 16x16 pixel centers).
        tx, ty = t % ntx, t // ntx
        px, py = np.meshgrid(
            tx * TILE + np.arange(TILE), ty * TILE + np.arange(TILE)
        )
        for g in obb_set - ell_set:
            dx = uv[g, 0] - px
            dy = uv[g, 1] - py
            q = (conic_np[g, 0] * dx * dx + 2 * conic_np[g, 1] * dx * dy
                 + conic_np[g, 2] * dy * dy)
            amax = sig[g] * np.exp(np.minimum(0.0, -0.5 * q)).max()
            assert amax <= ALPHA_CUTOFF + 1e-6, (t, g, amax)
    # the cut must actually remove something on this scene
    assert dropped > 0, (dropped, kept)


def test_bf16_packed_path_close_to_exact(rng):
    """The default packed sort payloads (bf16 conic/color/opacity, f16
    tile-relative positions) must render within rounding distance of the
    exact-f32 path, forward AND backward — the only quantitative gate on
    the shipping (packed) configuration, so it also catches any
    reconstruction bug (wrong tile origin, inf/NaN leaking from the
    invalid tail) that the exact-path oracle tests cannot see."""
    from gsplat_jax.ops.render import pack_attrs

    width, height = 96, 64
    n = 180
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    mask = np.ones(n, bool)
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE

    outs = {}
    for packed in (False, True):
        attrs = pack_attrs(
            jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
            jnp.asarray(opa),
        )
        tables = build_tile_tables(
            jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
            jnp.asarray(mask), attrs=attrs,
            num_tiles_x=ntx, num_tiles_y=nty, tile_size=TILE,
            pair_cap=4096, bf16_colors=packed,
        )

        def loss_fn(uv_, conic_, rgb_, opa_, tb=tables):
            out = rasterize(
                uv_, conic_, rgb_, opa_, tb, jnp.float32(0.2),
                width=width, height=height, tile=TILE, chunk=CHUNK,
                interpret=True,
            )
            return jnp.sum(out.image ** 2), out.image

        (_, img), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2, 3), has_aux=True
        )(jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
          jnp.asarray(opa))
        outs[packed] = (np.asarray(img), [np.asarray(g) for g in grads])

    img_exact, g_exact = outs[False]
    img_packed, g_packed = outs[True]
    assert np.isfinite(img_packed).all()
    for g in g_packed:
        assert np.isfinite(g).all()
    # bf16 color/opacity rounding is ~0.4% relative; compositing of a few
    # hundred overlapping splats stays within a few 1e-2 absolute.
    np.testing.assert_allclose(img_packed, img_exact, atol=0.03)
    # PSNR-grade gate: elementwise tolerances pass on a biased-but-small
    # error too, so also require rounding-NOISE quality overall — any
    # systematic bias from the bf16/f16 packing chain would sink this first.
    mse = float(np.mean((img_packed - img_exact) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 45.0, f"packed-vs-exact PSNR {psnr:.1f} dB"
    # Gradients: identical structure, rounding-scale elementwise error.
    for gp, ge in zip(g_packed, g_exact):
        scale = np.abs(ge).max() + 1e-6
        np.testing.assert_allclose(gp / scale, ge / scale, atol=0.05)


def test_depth_rank_exact_ordering(rng):
    """The exact depth-rank fallback mode must produce the SAME pair set
    as the default log-bucket mode, with each tile's splats EXACTLY
    z-ascending (the reference's f32 ordering, culling.cu:294-298)."""
    from gsplat_jax.ops.binning import build_tile_tables
    from gsplat_jax.ops.render import pack_attrs

    width = height = 64
    n = 150
    uv, conic, radius, z, opa, rgb = _make_scene(rng, n, width, height)
    # Force depth ties in the default quantized mode: many identical z.
    z[: n // 2] = z[0]
    mask = np.ones(n, bool)
    attrs = pack_attrs(
        jnp.asarray(uv), jnp.asarray(conic), jnp.asarray(rgb),
        jnp.asarray(opa),
    )
    order = np.argsort(z, kind="stable")
    rank = np.zeros(n, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    kwargs = dict(
        num_tiles_x=4, num_tiles_y=4, tile_size=TILE,
        pair_cap=2048, row_cap=1024,
    )
    tq = build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.asarray(mask), attrs=attrs, **kwargs,
    )
    te = build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.asarray(mask), attrs=attrs, depth_rank=jnp.asarray(rank),
        **kwargs,
    )
    # Same pair multiset per tile.
    assert int(tq.num_pairs) == int(te.num_pairs)
    np.testing.assert_array_equal(
        np.asarray(tq.tile_start), np.asarray(te.tile_start)
    )
    np.testing.assert_array_equal(
        np.asarray(tq.tile_count), np.asarray(te.tile_count)
    )
    gid_q, gid_e = np.asarray(tq.splat_gid), np.asarray(te.splat_gid)
    ts, tc = np.asarray(te.tile_start), np.asarray(te.tile_count)
    for t in range(16):
        seg_e = gid_e[ts[t] : ts[t] + tc[t]]
        seg_q = gid_q[ts[t] : ts[t] + tc[t]]
        assert sorted(seg_e) == sorted(seg_q)
        # Exact mode: z strictly nondecreasing within the tile, with the
        # stable rank as the tiebreak (so the order is fully determined).
        np.testing.assert_array_equal(
            seg_e, sorted(seg_e, key=lambda g: rank[g])
        )


def test_binning_pair_slots_beyond_2_24():
    """Pair slots past 2^24 (where f32 stops representing integers) are
    plain int32 indices: 256 full-screen Gaussians on a 4096x4096 image
    make 256 x 65536 = 2^24 pairs, so the last tiles' pairs sit at slots
    above 2^24 of a pair cap of 2^24 + 2048."""
    from gsplat_jax.ops.render import pack_attrs

    n, size = 256, 4096
    ntx = nty = size // TILE
    uv = np.full((n, 2), size / 2, np.float32)
    radius = np.tile(np.array([[1.0e4, 1.0e4, 0.0, 1.0, 2.0]], np.float32),
                     (n, 1))
    z = np.linspace(1.0, 50.0, n).astype(np.float32)
    conic = np.tile(np.array([[1e-8, 0.0, 1e-8]], np.float32), (n, 1))
    attrs = pack_attrs(jnp.asarray(uv), jnp.asarray(conic),
                       jnp.zeros((n, 3)), jnp.zeros((n,)))
    cap = (1 << 24) + 2048
    t = build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.ones(n, bool), attrs=attrs, num_tiles_x=ntx, num_tiles_y=nty,
        tile_size=TILE, pair_cap=cap, row_cap=n * nty + 512,
    )
    assert int(t.num_pairs) == n * ntx * nty == 1 << 24
    assert int(t.overflow) <= cap
    count = np.asarray(t.tile_count)
    start = np.asarray(t.tile_start)
    assert (count == n).all()
    np.testing.assert_array_equal(start, np.arange(ntx * nty) * n)
    gid = np.asarray(t.splat_gid)
    # Every tile holds all Gaussians in depth (== id) order, including the
    # last tile, whose slots lie above 2^24.
    np.testing.assert_array_equal(
        gid[: 1 << 24].reshape(ntx * nty, n), np.tile(np.arange(n), (ntx * nty, 1))
    )
    assert (gid[1 << 24:] == -1).all()
