"""Plain jnp/lax tile rasterizer, forward and backward.

The same contract as the Pallas kernels (``kernels/rasterize.py``) and the
same compositing and gradient semantics as the numpy oracle
(``ops/oracle.py``), written as XLA ops: vectorised over all tiles, with a
``lax.while_loop`` over K-splat chunks that runs until every tile's range
is walked or every pixel has stopped. Transmittances are linear-space
prefix products (``lax.cumprod``) and the per-Gaussian gradient sums are
a scatter-add.

It serves as the XLA baseline the kernels are timed against, as the
reference they are compared with at real widths (``chip_smoke.py``), and
as the implementation when a caller asks for it explicitly
(``rasterize(..., impl="reference")``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..kernels.rasterize import ALPHA_CUTOFF, ALPHA_MAX, OUT_ROWS, T_EPS


def _pixel_coords(num_tiles: int, num_tiles_x: int, tile: int):
    """(T, PIX, 1) global pixel centres of every tile."""
    t = jnp.arange(num_tiles, dtype=jnp.int32)[:, None]
    p = jnp.arange(tile * tile, dtype=jnp.int32)[None, :]
    px = (t % num_tiles_x) * tile + p % tile
    py = (t // num_tiles_x) * tile + p // tile
    return (px.astype(jnp.float32)[..., None],
            py.astype(jnp.float32)[..., None])


def _chunk(stream, tile_start, tile_end, j, k: int):
    """Rows (9, T, 1, K) of every tile's chunk ``j`` and its (T, 1, K) mask."""
    slots = tile_start[:, None] + j * k + jnp.arange(k, dtype=jnp.int32)
    real = slots < tile_end[:, None]
    idx = jnp.clip(slots, 0, stream.shape[1] - 1)
    rows = jnp.take(stream, idx, axis=1)[:, :, None, :]
    return rows, real[:, None, :], idx


def _alpha(rows, px, py):
    u, v, c00, c01, c11, opa = rows[:6]
    dx = u - px
    dy = v - py
    power = -0.5 * (c00 * dx * dx + 2.0 * c01 * dx * dy + c11 * dy * dy)
    gval = jnp.exp(jnp.minimum(power, 0.0))
    alpha = jnp.minimum(opa * gval, ALPHA_MAX)
    alpha = jnp.where(alpha > ALPHA_CUTOFF, alpha, 0.0)
    return dx, dy, gval, alpha


def _transmittance(tcar, alpha):
    """T before and after each splat of a chunk, from T at chunk entry."""
    incl = jax.lax.cumprod(1.0 - alpha, axis=2)
    excl = jnp.concatenate([jnp.ones_like(incl[..., :1]), incl[..., :-1]],
                           axis=2)
    return tcar[..., None] * excl, tcar[..., None] * incl


def raster_forward_ref(stream, tile_start, tile_count, bg, *,
                       num_tiles_x: int, num_tiles: int, tile: int, k: int):
    """(T, 8, PIX) tile pixels [r g b T_final n_splats 0 0 0]."""
    pix = tile * tile
    px, py = _pixel_coords(num_tiles, num_tiles_x, tile)
    tile_end = tile_start + tile_count
    n_chunks = (jnp.max(tile_count) + k - 1) // k

    def cond(carry):
        return (carry[0] < n_chunks) & jnp.any(carry[1] >= T_EPS)

    def body(carry):
        j, tcar, acc, nspl = carry
        rows, real, _ = _chunk(stream, tile_start, tile_end, j, k)
        _, _, _, alpha = _alpha(rows, px, py)
        alpha = jnp.where(real, alpha, 0.0)
        t_entry, t_after = _transmittance(tcar, alpha)
        alive = t_entry >= T_EPS
        w = jnp.where(alive, alpha * t_entry, 0.0)
        acc = acc + jnp.sum(w[None] * rows[6:9], axis=3)
        nspl = nspl + jnp.sum(alive & real, axis=2)
        crossed = jnp.max(jnp.where(alive & (t_after < T_EPS), t_after, -1.0),
                          axis=2)
        tnext = jnp.where(crossed >= 0.0, crossed, t_after[..., -1])
        tcar = jnp.where(tcar < T_EPS, tcar, tnext)
        return j + 1, tcar, acc, nspl

    _, tfin, acc, nspl = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.ones((num_tiles, pix), jnp.float32),
         jnp.zeros((3, num_tiles, pix), jnp.float32),
         jnp.zeros((num_tiles, pix), jnp.int32)),
    )
    rgb = acc + tfin[None] * bg
    zeros = jnp.zeros((OUT_ROWS - 5, num_tiles, pix), jnp.float32)
    out = jnp.concatenate(
        [rgb, tfin[None], nspl.astype(jnp.float32)[None], zeros], axis=0
    )
    return out.transpose(1, 0, 2)


def raster_backward_ref(stream, splat_gid, pix_stream, tile_start, tile_count,
                        num_gaussians: int, *, num_tiles_x: int,
                        num_tiles: int, tile: int, k: int,
                        grad_scale: tuple[float, float]):
    """(N, 9) per-Gaussian gradient sums [du dv dc00 dc01 dc11 dop dr dg db].

    ``pix_stream`` rows are [dI_r dI_g dI_b T_final n_splats bg.dI C.dI 0]
    per tile (see kernels/rasterize.py)."""
    pix = tile * tile
    px, py = _pixel_coords(num_tiles, num_tiles_x, tile)
    tile_end = tile_start + tile_count
    prow = pix_stream.transpose(1, 0, 2)[..., None]  # (8, T, PIX, 1)
    di = prow[0:3]
    tfin, nspl, bg_dot, c_dot = prow[3], prow[4], prow[5], prow[6]
    last = jnp.minimum(
        tile_start + jnp.max(pix_stream[:, 4, :], axis=1).astype(jnp.int32),
        tile_end,
    )
    n_chunks = (jnp.max(last - tile_start) + k - 1) // k
    scale_u, scale_v = (float(s) for s in grad_scale)

    def body(j, carry):
        tcar, s_car, acc = carry
        rows, real, idx = _chunk(stream, tile_start, tile_end, j, k)
        u, v, c00, c01, c11, opa = rows[:6]
        dx, dy, gval, alpha = _alpha(rows, px, py)
        rel = (j * k + jnp.arange(k, dtype=jnp.int32)).astype(jnp.float32)
        valid = real & (rel < nspl) & (alpha > 0.0)
        alpha = jnp.where(valid, alpha, 0.0)
        t_entry, t_after = _transmittance(tcar, alpha)
        c_di = jnp.sum(rows[6:9] * di, axis=0)
        w = alpha * t_entry
        q = w * c_di
        s_incl = s_car[..., None] + jnp.cumsum(q, axis=2)
        inv = 1.0 / (1.0 - alpha)
        grad_alpha = (c_di * t_entry - (c_dot - s_incl) * inv
                      - tfin * bg_dot * inv)
        grad_op = jnp.where(valid, gval * grad_alpha, 0.0)
        grad_pow = grad_op * opa
        sums = jnp.stack([
            scale_u * jnp.sum(-(c00 * dx + c01 * dy) * grad_pow, axis=1),
            scale_v * jnp.sum(-(c11 * dy + c01 * dx) * grad_pow, axis=1),
            jnp.sum(-0.5 * dx * dx * grad_pow, axis=1),
            jnp.sum(-dx * dy * grad_pow, axis=1),
            jnp.sum(-0.5 * dy * dy * grad_pow, axis=1),
            jnp.sum(grad_op, axis=1),
            *(jnp.sum(w * di[c], axis=1) for c in range(3)),
        ], axis=-1)  # (T, K, 9)
        gid = jnp.where(real[:, 0, :], splat_gid[idx], -1)
        gid = jnp.where(gid >= 0, gid, num_gaussians)  # dropped below
        acc = acc.at[gid.reshape(-1)].add(sums.reshape(-1, 9), mode="drop")
        return t_after[..., -1], s_incl[..., -1], acc

    _, _, acc = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.ones((num_tiles, pix), jnp.float32),
         jnp.zeros((num_tiles, pix), jnp.float32),
         jnp.zeros((num_gaussians, 9), jnp.float32)),
    )
    return acc
