"""Tile rasterizer kernels for Hopper: Pallas through Triton, fwd and bwd.

The reference CUDA rasterizer (render.cu, render_backward.cu) puts one
thread block on each 16x16 tile and walks the tile's depth-sorted splats
one at a time. Both kernels keep that shape: one program per tile, whose
PIX = 256 pixels are the block's rows, walking the tile's (unaligned)
slice of the sorted pair stream.

The forward walks the splats one at a time, as the reference does: nine
scalar loads per splat, T and the colour sums carried per pixel in
registers, and a check every K splats that stops the walk once every
pixel's T < 1e-4.

The backward takes the splats in chunks of K through masked loads and
evaluates a (PIX, K) matrix per chunk; the transmittance prefix product
along the chunk is exp(cumsum(log1p(-alpha))) (the Triton route lowers
cumsum but has no cumprod or roll). It walks front to back, recomputing
the forward's transmittances, so no division by (1 - alpha) products is
needed. It uses
  grad_alpha_k = T_k (c_k.dI) - (dI.C - S_k)/(1 - alpha_k)
                 - T_final (bg.dI)/(1 - alpha_k)
where C is the pixel's composited colour (without background) and
S_k = sum_{j<=k} w_j (c_j.dI) is the running prefix, so dI.C - S_k is the
reference's dI.P_{k+1} suffix (render_backward.cu:82-222). It writes one
gradient row per pair slot; a scatter-add by Gaussian id (XLA's
segment_sum, atomic on the GPU) then forms the per-Gaussian sums that the
reference accumulates in-kernel with atomicAdd (render_backward.cu:207-220).
Either way the summation order changes from run to run.

Compositing semantics match render.cu:49-107: alpha = min(0.99,
sigmoid(op) * exp(min(0, power))), the 1/255 cutoff, T < 1e-4 early stop
with T frozen at the crossing value, per-pixel splat counts of every real
splat visited while alive, and background = T_final * bg. The backward
ignores the 0.99 and power <= 0 clamps, as the reference does
(render_backward.cu:117-119, 161-166). ``ops/raster_ref.py`` is the plain
XLA formulation of the same semantics.

Layouts:
- stream     (9, P) f32 rows [u v c00 c01 c11 opa r g b], global pixel uv
- forward out (T, 8, PIX) f32 rows [r g b T_final n_splats 0 0 0]
- backward pix (T, 8, PIX) f32 rows [dI_r dI_g dI_b T_final n_splats
  bg.dI C.dI 0]
- backward rows (9, P) f32 per-pair gradients [du dv dc00 dc01 dc11 dop
  dr dg db], summed into (N, 9) per-Gaussian rows
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

ALPHA_CUTOFF = 0.00392156862  # 1/255 (render.cu:74)
T_EPS = 1e-4  # early-stop threshold (render.cu:77)
ALPHA_MAX = 0.99
STREAM_ROWS = 9
OUT_ROWS = 8
NUM_WARPS = 8


def _pixel_coords(t, num_tiles_x: int, tile: int):
    """Global pixel centres of tile ``t`` as two (PIX,) f32 vectors."""
    p = jnp.arange(tile * tile, dtype=jnp.int32)
    px = (t % num_tiles_x) * tile + p % tile
    py = (t // num_tiles_x) * tile + p // tile
    return px.astype(jnp.float32), py.astype(jnp.float32)


def _load_chunk(stream_ref, s0, end, k: int):
    """K splats from slot ``s0``: nine (K,) rows plus the in-range mask."""
    idx = s0 + jnp.arange(k, dtype=jnp.int32)
    real = idx < end
    rows = [
        plgpu.load(stream_ref.at[r, pl.ds(s0, k)], mask=real, other=0.0)
        for r in range(STREAM_ROWS)
    ]
    return rows, real


def _alpha(rows, px, py):
    """(PIX, K) dx, dy, Gaussian value and cut alpha of one chunk."""
    u, v, c00, c01, c11, opa = rows[:6]
    dx = u[None, :] - px[:, None]
    dy = v[None, :] - py[:, None]
    power = -0.5 * (
        c00[None, :] * dx * dx + 2.0 * c01[None, :] * dx * dy
        + c11[None, :] * dy * dy
    )
    gval = jnp.exp(jnp.minimum(power, 0.0))
    alpha = jnp.minimum(opa[None, :] * gval, ALPHA_MAX)
    alpha = jnp.where(alpha > ALPHA_CUTOFF, alpha, 0.0)
    return dx, dy, gval, alpha


def _forward_kernel(start_ref, count_ref, bg_ref, stream_ref, out_ref, *,
                    num_tiles_x: int, tile: int, k: int):
    t = pl.program_id(0)
    start = start_ref[t]
    end = start + count_ref[t]
    bg = bg_ref[0]
    px, py = _pixel_coords(t, num_tiles_x, tile)
    pix = tile * tile

    def splat(i, carry):
        base, tcar, acc_r, acc_g, acc_b, nspl = carry
        real = base + i < end
        s = jnp.minimum(base + i, end - 1)
        u, v, c00, c01, c11, opa, r, g, b = (
            stream_ref[q, s] for q in range(STREAM_ROWS)
        )
        dx = u - px
        dy = v - py
        power = -0.5 * (c00 * dx * dx + 2.0 * c01 * dx * dy + c11 * dy * dy)
        alpha = jnp.minimum(opa * jnp.exp(jnp.minimum(power, 0.0)), ALPHA_MAX)
        alpha = jnp.where((alpha > ALPHA_CUTOFF) & real, alpha, 0.0)
        # A pixel composites while T >= 1e-4; the splat that takes T below
        # it still composites and freezes T there (render.cu:76-87).
        alive = tcar >= T_EPS
        w = jnp.where(alive, alpha * tcar, 0.0)
        return (base, jnp.where(alive, tcar * (1.0 - alpha), tcar),
                acc_r + w * r, acc_g + w * g, acc_b + w * b,
                nspl + jnp.where(alive & real, 1.0, 0.0))

    def cond(carry):
        base, tcar = carry[0], carry[1]
        return (base < end) & (jnp.max(tcar) >= T_EPS)

    def body(carry):
        carry = jax.lax.fori_loop(0, k, splat, carry)
        return (carry[0] + k,) + carry[1:]

    zeros = jnp.zeros((pix,), jnp.float32)
    _, tfin, acc_r, acc_g, acc_b, nspl = jax.lax.while_loop(
        cond, body,
        (start, jnp.ones((pix,), jnp.float32), zeros, zeros, zeros, zeros),
    )
    for r, val in enumerate((acc_r + tfin * bg, acc_g + tfin * bg,
                             acc_b + tfin * bg, tfin, nspl)):
        plgpu.store(out_ref.at[r], val)
    for r in range(5, OUT_ROWS):
        plgpu.store(out_ref.at[r], zeros)


def rasterize_forward(stream, tile_start, tile_count, bg, *,
                      num_tiles_x: int, num_tiles: int, tile: int, k: int,
                      interpret: bool = False):
    """(T, 8, PIX) tile pixels [r g b T_final n_splats 0 0 0]."""
    pix = tile * tile
    return pl.pallas_call(
        functools.partial(_forward_kernel, num_tiles_x=num_tiles_x,
                          tile=tile, k=k),
        grid=(num_tiles,),
        in_specs=[pl.BlockSpec()] * 4,
        out_specs=pl.BlockSpec((None, OUT_ROWS, pix), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((num_tiles, OUT_ROWS, pix),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="gsplat_rasterize_fwd",
    )(tile_start, tile_count, jnp.reshape(bg, (1,)).astype(jnp.float32),
      stream)


def _backward_kernel(start_ref, count_ref, stream_ref, pix_ref, rows_in_ref,
                     rows_ref, *, num_tiles_x: int, tile: int, k: int,
                     scale_u: float, scale_v: float):
    del rows_in_ref  # aliased with rows_ref
    t = pl.program_id(0)
    start = start_ref[t]
    end = start + count_ref[t]
    pix = tile * tile
    px, py = _pixel_coords(t, num_tiles_x, tile)
    di_r, di_g, di_b, tfin, nspl, bg_dot, c_dot = (
        plgpu.load(pix_ref.at[r]) for r in range(7)
    )
    # Only splats some pixel composited while alive carry gradient.
    last = jnp.minimum(start + jnp.max(nspl).astype(jnp.int32), end)

    def body(j, carry):
        tcar, s_car = carry
        s0 = start + j * k
        rows, real = _load_chunk(stream_ref, s0, end, k)
        u, v, c00, c01, c11, opa, cr, cg, cb = rows
        dx, dy, gval, alpha = _alpha(rows, px, py)
        rel = (j * k + jnp.arange(k, dtype=jnp.int32)).astype(jnp.float32)
        valid = real[None, :] & (rel[None, :] < nspl[:, None]) & (alpha > 0.0)
        alpha = jnp.where(valid, alpha, 0.0)
        log_t = jnp.log1p(-alpha)
        csum = jnp.cumsum(log_t, axis=1)
        t_entry = tcar[:, None] * jnp.exp(csum - log_t)
        c_di = (cr[None, :] * di_r[:, None] + cg[None, :] * di_g[:, None]
                + cb[None, :] * di_b[:, None])
        q = alpha * t_entry * c_di
        s_incl = s_car[:, None] + jnp.cumsum(q, axis=1)
        inv = 1.0 / (1.0 - alpha)
        grad_alpha = (
            c_di * t_entry - (c_dot[:, None] - s_incl) * inv
            - (tfin * bg_dot)[:, None] * inv
        )
        grad_op = jnp.where(valid, gval * grad_alpha, 0.0)
        grad_pow = grad_op * opa[None, :]
        w = alpha * t_entry
        sums = (
            scale_u * jnp.sum(
                -(c00[None, :] * dx + c01[None, :] * dy) * grad_pow, axis=0),
            scale_v * jnp.sum(
                -(c11[None, :] * dy + c01[None, :] * dx) * grad_pow, axis=0),
            jnp.sum(-0.5 * dx * dx * grad_pow, axis=0),
            jnp.sum(-dx * dy * grad_pow, axis=0),
            jnp.sum(-0.5 * dy * dy * grad_pow, axis=0),
            jnp.sum(grad_op, axis=0),
            jnp.sum(w * di_r[:, None], axis=0),
            jnp.sum(w * di_g[:, None], axis=0),
            jnp.sum(w * di_b[:, None], axis=0),
        )
        for r, val in enumerate(sums):
            plgpu.store(rows_ref.at[r, pl.ds(s0, k)], val, mask=real)
        return (tcar * jnp.exp(jnp.sum(log_t, axis=1)),
                s_car + jnp.sum(q, axis=1))

    ones = jnp.ones((pix,), jnp.float32)
    jax.lax.fori_loop(0, pl.cdiv(last - start, k), body,
                      (ones, jnp.zeros((pix,), jnp.float32)))


def rasterize_backward(stream, splat_gid, pix_stream, tile_start, tile_count,
                       num_gaussians: int, *, num_tiles_x: int,
                       num_tiles: int, tile: int, k: int,
                       grad_scale: tuple[float, float],
                       interpret: bool = False):
    """(N, 9) per-Gaussian gradient sums [du dv dc00 dc01 dc11 dop dr dg db].

    uv gradients are scaled by ``grad_scale`` (the reference's x0.5*W,
    x0.5*H convention, render_backward.cu:186-187)."""
    pix = tile * tile
    num_slots = stream.shape[1]
    rows = pl.pallas_call(
        functools.partial(_backward_kernel, num_tiles_x=num_tiles_x,
                          tile=tile, k=k, scale_u=float(grad_scale[0]),
                          scale_v=float(grad_scale[1])),
        grid=(num_tiles,),
        in_specs=[pl.BlockSpec()] * 3 + [
            pl.BlockSpec((None, OUT_ROWS, pix), lambda t: (t, 0, 0)),
            pl.BlockSpec(),
        ],
        out_specs=pl.BlockSpec(),
        out_shape=jax.ShapeDtypeStruct((STREAM_ROWS, num_slots), jnp.float32),
        # Slots no tile walks (the invalid tail, splats behind every
        # pixel's stop) keep these zeros.
        input_output_aliases={4: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="gsplat_rasterize_bwd",
    )(tile_start, tile_count, stream, pix_stream,
      jnp.zeros((STREAM_ROWS, num_slots), jnp.float32))
    # Invalid slots (gid -1) fall outside the segments and are dropped.
    gid = jnp.where(splat_gid >= 0, splat_gid, num_gaussians)
    return jax.ops.segment_sum(rows.T, gid, num_segments=num_gaussians)
