"""Differentiable tile rasterization op (custom VJP around the rasterizer).

The custom-gradient boundary is (per-Gaussian attribute matrix) -> (tile
pixels). The forward consumes the sorted pair stream built by binning; the
backward returns per-Gaussian sums of the per-pair gradients, summed by
Gaussian id with a scatter-add where the reference uses atomicAdd
(render_backward.cu:207-220).

Two implementations share the op: the Pallas kernels of
``kernels/rasterize.py`` (the default) and the plain XLA formulation of
``ops/raster_ref.py``, used only when the caller asks for it
(``impl="reference"``).

Gradient conventions (reference parity, SURVEY §2.4 D11):
- uv cotangents are scaled by 0.5*W / 0.5*H inside the backward
  (render_backward.cu:186-187). Projection AD then applies the full W/2 chain
  again, reproducing the reference's double-scaled xyz gradient path, and the
  densification accumulator consumes these scaled uv grads.
- the 0.99 alpha clamp and the power<=0 clamp are ignored in the backward,
  as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import rasterize as _k
from . import raster_ref
from .binning import TileTables

IMPLS = ("kernel", "reference")


class RenderOutput(NamedTuple):
    image: jnp.ndarray  # (H, W, 3) cropped
    t_final: jnp.ndarray  # (T, PIX)
    n_splats: jnp.ndarray  # (T, PIX) float32 counts


def _check_device(impl: str, interpret: bool) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas rasterizer compiles only for the GPU; on the "
            f"{jax.default_backend()!r} backend pass interpret=True"
        )


@functools.lru_cache(maxsize=64)
def _get_raster_op(num_tiles_x, num_tiles, tile, k, interpret, impl,
                   grad_scale_wh):
    """Build the custom-VJP op for a static (grid, tile, chunk) geometry.

    op(attrs, tables, bg) -> (T, 8, PIX) tile pixels. Differentiable w.r.t.
    ``attrs`` (rows [u v c00 c01 c11 opa r g b]); bg gets no gradient.

    CONTRACT: ``tables`` must come from build_tile_tables called with the
    numerically identical ``attrs``; the forward reads tables.stream (the
    sorted pair rows) while the VJP is defined w.r.t. ``attrs``.
    """
    geom = dict(num_tiles_x=num_tiles_x, num_tiles=num_tiles, tile=tile, k=k)
    if impl == "kernel":
        fwd_impl = functools.partial(_k.rasterize_forward, **geom,
                                     interpret=interpret)
        bwd_impl = functools.partial(_k.rasterize_backward, **geom,
                                     interpret=interpret)
    else:
        fwd_impl = functools.partial(raster_ref.raster_forward_ref, **geom)
        bwd_impl = functools.partial(raster_ref.raster_backward_ref, **geom)

    def forward(tables: TileTables, bg):
        return fwd_impl(tables.stream, tables.tile_start, tables.tile_count,
                        bg)

    @jax.custom_vjp
    def op(attrs, tables: TileTables, bg):
        del attrs  # values already in tables.stream (see CONTRACT)
        return forward(tables, bg)

    def fwd(attrs, tables: TileTables, bg):
        out = forward(tables, bg)
        return out, (tables, bg, out, attrs.shape[0])

    def bwd(res, ct):
        tables, bg, out, n = res
        di = ct[:, 0:3, :]  # (T, 3, PIX) image cotangent
        tfin = out[:, 3:4, :]
        c_dot = jnp.sum(di * (out[:, 0:3, :] - tfin * bg), axis=1,
                        keepdims=True)
        bg_dot = bg * jnp.sum(di, axis=1, keepdims=True)
        pix_stream = jnp.concatenate(
            [di, tfin, out[:, 4:5, :], bg_dot, c_dot, jnp.zeros_like(tfin)],
            axis=1,
        )
        # Reference uv-gradient convention: x(0.5*W), x(0.5*H) of the
        # image, not of its tile grid (render_backward.cu:186-187).
        w_img, h_img = grad_scale_wh
        d_attrs = bwd_impl(
            tables.stream, tables.splat_gid, pix_stream, tables.tile_start,
            tables.tile_count, n, grad_scale=(0.5 * w_img, 0.5 * h_img),
        )
        f0 = jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, jax.dtypes.float0), tables
        )
        return (d_attrs, f0, jnp.zeros_like(bg))

    op.defvjp(fwd, bwd)
    return op


def pack_attrs(
    uv: jnp.ndarray,
    conic: jnp.ndarray,
    rgb: jnp.ndarray,
    opacity_logit: jnp.ndarray,
) -> jnp.ndarray:
    """Per-Gaussian (N, 9) attribute rows [u v c00 c01 c11 opa r g b].

    Plain jnp (differentiable): AD through the stack is dense elementwise.
    The sigmoid here realizes the opacity chain o(1-o) of
    render_backward.cu:154 via AD.
    """
    opa = jax.nn.sigmoid(opacity_logit)
    cols = [
        uv[:, 0], uv[:, 1],
        conic[:, 0], conic[:, 1], conic[:, 2],
        opa,
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
    ]
    return jnp.stack(cols, axis=1)


def tiles_to_image(
    out_tiles: jnp.ndarray,
    num_tiles_x: int,
    num_tiles_y: int,
    tile: int,
    width: int,
    height: int,
) -> jnp.ndarray:
    """(T, 3, PIX) tile pixels -> cropped (H, W, 3) image."""
    x = out_tiles.reshape(num_tiles_y, num_tiles_x, 3, tile, tile)
    x = x.transpose(0, 3, 1, 4, 2)  # (ty, py, tx, px, 3)
    x = x.reshape(num_tiles_y * tile, num_tiles_x * tile, 3)
    return x[:height, :width, :]


def rasterize(
    uv: jnp.ndarray,
    conic: jnp.ndarray,
    rgb: jnp.ndarray,
    opacity_logit: jnp.ndarray,
    tables: TileTables,
    bg: jnp.ndarray,
    *,
    width: int,
    height: int,
    tile: int,
    chunk: int,
    interpret: bool = False,
    impl: str = "kernel",
    grad_scale_wh: tuple[int, int] | None = None,
) -> RenderOutput:
    """Render the image; differentiable w.r.t. (uv, conic, rgb, opacity).

    ``tables`` must come from build_tile_tables with
    ``attrs=pack_attrs(uv, conic, rgb, opacity_logit)`` (same values).
    ``interpret`` runs the Pallas kernels in interpret mode (CPU tests);
    without it they compile for the GPU and any other backend raises.
    ``grad_scale_wh`` is the (W, H) of the uv-gradient convention: the
    image's by default, the global image's for a tile-sharded strip.
    """
    _check_device(impl, interpret)
    num_tiles_x = (width + tile - 1) // tile
    num_tiles_y = (height + tile - 1) // tile
    num_tiles = num_tiles_x * num_tiles_y

    attrs = pack_attrs(uv, conic, rgb, opacity_logit)
    op = _get_raster_op(num_tiles_x, num_tiles, tile, chunk, bool(interpret),
                        impl, grad_scale_wh or (width, height))
    out = op(attrs, tables, jnp.asarray(bg, jnp.float32))
    image = tiles_to_image(
        out[:, 0:3, :], num_tiles_x, num_tiles_y, tile, width, height
    )
    t_final = jax.lax.stop_gradient(out[:, 3, :])
    n_splats = jax.lax.stop_gradient(out[:, 4, :])
    return RenderOutput(image=image, t_final=t_final, n_splats=n_splats)
