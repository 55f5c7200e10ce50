"""Sequential numpy oracle of the tile rasterizer — tests only.

Implements, pixel-by-pixel and splat-by-splat, the exact compositing semantics
of the reference CUDA kernels so the Pallas kernels can be verified against
it:

- forward: cuda/render.cu:49-107 — front-to-back alpha
  compositing with alpha = min(0.99, sigmoid(op) * exp(min(0, power))),
  the 1/255 alpha cutoff, T < 1e-4 early stop (T frozen at the crossing
  value), per-pixel splat counting of every iterated splat while not done,
  and background = T_final * bg added per channel;
- backward: cuda/render_backward.cu:82-222 — back-to-front
  replay from (T_final, splats_per_pixel), reconstructing T via
  T *= 1/(1-alpha), with the background -T_final/(1-alpha) term and the
  grad_uv outputs scaled by 0.5*W / 0.5*H (render_backward.cu:186-187).

This is deliberately the dumb O(pixels x splats) formulation; use only on
tiny scenes.
"""

from __future__ import annotations

import numpy as np

ALPHA_CUTOFF = 0.00392156862  # 1/255 (render.cu:74)
T_EPS = 1e-4  # early-stop threshold (render.cu:77)
ALPHA_MAX = 0.99


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def oracle_render_forward(
    uv: np.ndarray,
    opacity_logit: np.ndarray,
    conic: np.ndarray,
    rgb: np.ndarray,
    splat_gid_by_tile: list[list[int]],
    width: int,
    height: int,
    tile_size: int,
    bg: float,
):
    """Returns image (H, W, 3), T_final (H, W), n_splats (H, W)."""
    num_tiles_x = (width + tile_size - 1) // tile_size
    num_tiles_y = (height + tile_size - 1) // tile_size
    image = np.zeros((height, width, 3), np.float32)
    t_final = np.ones((height, width), np.float32)
    n_splats = np.zeros((height, width), np.int32)
    opa = _sigmoid(opacity_logit.astype(np.float64))

    for ty in range(num_tiles_y):
        for tx in range(num_tiles_x):
            splats = splat_gid_by_tile[ty * num_tiles_x + tx]
            for py in range(tile_size):
                gy = ty * tile_size + py
                if gy >= height:
                    continue
                for px in range(tile_size):
                    gx = tx * tile_size + px
                    if gx >= width:
                        continue
                    t = np.float32(1.0)
                    acc = np.zeros(3, np.float32)
                    count = 0
                    done = False
                    for g in splats:
                        if done:
                            break
                        count += 1
                        dx = uv[g, 0] - gx
                        dy = uv[g, 1] - gy
                        power = -0.5 * (
                            conic[g, 0] * dx * dx
                            + 2.0 * conic[g, 1] * dx * dy
                            + conic[g, 2] * dy * dy
                        )
                        power = min(0.0, power)
                        alpha = min(ALPHA_MAX, opa[g] * np.exp(power))
                        if alpha <= ALPHA_CUTOFF:
                            alpha = 0.0
                        test_t = t * (1.0 - alpha)
                        if test_t < T_EPS:
                            done = True
                        acc += (alpha * t) * rgb[g].astype(np.float32)
                        t = np.float32(test_t)
                    image[gy, gx] = acc + t * bg
                    t_final[gy, gx] = t
                    n_splats[gy, gx] = count
    return image, t_final, n_splats


def oracle_render_backward(
    uv: np.ndarray,
    opacity_logit: np.ndarray,
    conic: np.ndarray,
    rgb: np.ndarray,
    splat_gid_by_tile: list[list[int]],
    width: int,
    height: int,
    tile_size: int,
    bg: float,
    t_final: np.ndarray,
    n_splats: np.ndarray,
    grad_image: np.ndarray,
    num_gaussians: int,
):
    """Returns per-Gaussian grads (rgb (N,3), opacity (N,), uv (N,2), conic (N,3))."""
    num_tiles_x = (width + tile_size - 1) // tile_size
    num_tiles_y = (height + tile_size - 1) // tile_size
    g_rgb = np.zeros((num_gaussians, 3), np.float64)
    g_op = np.zeros((num_gaussians,), np.float64)
    g_uv = np.zeros((num_gaussians, 2), np.float64)
    g_conic = np.zeros((num_gaussians, 3), np.float64)
    opa_all = _sigmoid(opacity_logit.astype(np.float64))

    for ty in range(num_tiles_y):
        for tx in range(num_tiles_x):
            splats = splat_gid_by_tile[ty * num_tiles_x + tx]
            if not splats:
                continue
            for py in range(tile_size):
                gy = ty * tile_size + py
                if gy >= height:
                    continue
                for px in range(tile_size):
                    gx = tx * tile_size + px
                    if gx >= width:
                        continue
                    di = grad_image[gy, gx].astype(np.float64)
                    tf = float(t_final[gy, gx])
                    t = tf
                    acc = np.zeros(3, np.float64)
                    # back-to-front over splats this pixel processed
                    for k in range(len(splats) - 1, -1, -1):
                        g = splats[k]
                        if k >= n_splats[gy, gx]:
                            continue
                        dx = uv[g, 0] - gx
                        dy = uv[g, 1] - gy
                        power = -0.5 * (
                            conic[g, 0] * dx * dx
                            + 2.0 * conic[g, 1] * dx * dy
                            + conic[g, 2] * dy * dy
                        )
                        power = min(0.0, power)
                        gval = np.exp(power)
                        opa = opa_all[g]
                        alpha = min(ALPHA_MAX, opa * gval)
                        if alpha < ALPHA_CUTOFF:
                            continue
                        t = t / (1.0 - alpha)
                        color = rgb[g].astype(np.float64)
                        g_rgb[g] += alpha * t * di
                        grad_alpha = float(np.dot(color - acc, di)) * t
                        grad_alpha += (-tf / (1.0 - alpha)) * bg * di.sum()
                        g_op[g] += gval * grad_alpha * opa * (1.0 - opa)
                        acc = alpha * color + (1.0 - alpha) * acc
                        grad_power = gval * grad_alpha * opa
                        # true per-pixel partials (equivalent to the
                        # basic/linear/quad split, see SURVEY §2.4 D11)
                        g_uv[g, 0] += (
                            -(conic[g, 0] * dx + conic[g, 1] * dy)
                            * grad_power * 0.5 * width
                        )
                        g_uv[g, 1] += (
                            -(conic[g, 2] * dy + conic[g, 1] * dx)
                            * grad_power * 0.5 * height
                        )
                        g_conic[g, 0] += -0.5 * dx * dx * grad_power
                        g_conic[g, 1] += -dx * dy * grad_power
                        g_conic[g, 2] += -0.5 * dy * dy * grad_power
    return (
        g_rgb.astype(np.float32),
        g_op.astype(np.float32),
        g_uv.astype(np.float32),
        g_conic.astype(np.float32),
    )
