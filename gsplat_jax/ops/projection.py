"""Per-Gaussian projection math (jitted JAX, dense over the capacity axis).

Rewrite of the reference projection kernels: instead of one CUDA
thread per Gaussian with warp-broadcast matrices
(cuda/projection.cu:6-98) we express everything as batched
matmuls/elementwise ops over the full fixed-capacity array and let XLA fuse.

All forward math matches the reference to the epsilon:

- world->camera: ``xyz_c = R xyz + t`` (projection.cu:42-44),
- screen projection: clip -> NDC with ``/(w + 1e-6)`` -> pixel
  ``(ndc*0.5+0.5)*W`` (projection.cu:87-97),
- projection Jacobian with the 1.3*tan_fov frustum clamp and the |z|<1e-6
  zero guard (gaussian.cu:177-218).

Gradients come from JAX AD through this forward math, which reproduces the
reference's hand-derived backward kernels (projection_backward.cu,
gaussian_backward.cu:6-95) including the clamp case-analysis. Degenerate
entries (|z| tiny, w_clip tiny) are computed through *safe* denominators so a
zero cotangent never multiplies an inf/NaN forward residual.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may run in TF32 on the GPU; screen positions need full f32.
_HIGHEST = jax.lax.Precision.HIGHEST


def _safe(x, eps=1e-12):
    """Replace near-zero denominators; masked-out lanes stay NaN-free."""
    return jnp.where(jnp.abs(x) < eps, jnp.where(x < 0, -eps, eps), x)


def world_to_camera(xyz: jnp.ndarray, view: jnp.ndarray) -> jnp.ndarray:
    """(N,3) world points -> (N,3) camera-space points."""
    return jnp.matmul(xyz, view[:3, :3].T, precision=_HIGHEST) + view[:3, 3]


def project_to_screen(
    xyz_c: jnp.ndarray, proj: jnp.ndarray, width: int, height: int
) -> jnp.ndarray:
    """(N,3) camera points -> (N,2) pixel coordinates.

    Parity: NDC divide uses ``w_clip + 1e-6`` (projection.cu:92-93). The
    divide is additionally guarded against |w+1e-6| ~ 0 (only reachable for
    culled Gaussians behind the camera) to keep AD NaN-free.
    """
    ones = jnp.ones_like(xyz_c[:, :1])
    hom = jnp.concatenate([xyz_c, ones], axis=1)  # (N, 4)
    clip = jnp.matmul(hom, proj.T, precision=_HIGHEST)  # (N, 4)
    denom = _safe(clip[:, 3] + 1e-6, 1e-8)
    x_ndc = clip[:, 0] / denom
    y_ndc = clip[:, 1] / denom
    u = (x_ndc * 0.5 + 0.5) * width
    v = (y_ndc * 0.5 + 0.5) * height
    return jnp.stack([u, v], axis=1)


def projection_jacobian(
    xyz_c: jnp.ndarray,
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
) -> jnp.ndarray:
    """Jacobian of the pinhole projection, (N, 6) rows [J00 J01 J02 J10 J11 J12].

    Parity with gaussian.cu:177-218: x/z (resp. y/z) clamped to ±1.3*tan_fov
    before forming J02/J12; J zeroed where |z| < 1e-6. AD through the clamp
    reproduces the inside/outside case analysis of gaussian_backward.cu:49-73.
    """
    x, y, z = xyz_c[:, 0], xyz_c[:, 1], xyz_c[:, 2]
    degenerate = jnp.abs(z) < 1e-6
    zs = _safe(z, 1e-6)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    xc = jnp.clip(x / zs, -limx, limx) * zs
    yc = jnp.clip(y / zs, -limy, limy) * zs

    j00 = focal_x / zs
    j02 = -(focal_x * xc) / (zs * zs)
    j11 = focal_y / zs
    j12 = -(focal_y * yc) / (zs * zs)
    zero = jnp.zeros_like(j00)
    jac = jnp.stack([j00, zero, j02, zero, j11, j12], axis=1)
    return jnp.where(degenerate[:, None], 0.0, jac)


def frustum_cull_mask(
    uv: jnp.ndarray,
    xyz_c: jnp.ndarray,
    near_thresh: float,
    padding: int,
    width: int,
    height: int,
) -> jnp.ndarray:
    """Keep-mask: z >= near AND uv within image±padding (culling.cu:70-94)."""
    u, v = uv[:, 0], uv[:, 1]
    z = xyz_c[:, 2]
    in_frame = (
        (u >= -padding) & (u <= width + padding)
        & (v >= -padding) & (v <= height + padding)
    )
    return (z >= near_thresh) & in_frame
