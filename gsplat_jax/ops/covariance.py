"""3D covariance and 2D conic math (jitted JAX, dense over capacity).

Rewrite of the reference covariance kernels
(cuda/gaussian.cu): batched elementwise/matmul formulations
replacing one-thread-per-Gaussian CUDA, with forward math matching to the
epsilon so JAX AD reproduces the hand-derived backward kernels
(gaussian_backward.cu:97-429):

- ``sigma_from_quat_scale``: quaternion normalized by 1/(|q| + 1e-6)
  (gaussian.cu:20-25), scales exponentiated, Sigma = (RS)(RS)^T stored as the
  6 unique symmetric elements [xx xy xz yy yz zz] (gaussian.cu:66-74).
- ``conic_and_radius``: conic = inverse of the 2x2 screen covariance
  ``J W Sigma (J W)^T + 0.3 I`` (the +0.3 dilation of gaussian.cu:148-150),
  plus the [r_major, r_minor, sin, cos] oriented-bounding-box record used by
  binning (gaussian.cu:161-174). The radius record is non-differentiable
  (binning-only) and should be wrapped in stop_gradient by callers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sigma_from_quat_scale(quat: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """(N,4) (w,x,y,z) quats + (N,3) log-scales -> (N,6) symmetric Sigma."""
    norm = jnp.sqrt(jnp.sum(quat * quat, axis=1))
    inv_norm = 1.0 / (norm + 1e-6)
    w = quat[:, 0] * inv_norm
    x = quat[:, 1] * inv_norm
    y = quat[:, 2] * inv_norm
    z = quat[:, 3] * inv_norm

    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z

    r00 = 1.0 - 2.0 * (y2 + z2)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (x2 + z2)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (x2 + y2)

    sx = jnp.exp(scale[:, 0])
    sy = jnp.exp(scale[:, 1])
    sz = jnp.exp(scale[:, 2])

    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz

    s_xx = m00 * m00 + m01 * m01 + m02 * m02
    s_xy = m00 * m10 + m01 * m11 + m02 * m12
    s_xz = m00 * m20 + m01 * m21 + m02 * m22
    s_yy = m10 * m10 + m11 * m11 + m12 * m12
    s_yz = m10 * m20 + m11 * m21 + m12 * m22
    s_zz = m20 * m20 + m21 * m21 + m22 * m22
    return jnp.stack([s_xx, s_xy, s_xz, s_yy, s_yz, s_zz], axis=1)


def conic_and_radius(
    sigma: jnp.ndarray,
    jac: jnp.ndarray,
    view: jnp.ndarray,
    mh_dist: float,
    opacity_logit: jnp.ndarray | None = None,
):
    """2D conic (inverse screen covariance) and OBB radius record.

    Args:
      sigma: (N, 6) symmetric world covariance [xx xy xz yy yz zz].
      jac: (N, 6) projection Jacobian rows [J00 J01 J02 J10 J11 J12].
      view: (4, 4) view matrix; upper-left 3x3 is W.
      mh_dist: Mahalanobis cut distance for the bounding radius.
      opacity_logit: optional (N,) opacity logits. When given, the bounding
        radius is tightened to the alpha = 1/255 isocontour,
        ``sqrt(2 ln(255 sigmoid(o)))`` sigmas: the rasterizer skips
        contributions below that cutoff anyway (render.cu:74), so the
        rendered image and gradients are bit-identical while low-opacity
        Gaussians generate far fewer (tile, splat) pairs.

    Returns:
      conic: (N, 3) [c00 c01 c11] of inv(J W Sigma (J W)^T + 0.3 I).
      radius: (N, 5) [r_major r_minor sin_theta cos_theta ell_scale]
        (not differentiable). ``ell_scale`` (>= 1) is the ratio of the
        alpha = 1/255 isocontour's Mahalanobis radius to the OBB cut
        radius: the ellipse with semi-axes ``ell_scale * (r_major,
        r_minor)`` contains EVERY pixel whose alpha can exceed the
        rasterizer's 1/255 cutoff (render.cu:74). Binning intersects the
        OBB tile test with this ellipse's exact per-strip support
        (ops/binning.py), dropping the OBB's corner tiles — provably
        zero-contribution, zero-gradient pairs (15-20% of all pairs).
        Hand-built (N, 4) records keep the pure-OBB behavior.
    """
    # Scalarized M = J @ W and cov2 = M Sigma M^T as elementwise ops on
    # (N,) columns, which XLA fuses (no tiny batched matmuls, and no
    # TF32 rounding). J is sparse: [j00 0 j02; 0 j11 j12].
    w3 = view[:3, :3]  # (3, 3) scalars, broadcast
    j00, j02 = jac[:, 0], jac[:, 2]
    j11, j12 = jac[:, 4], jac[:, 5]
    m0 = [j00 * w3[0, c] + j02 * w3[2, c] for c in range(3)]
    m1 = [j11 * w3[1, c] + j12 * w3[2, c] for c in range(3)]

    sxx, sxy, sxz = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    syy, syz, szz = sigma[:, 3], sigma[:, 4], sigma[:, 5]

    def _sig_row(v):  # Sigma @ v for row vector v (list of 3 (N,) cols)
        return [
            sxx * v[0] + sxy * v[1] + sxz * v[2],
            sxy * v[0] + syy * v[1] + syz * v[2],
            sxz * v[0] + syz * v[1] + szz * v[2],
        ]

    s_m0 = _sig_row(m0)
    s_m1 = _sig_row(m1)
    cov00 = m0[0] * s_m0[0] + m0[1] * s_m0[1] + m0[2] * s_m0[2] + 0.3
    cov01 = m0[0] * s_m1[0] + m0[1] * s_m1[1] + m0[2] * s_m1[2]
    cov11 = m1[0] * s_m1[0] + m1[1] * s_m1[1] + m1[2] * s_m1[2] + 0.3

    det = cov00 * cov11 - cov01 * cov01
    inv_det = 1.0 / det
    conic = jnp.stack([cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det], axis=1)

    # Eigenvalues -> OBB extents and orientation (gaussian.cu:161-174).
    mid = 0.5 * (cov00 + cov11)
    lam_term = jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    lam1 = mid + lam_term
    lam2 = mid - lam_term
    if opacity_logit is not None:
        # alpha = sigmoid(o) * exp(-d^2/2) >= 1/255  <=>
        # d <= sqrt(2 * (log(sigmoid(o)) + log 255)); <= 0 means never visible.
        t = 2.0 * (jnp.log(255.0) - jax.nn.softplus(-opacity_logit))
        r_cut = jnp.sqrt(jnp.maximum(t, 0.0))
    else:
        # No opacity: alpha <= exp(-d^2/2), cutoff at sqrt(2 ln 255).
        r_cut = jnp.full_like(mid, jnp.sqrt(2.0 * jnp.log(255.0)))
    cut = jnp.minimum(mh_dist, r_cut)
    r_major = jnp.ceil(cut * jnp.sqrt(jnp.maximum(lam1, 0.0)))
    r_minor = jnp.ceil(cut * jnp.sqrt(jnp.maximum(lam2, 0.0)))
    theta = 0.5 * jnp.arctan2(2.0 * cov01, cov00 - cov11)
    # ell_scale: the 1/255-cutoff ellipse in units of the (ceil'ed) OBB
    # radius — >= 1 (cut = min(mh, r_cut) <= r_cut); any value >= sqrt(2)
    # makes the ellipse contain the whole OBB (no corner cut), so cap at
    # 2.0 to keep degenerate ratios finite.
    #
    # PAD for the packed stream's rounding: the kernels evaluate alpha from
    # bf16-rounded conic/opacity and f16 tile-relative uv, so a pixel whose
    # exact alpha is just below 1/255 can round above it. |delta ln alpha|
    # <= 2^-8 * q_abs + 2^-8, and the abs-valued quadratic q_abs <= kappa/2
    # * q in the worst (45-degree elongated) direction, kappa = lam1/lam2.
    # Padding r_cut^2 by (kappa * 2^-7) * r_cut^2 + 0.1 keeps every pair
    # that any rounded evaluation could light up — the elliptical cut stays
    # VALUE-EXACT for the packed path too (test_render.py ellipse test).
    kappa = lam1 / jnp.maximum(lam2, 1e-12)
    r_pad = jnp.sqrt(
        r_cut * r_cut * (1.0 + kappa * (1.0 / 128.0)) + 0.1
    )
    ell_scale = jnp.minimum(r_pad / jnp.maximum(cut, 1e-6), 2.0)
    radius = jnp.stack(
        [r_major, r_minor, jnp.sin(theta), jnp.cos(theta), ell_scale], axis=1
    )
    return conic, jax.lax.stop_gradient(radius)
