"""Real spherical harmonics up to l=3 (closed form, jitted JAX).

Replaces the reference's sphericart dependency
(cuda/spherical_harmonics.cu:62-94). Basis: orthonormal real
spherical harmonics on the unit sphere in the graphics sign convention,
ordered by (l, m) with m = -l..l (index l^2 + l + m); the reference's own
golden test pins Y00 = 0.28209, Y1m = 0.48860*(y, z, x)
(tests/cuda_forward_test.cpp:596-615), which this matches.

Color evaluation parity (spherical_harmonics.cu:28-60):
``rgb = dc * Y0 + 0.5 + sum_i coeff_i * Y_i`` with no clamp/sigmoid, and view
direction ``normalize(xyz - campos)`` with a +1e-9 on the length
(spherical_harmonics.cu:8-26). JAX AD through this forward reproduces the
hand-written backward (spherical_harmonics_backward.cu:28-166), including the
(g - (g.dir)dir)/dist normalization chain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# l=0
_C0 = 0.28209479177387814
# l=1
_C1 = 0.4886025119029199
# l=2
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
       1.0925484305920792, 0.5462742152960396)
# l=3
_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
       0.3731763325901154, 0.4570457994644658, 1.445305721320277,
       0.5900435899266435)

Y00 = _C0


def num_sh_coeffs(l_max: int) -> int:
    return (l_max + 1) * (l_max + 1)


def sh_basis(dirs: jnp.ndarray, l_max: int) -> jnp.ndarray:
    """SH basis values for unit directions. (N, 3) -> (N, (l_max+1)^2)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    out = [jnp.full_like(x, _C0)]
    if l_max >= 1:
        out += [_C1 * y, _C1 * z, _C1 * x]
    if l_max >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C2[0] * x * y,
            _C2[1] * y * z,
            _C2[2] * (3.0 * zz - 1.0),
            _C2[3] * x * z,
            _C2[4] * (xx - yy),
        ]
    if l_max >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (5.0 * zz - 1.0),
            _C3[3] * z * (5.0 * zz - 3.0),
            _C3[4] * x * (5.0 * zz - 1.0),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return jnp.stack(out, axis=1)


def view_dirs(xyz: jnp.ndarray, campos: jnp.ndarray) -> jnp.ndarray:
    """normalize(xyz - campos) with the reference's +1e-9 length epsilon."""
    diff = xyz - campos[None, :]
    length = jnp.sqrt(jnp.sum(diff * diff, axis=1)) + 1e-9
    return diff / length[:, None]


def sh_to_rgb(
    xyz: jnp.ndarray,
    dc: jnp.ndarray,
    sh: jnp.ndarray,
    campos: jnp.ndarray,
    l_max: int,
) -> jnp.ndarray:
    """Per-Gaussian view-dependent color.

    Args:
      xyz: (N, 3) world positions.
      dc: (N, 3) band-0 coefficients (the reference's ``rgb`` array).
      sh: (N, 15, 3) higher-band coefficients (bands beyond l_max ignored).
      campos: (3,) camera center.
      l_max: active SH degree, 0..3 (static).

    Returns:
      (N, 3) colors = dc*Y0 + 0.5 + sum coeffs*Y (no clamp, parity with
      spherical_harmonics.cu:41-59).
    """
    dirs = view_dirs(xyz, campos)
    basis = sh_basis(dirs, l_max)  # (N, K)
    rgb = dc * basis[:, :1] + 0.5
    k = num_sh_coeffs(l_max)
    if k > 1:
        rgb = rgb + jnp.einsum("nk,nkc->nc", basis[:, 1:], sh[:, : k - 1, :],
                               precision=jax.lax.Precision.HIGHEST)
    return rgb
