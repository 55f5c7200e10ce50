"""Per-Gaussian math ops: golden values + finite-difference gradient checks
(reference strategy: tests/cuda_forward_test.cpp, cuda_backward_test.cpp)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_jax.ops import covariance, projection, sh
from gsplat_jax.ops.camera import build_camera_matrices


def test_sigma_golden_identity_rotation():
    # R=I, S=diag(2,3,4) -> Sigma = diag(4,9,16) (cuda_forward_test.cpp:37-90)
    quat = jnp.array([[1.0, 0, 0, 0]])
    scale = jnp.log(jnp.array([[2.0, 3.0, 4.0]]))
    sigma = covariance.sigma_from_quat_scale(quat, scale)
    np.testing.assert_allclose(
        np.asarray(sigma[0]), [4.0, 0, 0, 9.0, 0, 16.0], atol=1e-3
    )


def test_sigma_rotated_90deg_z():
    # 90 deg about z swaps x/y variances.
    quat = jnp.array([[math.cos(math.pi / 4), 0, 0, math.sin(math.pi / 4)]])
    scale = jnp.log(jnp.array([[2.0, 3.0, 1.0]]))
    sigma = covariance.sigma_from_quat_scale(quat, scale)
    np.testing.assert_allclose(
        np.asarray(sigma[0]), [9.0, 0, 0, 4.0, 0, 1.0], atol=1e-3
    )


def test_projection_golden():
    # Pinhole at origin: uv = ((x/z)*0.5+0.5)*W (cuda_forward_test.cpp:128-149)
    cm = build_camera_matrices(
        np.array([1.0, 0, 0, 0]), np.zeros(3), 64, 64, 32.0, 32.0
    )
    xyz = jnp.array([[0.5, -0.25, 2.0], [0.0, 0.0, 1.0]])
    xyz_c = projection.world_to_camera(xyz, jnp.asarray(cm.view))
    np.testing.assert_allclose(np.asarray(xyz_c), np.asarray(xyz), atol=1e-6)
    uv = projection.project_to_screen(xyz_c, jnp.asarray(cm.proj), 64, 64)
    np.testing.assert_allclose(
        np.asarray(uv[0]), [(0.25 * 0.5 + 0.5) * 64, (-0.125 * 0.5 + 0.5) * 64],
        rtol=1e-4,
    )
    np.testing.assert_allclose(np.asarray(uv[1]), [32.0, 32.0], rtol=1e-4)


def test_view_transform_golden():
    # Pure translation (cuda_forward_test.cpp:280-295).
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [1.0, 2.0, 3.0]
    xyz = jnp.array([[0.5, -1.0, 4.0]])
    out = projection.world_to_camera(xyz, jnp.asarray(view))
    np.testing.assert_allclose(np.asarray(out[0]), [1.5, 1.0, 7.0], atol=1e-6)


def test_frustum_culling_truth_table():
    # (cuda_forward_test.cpp:159-230 style)
    w = h = 100
    pad = 10
    near = 0.3
    uv = jnp.array(
        [[50, 50], [-5, 50], [-20, 50], [50, 108], [50, 115], [50, 50]],
        jnp.float32,
    )
    z = jnp.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.1], jnp.float32)
    xyz_c = jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z], axis=1)
    mask = projection.frustum_cull_mask(uv, xyz_c, near, pad, w, h)
    np.testing.assert_array_equal(
        np.asarray(mask), [True, True, False, True, False, False]
    )


def test_conic_golden_isotropic():
    # Sigma = I, J = [[f/z,0,0],[0,f/z,0]], W = I
    # -> cov2d = diag((f/z)^2 + 0.3) -> conic = 1/that.
    f, z = 50.0, 5.0
    sigma = jnp.array([[1.0, 0, 0, 1.0, 0, 1.0]])
    jac = jnp.array([[f / z, 0, 0, 0, f / z, 0]])
    view = jnp.eye(4)
    conic, radius = covariance.conic_and_radius(sigma, jac, view, 3.0)
    expect = 1.0 / ((f / z) ** 2 + 0.3)
    np.testing.assert_allclose(
        np.asarray(conic[0]), [expect, 0.0, expect], rtol=1e-5
    )
    # r_major = ceil(3*sqrt(lambda1))
    lam = (f / z) ** 2 + 0.3
    assert float(radius[0, 0]) == math.ceil(3.0 * math.sqrt(lam))


def test_jacobian_clamp_and_guard():
    jac = projection.projection_jacobian(
        jnp.array([[0.0, 0.0, 1e-8], [10.0, 0.0, 1.0]]),
        100.0, 100.0, 0.5, 0.5,
    )
    # |z| < 1e-6 -> all zeros (gaussian.cu:194-202)
    np.testing.assert_allclose(np.asarray(jac[0]), 0.0)
    # x/z = 10 clamps at 1.3*0.5 = 0.65 -> J02 = -f*0.65/1 (gaussian.cu:204-214)
    assert float(jac[1, 2]) == pytest.approx(-100.0 * 0.65, rel=1e-5)


def test_sh_basis_l1_golden():
    # Reference golden test pins Y00=0.28209, Y1m = 0.48860*(y,z,x)
    # (tests/cuda_forward_test.cpp:596-615).
    dirs = jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    basis = np.asarray(sh.sh_basis(dirs, 1))
    np.testing.assert_allclose(
        basis[0], [0.28209479, 0.0, 0.48860251, 0.0], atol=1e-6
    )
    np.testing.assert_allclose(
        basis[1], [0.28209479, 0.0, 0.0, 0.48860251], atol=1e-6
    )


def test_sh_to_rgb_golden():
    # Same fixture as the reference SH forward test.
    xyz = jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    campos = jnp.zeros(3)
    dc = jnp.array([[0.5, -0.2, 0.8], [0.1, 0.5, 0.9]])
    sh_hi = np.zeros((2, 15, 3), np.float32)
    sh_hi[0, :3] = [[0.1] * 3, [0.2] * 3, [0.3] * 3]
    sh_hi[1, :3] = [[0.2, 0.6, 0.0], [0.3, 0.7, 0.1], [0.4, 0.8, 0.2]]
    rgb = np.asarray(sh.sh_to_rgb(xyz, dc, jnp.asarray(sh_hi), campos, 1))
    c0, c1 = 0.28209479, 0.48860251
    np.testing.assert_allclose(
        rgb[0],
        [0.5 * c0 + 0.5 + 0.2 * c1, -0.2 * c0 + 0.5 + 0.2 * c1,
         0.8 * c0 + 0.5 + 0.2 * c1],
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        rgb[1],
        [0.1 * c0 + 0.5 + 0.4 * c1, 0.5 * c0 + 0.5 + 0.8 * c1,
         0.9 * c0 + 0.5 + 0.2 * c1],
        rtol=1e-4,
    )


def test_sh_basis_orthonormal():
    """Monte-Carlo orthonormality of the full l<=3 basis on the sphere."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(200000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    basis = np.asarray(sh.sh_basis(jnp.asarray(v, dtype=jnp.float32), 3))
    gram = (basis.T @ basis) * (4 * np.pi / v.shape[0])
    np.testing.assert_allclose(gram, np.eye(16), atol=0.05)


def _fd_check(fn, args, argnum, rel=5e-2, atol=1e-4, eps=1e-3, samples=8):
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=argnum)(
        *args
    )
    g = np.asarray(grads)
    x0 = np.asarray(args[argnum])
    rng = np.random.default_rng(0)
    flat = x0.reshape(-1)
    for _ in range(samples):
        i = rng.integers(0, flat.size)
        xp = flat.copy()
        xp[i] += eps
        up = float(
            jnp.sum(jnp.sin(fn(*[
                jnp.asarray(xp.reshape(x0.shape)) if j == argnum else a
                for j, a in enumerate(args)
            ])))
        )
        xp[i] -= 2 * eps
        dn = float(
            jnp.sum(jnp.sin(fn(*[
                jnp.asarray(xp.reshape(x0.shape)) if j == argnum else a
                for j, a in enumerate(args)
            ])))
        )
        fd = (up - dn) / (2 * eps)
        assert g.reshape(-1)[i] == pytest.approx(fd, rel=rel, abs=atol), i


def test_grad_sigma_finite_difference():
    rng = np.random.default_rng(4)
    quat = jnp.asarray(rng.normal(size=(5, 4)).astype(np.float32))
    scale = jnp.asarray(rng.uniform(-1, 0.5, (5, 3)).astype(np.float32))
    _fd_check(covariance.sigma_from_quat_scale, (quat, scale), 0)
    _fd_check(covariance.sigma_from_quat_scale, (quat, scale), 1)


def test_grad_conic_finite_difference():
    rng = np.random.default_rng(5)
    sigma = covariance.sigma_from_quat_scale(
        jnp.asarray(rng.normal(size=(4, 4)).astype(np.float32)),
        jnp.asarray(rng.uniform(-1, 0.5, (4, 3)).astype(np.float32)),
    )
    jac = jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))
    view = jnp.asarray(np.eye(4, dtype=np.float32))

    def conic_only(s, j):
        c, _ = covariance.conic_and_radius(s, j, view, 3.0)
        return c

    _fd_check(conic_only, (sigma, jac), 0, rel=1e-1)
    _fd_check(conic_only, (sigma, jac), 1, rel=1e-1)


def test_grad_projection_chain_finite_difference():
    cm = build_camera_matrices(
        np.array([0.9, 0.1, 0.3, 0.2]), np.array([0.5, -0.2, 1.0]),
        64, 48, 40.0, 42.0,
    )
    rng = np.random.default_rng(6)
    xyz = jnp.asarray((rng.normal(size=(6, 3)) + [0, 0, 5]).astype(np.float32))
    view = jnp.asarray(cm.view)
    proj = jnp.asarray(cm.proj)

    def uv_fn(x):
        return projection.project_to_screen(
            projection.world_to_camera(x, view), proj, 64, 48
        )

    _fd_check(uv_fn, (xyz,), 0, rel=5e-2, atol=5e-3)

    def jac_fn(x):
        return projection.projection_jacobian(
            projection.world_to_camera(x, view),
            cm.focal_x, cm.focal_y, cm.tan_fovx, cm.tan_fovy,
        )

    _fd_check(jac_fn, (xyz,), 0, rel=1e-1, atol=5e-3)


def test_grad_sh_finite_difference():
    rng = np.random.default_rng(7)
    xyz = jnp.asarray((rng.normal(size=(5, 3)) * 3).astype(np.float32))
    dc = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    shc = jnp.asarray(rng.normal(size=(5, 15, 3)).astype(np.float32) * 0.3)
    campos = jnp.asarray(np.array([0.3, -0.5, 0.2], np.float32))

    fn = lambda x, d, s: sh.sh_to_rgb(x, d, s, campos, 3)  # noqa: E731
    _fd_check(fn, (xyz, dc, shc), 0, rel=5e-2, atol=2e-3)
    _fd_check(fn, (xyz, dc, shc), 1)
    _fd_check(fn, (xyz, dc, shc), 2)
