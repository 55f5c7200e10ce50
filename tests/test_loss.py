"""Fused SSIM+L1 loss tests (reference strategy: closed-form uniform-image
SSIM + finite-difference gradient checks on interior pixels, mirroring
tests/cuda_forward_test.cpp:783-915)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_jax.ops.loss import C1, C2, compute_psnr, fused_loss


def test_uniform_image_closed_form():
    """For constant images the SSIM reduces to the luminance term."""
    h, w = 40, 48
    a, b = 0.3, 0.7
    pred = jnp.full((h, w, 3), a, jnp.float32)
    gt = jnp.full((h, w, 3), b, jnp.float32)
    ssim_weight = 0.2
    lum = (2 * a * b + C1) / (a * a + b * b + C1)
    # sigma terms are 0 -> structure term = C2/C2 = 1
    expected = (1 - ssim_weight) * abs(a - b) + ssim_weight * (1 - lum)
    loss = fused_loss(pred, gt, ssim_weight)
    assert float(loss) == pytest.approx(expected, rel=1e-4)


def test_identical_images_zero_loss():
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    assert float(fused_loss(img, img, 0.2)) == pytest.approx(0.0, abs=1e-6)
    assert float(compute_psnr(img, img)) == 100.0


def test_gradient_finite_difference_interior():
    """Backward parity: on interior pixels (away from the clamp-vs-zero
    padding asymmetry at borders) the reference backward equals the true
    gradient; check via central differences."""
    rng = np.random.default_rng(2)
    h, w = 24, 24
    pred0 = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
    gt = jnp.asarray(rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32))
    ssim_weight = 0.2

    grad = jax.grad(lambda x: fused_loss(x, gt, ssim_weight))(
        jnp.asarray(pred0)
    )
    grad = np.asarray(grad)

    f = lambda x: float(fused_loss(jnp.asarray(x), gt, ssim_weight))  # noqa
    # eps large enough that (up - dn) clears fp32 rounding of the scalar
    # loss; samples near the L1 kink |pred-gt| < 2*eps are skipped.
    eps = 5e-3
    rng2 = np.random.default_rng(3)
    checked = 0
    tries = 0
    while checked < 10 and tries < 100:
        tries += 1
        # interior pixels only (>= 11 taps + halo from each border)
        y = rng2.integers(11, h - 11)
        x = rng2.integers(11, w - 11)
        c = rng2.integers(0, 3)
        if abs(pred0[y, x, c] - float(gt[y, x, c])) < 2 * eps:
            continue
        p = pred0.copy()
        p[y, x, c] += eps
        up = f(p)
        p[y, x, c] -= 2 * eps
        dn = f(p)
        fd = (up - dn) / (2 * eps)
        assert grad[y, x, c] == pytest.approx(fd, rel=5e-2, abs=2e-5), (
            f"pixel ({y},{x},{c})"
        )
        checked += 1
    assert checked >= 10


def test_psnr():
    pred = jnp.zeros((8, 8, 3), jnp.float32)
    gt = jnp.full((8, 8, 3), 0.1, jnp.float32)
    # mse = 0.01 -> psnr = 20
    assert float(compute_psnr(pred, gt)) == pytest.approx(20.0, rel=1e-4)
