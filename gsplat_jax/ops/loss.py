"""Fused SSIM + L1 loss and PSNR (jitted JAX, custom VJP).

Parity with the reference fused loss (cuda/loss.cu):

- 11-tap separable Gaussian window, sigma=1.5, hardcoded taps (loss.cu:14-17),
  C1=(0.01)^2, C2=(0.03)^2 (loss.cu:19-25);
- forward convolutions use CLAMPED (edge-replicate) padding
  (get_pix_value_clamped_rgb, loss.cu:42-47);
- loss = mean over pixels*channels of (1-w)*|x-y| + w*(1-SSIM) (loss.cu:246,470);
- the backward is NOT the true AD of the forward: the reference convolves the
  stored partial-derivative maps with ZERO padding (get_pix_value_zero via
  loss.cu:339-341) and adds the L1 sign term, all scaled by 1/(H*W*3)
  (loss.cu:415-425). We implement exactly that as a custom VJP, so training
  dynamics match the reference bit-for-bit in structure.

Mapping: the separable convolutions run as dense banded-matrix
contractions (HIGHEST precision, so f32 on the GPU rather than TF32)
instead of unrolled shifted slices. Edge-replicate / zero padding fold
into the band matrix weights, so no explicit pad exists. The whole
pipeline runs CHANNEL-MAJOR (C, H, W), so the image width is the minor,
contiguous axis of every elementwise op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Hardcoded 11-tap Gaussian, sigma = 1.5 (loss.cu:14-17). numpy (not jnp):
# a module-level device array would initialize the XLA backend at import
# time, breaking jax.distributed.initialize in multi-host entrypoints.
GAUSS_TAPS = np.array(
    [
        0.001028380123898387, 0.0075987582094967365, 0.036000773310661316,
        0.10936068743467331, 0.21300552785396576, 0.26601171493530273,
        0.21300552785396576, 0.10936068743467331, 0.036000773310661316,
        0.0075987582094967365, 0.001028380123898387,
    ],
    dtype=np.float32,
)
HALO = 5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, pad_mode: str) -> np.ndarray:
    """(N, N) band matrix A with A[i, j] = total tap weight flowing from
    input pixel i to output pixel j; 'edge' folds the clamped-replication
    boundary handling into the edge rows, 'zero' drops out-of-range taps."""
    a = np.zeros((n, n), np.float32)
    for d in range(11):
        for j in range(n):
            i = j + d - HALO
            if pad_mode == "edge":
                i = min(max(i, 0), n - 1)
            elif i < 0 or i >= n:
                continue
            a[i, j] += GAUSS_TAPS[d]
    return a


def _band_pass_axis1(x: jnp.ndarray, a_np: np.ndarray,
                     tile: int = 256) -> jnp.ndarray:
    """Contract axis 1 of (C, N, D) against the (N, N) band matrix in
    HALO-BLOCKED column tiles: output columns [j0, j1) only read input
    rows [j0-HALO, j1+HALO), so each tile is a (C, halo_rows, D) x
    (halo_rows, T) dot — ~4-5x fewer flops than the dense (N, N)
    contraction at this image size, identical values (the dropped band
    entries are exact zeros). Output = (C, D, N): the filtered axis cycles
    to the back exactly like the dense dot_general did."""
    c, n, d = x.shape
    hi = jax.lax.Precision.HIGHEST
    outs = []
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        i0, i1 = max(0, j0 - HALO), min(n, j1 + HALO)
        blk = jnp.asarray(a_np[i0:i1, j0:j1])
        outs.append(
            jax.lax.dot_general(
                x[:, i0:i1, :], blk, (((1,), (0,)), ((), ())), precision=hi
            )
        )  # (C, D, j1-j0)
    return jnp.concatenate(outs, axis=2)


def _sep_conv(img: jnp.ndarray, pad_mode: str) -> jnp.ndarray:
    """11x11 separable Gaussian filter on CHANNEL-MAJOR (C, H, W).

    Both passes are banded-matrix contractions that keep the (C, H, W)
    layout (each pass cycles the filtered axis to the back), halo-blocked
    (_band_pass_axis1). HIGHEST precision: the windowed moments feed
    variance differences (E[x^2] - mu^2) whose cancellation would amplify
    bf16 rounding."""
    c, h, w = img.shape
    ah = _band_matrix(h, pad_mode)
    aw = _band_matrix(w, pad_mode)
    # (C, H, W) -> (C, W, Hf) -> (C, Hf, Wf)
    t = _band_pass_axis1(img, ah)
    return _band_pass_axis1(t, aw)


def _ssim_stats(pred: jnp.ndarray, gt: jnp.ndarray):
    """Windowed moments with edge-clamped padding (forward kernel parity).

    Inputs and outputs are channel-major (C, H, W)."""
    stacked = jnp.concatenate(
        [pred, gt, pred * pred, gt * gt, pred * gt], axis=0
    )
    conv = _sep_conv(stacked, "edge")
    c = pred.shape[0]
    mu1 = conv[0:c]
    mu2 = conv[c : 2 * c]
    ex2 = conv[2 * c : 3 * c]
    ey2 = conv[3 * c : 4 * c]
    exy = conv[4 * c : 5 * c]
    sigma1_sq = ex2 - mu1 * mu1
    sigma2_sq = ey2 - mu2 * mu2
    sigma12 = exy - mu1 * mu2
    return mu1, mu2, sigma1_sq, sigma2_sq, sigma12


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def fused_loss(pred: jnp.ndarray, gt: jnp.ndarray, ssim_weight: float):
    """Scalar (1-w)*L1 + w*(1-SSIM) loss over an (H, W, 3) image pair."""
    loss, _ = _fused_loss_fwd_impl(pred, gt, ssim_weight)
    return loss


def _fused_loss_fwd_impl(pred, gt, ssim_weight):
    # Channel-major internally; the (H, W, 3) interface transposes once at
    # each boundary (~10 MB moves, negligible next to lane-full elementwise).
    pred = pred.transpose(2, 0, 1)
    gt = gt.transpose(2, 0, 1)
    mu1, mu2, s1, s2, s12 = _ssim_stats(pred, gt)
    a = mu1 * mu1 + mu2 * mu2 + C1
    b = s1 + s2 + C2
    c_ = 2.0 * mu1 * mu2 + C1
    d_ = 2.0 * s12 + C2
    ssim = (c_ * d_) / (a * b)
    l1 = jnp.abs(pred - gt)
    loss = jnp.mean((1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim))

    # Partial-derivative maps stored by the forward kernel (loss.cu:251-260).
    d_mu1 = (
        (mu2 * 2.0 * d_) / (a * b)
        - (mu2 * 2.0 * c_) / (a * b)
        - (mu1 * 2.0 * c_ * d_) / (a * a * b)
        + (mu1 * 2.0 * c_ * d_) / (a * b * b)
    )
    d_s1 = (-c_ * d_) / (a * b * b)
    d_s12 = (2.0 * c_) / (a * b)
    maps = (
        -ssim_weight * d_mu1,
        -ssim_weight * d_s1,
        -ssim_weight * d_s12,
    )
    return loss, maps


def _fused_loss_fwd(pred, gt, ssim_weight):
    loss, maps = _fused_loss_fwd_impl(pred, gt, ssim_weight)
    # Residuals channel-major (the backward works in (C, H, W) too).
    return loss, (pred.transpose(2, 0, 1), gt.transpose(2, 0, 1), maps)


def _fused_loss_bwd(ssim_weight, res, g):
    pred, gt, (dm_mu1, dm_s1, dm_s12) = res  # all (C, H, W)
    c, h, w = pred.shape
    # Zero-padded convolution of the derivative maps (loss.cu:339-341 uses
    # get_pix_value_zero) — intentionally not the adjoint of the edge-clamped
    # forward conv; reference behavior.
    stacked = jnp.concatenate([dm_mu1, dm_s1, dm_s12], axis=0)
    conv = _sep_conv(stacked, "zero")
    sum0 = conv[0:c]
    sum1 = conv[c : 2 * c]
    sum2 = conv[2 * c : 3 * c]
    ssim_grad = sum0 + (2.0 * pred) * sum1 + gt * sum2
    l1_grad = (1.0 - ssim_weight) * jnp.where(pred > gt, 1.0, -1.0)
    grad = (ssim_grad + l1_grad) / float(h * w * c)
    return ((g * grad).transpose(1, 2, 0), jnp.zeros((h, w, c), gt.dtype))


fused_loss.defvjp(_fused_loss_fwd, _fused_loss_bwd)


def compute_psnr(pred: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """10*log10(1/MSE); 100.0 on exact match (loss.cu:510-525)."""
    mse = jnp.mean((pred - gt) ** 2)
    return jnp.where(mse == 0.0, 100.0, 10.0 * jnp.log10(1.0 / mse))
