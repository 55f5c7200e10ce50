"""Visibility-masked fused Adam (jitted JAX).

Parity with the reference optimizer (cuda/optimizer.cu:6-29
driven by trainer.cu:1027-1135):

- B1=0.9, B2=0.999, EPS=1e-8 (optimizer.cuh:8-10);
- bias corrections 1 - beta^(iter+1) computed once per step from the global
  iteration counter (trainer.cu:1046-1047);
- NaN gradients are zeroed (optimizer.cu:15-16);
- crucially, only *visible* Gaussians step: the reference compacts params and
  moments by the cull mask, steps the compacted set, and scatters back
  (trainer.cu:1028-1085), so invisible Gaussians' moments do NOT decay. Here
  that is a dense jnp.where on the mask — the dense equivalent of
  compact/step/scatter with zero data movement.
"""

from __future__ import annotations

import jax.numpy as jnp

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def masked_adam_update(
    param: jnp.ndarray,
    grad: jnp.ndarray,
    m: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,  # (N,) bool — visible & alive
    lr: jnp.ndarray,  # scalar (possibly traced, e.g. decayed xyz lr)
    bias1: jnp.ndarray,
    bias2: jnp.ndarray,
):
    """One Adam step on rows where mask is True; others unchanged."""
    if mask.ndim < param.ndim:
        mask = mask.reshape(mask.shape + (1,) * (param.ndim - mask.ndim))
    g = jnp.where(jnp.isnan(grad), 0.0, grad)
    m_new = B1 * m + (1.0 - B1) * g
    v_new = B2 * v + (1.0 - B2) * g * g
    m_hat = m_new / bias1
    v_hat = v_new / bias2
    step = -lr * m_hat / (jnp.sqrt(v_hat) + EPS)
    return (
        jnp.where(mask, param + step, param),
        jnp.where(mask, m_new, m),
        jnp.where(mask, v_new, v),
    )
