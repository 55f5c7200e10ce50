"""Morton (Z-order) codes for spatial re-sorting (jitted JAX).

The reference interleaves 21 bits per axis into a 63-bit code
(cuda/culling.cu:14-67) and re-sorts all Gaussian arrays by
it after densification for memory coherence (trainer.cu:871-924). JAX runs
with 32-bit integers here, so we quantize to 10 bits per axis into a 30-bit
int32 code — the sort exists purely for data locality of the pair stream, so
the coarser key changes nothing observable. Divergence documented here.
"""

from __future__ import annotations

import jax.numpy as jnp

BITS = 10
MAXC = (1 << BITS) - 1


def _spread_bits_10(n: jnp.ndarray) -> jnp.ndarray:
    """Insert two zero bits between each of the low 10 bits (int32)."""
    n = n & MAXC
    n = (n | (n << 16)) & 0x030000FF
    n = (n | (n << 8)) & 0x0300F00F
    n = (n | (n << 4)) & 0x030C30C3
    n = (n | (n << 2)) & 0x09249249
    return n


def morton_codes(xyz: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """30-bit interleaved codes; masked-out rows get the max key (sort last)."""
    big = jnp.float32(1e30)
    lo = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], xyz, -big), axis=0)
    span = jnp.maximum(hi - lo, 1e-12)
    q = ((xyz - lo) * (MAXC / span)).astype(jnp.int32)
    q = jnp.clip(q, 0, MAXC)
    code = (
        (_spread_bits_10(q[:, 2]) << 2)
        | (_spread_bits_10(q[:, 1]) << 1)
        | _spread_bits_10(q[:, 0])
    )
    return jnp.where(mask, code, jnp.int32(0x7FFFFFFF))
