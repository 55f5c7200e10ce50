"""16-bit pair packing of the tile sort's payload (ops/binning.py).

The attribute payload rides the tile sort as four int32 words instead of
nine f32 columns; these pack/unpack pairs define the bit format. Packing
stays in the integer domain end to end (bf16/f16 patterns ride int32
operands).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pack_bf16_pair(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """Two f32 arrays -> one int32 of packed bf16 halves (rounded).

    A bf16-exact
    f32 has zero low mantissa bits, so its bf16 pattern IS the high half
    — packing bf16-exact values is lossless and idempotent."""
    h = jax.lax.bitcast_convert_type(
        hi.astype(jnp.bfloat16).astype(jnp.float32), jnp.uint32
    )
    l = jax.lax.bitcast_convert_type(
        lo.astype(jnp.bfloat16).astype(jnp.float32), jnp.uint32
    )
    return jax.lax.bitcast_convert_type(
        (h & jnp.uint32(0xFFFF0000)) | (l >> 16), jnp.int32
    )


def unpack_bf16_pair(packed: jnp.ndarray):
    """Inverse of pack_bf16_pair: int32 -> (hi, lo) f32 arrays."""
    u = jax.lax.bitcast_convert_type(packed, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        u & jnp.uint32(0xFFFF0000), jnp.float32
    )
    lo = jax.lax.bitcast_convert_type(u << 16, jnp.float32)
    return hi, lo


def pack_f16_pair(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """Two f32 arrays -> one int32 of packed IEEE f16 halves.

    Used for TILE-RELATIVE screen positions, where magnitude is bounded
    by the splat's reach from the tile: sub-0.01px rounding inside the
    tile, ~2^-11-relative at distance. Callers must keep inputs within
    f16 range (+-65504); see the clamp at the tile-sort pack site."""
    h = jax.lax.bitcast_convert_type(
        hi.astype(jnp.float16), jnp.uint16
    ).astype(jnp.uint32)
    l = jax.lax.bitcast_convert_type(
        lo.astype(jnp.float16), jnp.uint16
    ).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type((h << 16) | l, jnp.int32)


def unpack_f16_pair(packed: jnp.ndarray):
    """Inverse of pack_f16_pair: int32 -> (hi, lo) f32 arrays."""
    u = jax.lax.bitcast_convert_type(packed, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        (u >> 16).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    lo = jax.lax.bitcast_convert_type(
        u.astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    return hi, lo


# Shared-exponent triple word: [E:5 | qa:9 | qb:9 | qc:9], one int32. Each
# channel is a signed 9-bit code q in [-255, 255] (stored offset-256) at
# scale 2^(E - bias) / 128, E chosen from the largest |channel|: rounding
# error <= amax/256 (0.2-0.4% of the largest channel — the same absolute
# scale as per-channel bf16 on the largest channel, traded for one fewer
# sort operand). Covers amax in [2^-bias, 2^(31-bias)]; larger clamps,
# smaller flushes to 0. With bias 20, |c| in [2^-20, 2^11] is far outside
# any real color (reference colors are DC*Y0 + 0.5 + higher SH terms).
#
# ACCEPTED TRADEOFF: a channel much smaller than its siblings carries
# large relative error (or flushes) because the shared exponent follows
# the largest channel — per-pair error is amax-relative, not per-channel.
_RGB_BIAS = 20


def pack_rgb_e5(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray,
                bias: int = _RGB_BIAS):
    """Three f32 arrays -> one int32 shared-exponent triple word."""
    amax = jnp.maximum(jnp.maximum(jnp.abs(r), jnp.abs(g)), jnp.abs(b))
    # Exponent of amax via bit math (amax >= 0; zero -> exponent field 0
    # -> e clamps to 0 and all q round to 0).
    ebits = (
        jax.lax.bitcast_convert_type(amax, jnp.uint32) >> 23
    ).astype(jnp.int32) - 127
    e = jnp.clip(ebits + bias, 0, 31)
    # inv_scale = 2^(7 - (e - bias)) built directly from exponent bits.
    inv_scale = jax.lax.bitcast_convert_type(
        ((134 - e + bias) << 23).astype(jnp.uint32), jnp.float32
    )

    def q(c):
        qi = jnp.clip(
            jnp.round(c * inv_scale), -255.0, 255.0
        ).astype(jnp.int32)
        return (qi + 256).astype(jnp.uint32)

    word = (
        (e.astype(jnp.uint32) << 27) | (q(r) << 18) | (q(g) << 9) | q(b)
    )
    return jax.lax.bitcast_convert_type(word, jnp.int32)


def unpack_rgb_e5(word: jnp.ndarray, bias: int = _RGB_BIAS):
    """Inverse of pack_rgb_e5: int32 -> (r, g, b) f32 arrays."""
    u = jax.lax.bitcast_convert_type(word, jnp.uint32)
    e = (u >> 27).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        ((120 + e - bias) << 23).astype(jnp.uint32), jnp.float32
    )

    def c(shift):
        qi = ((u >> shift) & jnp.uint32(0x1FF)).astype(jnp.int32) - 256
        return qi.astype(jnp.float32) * scale

    return c(18), c(9), c(0)
