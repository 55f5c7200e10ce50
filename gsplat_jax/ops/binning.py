"""Tile binning + depth sort (jitted JAX, fixed shapes).

Redesign of the reference's binning stage
(cuda/culling.cu:97-343,386-475), which allocates pairs with
warp-aggregated atomics and radix-sorts a composite uint64
``z + (max_z+1)*tile`` key. Here:

1. EXACT two-level expansion IN ORIGINAL GAUSSIAN ORDER: level 1 enumerates
   each Gaussian's tile ROWS (y-AABB); level 2 computes the exact x-interval
   of the OBB within each 16px strip in closed form (fuzz-verified equal to
   the reference's 4-axis SAT, culling.cu:97-165) — candidates EQUAL true
   pairs (plus one invalid sentinel per empty row and per masked Gaussian),
   so nothing is conservatively over-enumerated or filtered afterwards.
   Each level lays its records' slots out back to back by an exclusive
   cumsum of the counts, finds each slot's owner with a scatter and a
   cumsum (segment_ids), then gathers the owner's values. Every record (even masked/empty) owns
   >= 1 slot, so no visibility-compaction pass is needed.
2. ONE sort produces tile-major depth-ascending order: key1 packs
   (tile_idx << qd_bits) | quantized_depth into a single int32 — the
   analogue of the reference's composite 64-bit radix key — and key2 is the
   Gaussian id (a deterministic tiebreak: a Gaussian contributes at most
   one pair per tile, so the full key is unique). The attribute payload
   rides the sort as packed words (kernels/packing.py) and is unpacked into
   the f32 pair stream after it.
   Depth is quantized to qd_bits (<= 16) log-spaced buckets (~2e-4 relative
   z at 16 bits); candidates with equal quantized depth composite in
   Gaussian-id order — a documented divergence from the reference's exact
   f32 ordering that only reorders near-coincident splats (the reference's
   radix ties are insertion-order arbitrary too).
3. Tile ranges come from searchsorted at the qd_bits-aligned key boundaries
   (replacing find_tile_boundaries); pair slot == sorted slot (the
   rasterizer masks unaligned ranges), so no remap scatter and no chunk
   padding exist.

Everything is fixed-shape: capacities are static; on overflow pairs are
dropped deterministically and ``overflow`` reports the required size so the
host can re-jit with a larger bucket (2^19-granular, see
train/state.round_pair_cap).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Depth quantization: log2-spaced buckets over Z0 * 2^[0, OCTAVES). At the
# default 16 key bits that is 2048 buckets per octave (~3.4e-4 relative z)
# over z in [1e-4, 4.3e5] — far below any visible compositing-order scale.
_QD_Z0 = 1e-4
_QD_OCTAVES = 32.0


def depth_key_bits(num_tiles: int) -> int:
    """Quantized-depth bits packed below the tile index in the sort key."""
    return max(1, min(16, 30 - int(num_tiles).bit_length()))


def quantize_depth(z: jnp.ndarray, qd_bits: int) -> jnp.ndarray:
    """z -> int32 log-spaced depth bucket in [0, 2^qd_bits)."""
    levels = float(1 << qd_bits)
    scale = levels / _QD_OCTAVES
    q = jnp.floor(
        (jnp.log2(jnp.maximum(z, _QD_Z0)) - jnp.log2(_QD_Z0)) * scale
    )
    return jnp.clip(q, 0.0, levels - 1.0).astype(jnp.int32)


class TileTables(NamedTuple):
    """Sorted splat attribute stream + per-tile ranges.

    ``splat_gid`` is the tile sort's Gaussian-id key operand: pair slot ->
    original Gaussian index (-1 for the invalid tail). It is both the test
    oracle's splat list and the key of the backward's per-Gaussian sums.
    """

    splat_gid: jnp.ndarray  # (P_cap,) int32 gaussian index, -1 = invalid tail
    tile_start: jnp.ndarray  # (T,) int32 first pair slot of each tile
    tile_count: jnp.ndarray  # (T,) int32 number of splats per tile
    num_pairs: jnp.ndarray  # () int32 — valid pair count
    overflow: jnp.ndarray  # () int32 — required PAIR capacity (check >
    #                        P_cap). With the derived (row_cap=None) sizing
    #                        it also folds in 2*row_overflow so single-cap
    #                        growth covers row truncation.
    row_overflow: jnp.ndarray  # () int32 — required ROW capacity (check
    #                            > row_cap when row_cap was passed)
    stream: jnp.ndarray  # (9, P_cap) f32 pair rows [u v c00 c01 c11 opa r
    #                      g b], global pixel uv, invalid tail zeroed. With
    #                      bf16_colors the values carry the packed payload's
    #                      rounding (f16 tile-relative uv, bf16 conic and
    #                      opacity, shared-exponent rgb).


def tile_spans(
    uv: jnp.ndarray,
    radius: jnp.ndarray,
    mask: jnp.ndarray,
    num_tiles_x: int,
    num_tiles_y: int,
    tile_size: int,
):
    """Per-Gaussian candidate tile spans: the exact AABB of the OBB.

    The reference's coarse pass uses a bounding square of
    ``ceil(r_major/tile)+1`` tiles (culling.cu:212-219) — loose for small
    Gaussians (>= 5x5 tiles each) and lossy for very large ones (the square
    under-covers the OBB's AABB once r_major(sqrt(2)-1) > tile). We instead
    take the OBB's exact axis-aligned extents
    ``hx = r_major|cos| + r_minor|sin|`` (resp. hy) so the candidate set both
    covers every SAT hit and is ~5x smaller; the exact strip filter then
    yields the same final pair set.
    """
    u, v = uv[:, 0], uv[:, 1]
    r_major, r_minor = radius[:, 0], radius[:, 1]
    sin_t, cos_t = jnp.abs(radius[:, 2]), jnp.abs(radius[:, 3])
    hx = r_major * cos_t + r_minor * sin_t
    hy = r_major * sin_t + r_minor * cos_t
    tx0 = jnp.floor((u - hx) / tile_size).astype(jnp.int32)
    tx1 = jnp.floor((u + hx) / tile_size).astype(jnp.int32) + 1
    ty0 = jnp.floor((v - hy) / tile_size).astype(jnp.int32)
    ty1 = jnp.floor((v + hy) / tile_size).astype(jnp.int32) + 1
    tx0 = jnp.clip(tx0, 0, num_tiles_x)
    tx1 = jnp.clip(tx1, 0, num_tiles_x)
    ty0 = jnp.clip(ty0, 0, num_tiles_y)
    ty1 = jnp.clip(ty1, 0, num_tiles_y)
    num_x = jnp.maximum(0, tx1 - tx0)
    num_y = jnp.maximum(0, ty1 - ty0)
    counts = jnp.where(mask, num_x * num_y, 0).astype(jnp.int32)
    return tx0, ty0, num_x, num_y, counts


def obb_tile_intersects(
    u: jnp.ndarray,
    v: jnp.ndarray,
    radius: jnp.ndarray,  # (..., 4) [r_major r_minor sin cos]
    tile_x: jnp.ndarray,
    tile_y: jnp.ndarray,
    tile_size: int,
    extent: float | None = None,
) -> jnp.ndarray:
    """Exact OBB vs axis-aligned tile separating-axis test.

    Vectorized port of the 4-axis SAT of culling.cu:97-165 (x axis, y axis,
    OBB major axis, OBB minor axis) with the OBB corners from compute_obb.
    ``extent`` sets the tested rect to [t*ts, t*ts + extent] (default: the
    full tile rect, reference parity); the product binning tests the PIXEL
    rect (extent = tile_size - 1: pixel centers sit at integer offsets
    0..ts-1), which is value-exact and slightly tighter.
    """
    if extent is None:
        extent = float(tile_size)
    r_major, r_minor = radius[..., 0], radius[..., 1]
    sin_t, cos_t = radius[..., 2], radius[..., 3]

    v1x = r_major * cos_t
    v1y = r_major * sin_t
    v2x = -r_minor * sin_t
    v2y = r_minor * cos_t

    # Corners: bl, br, tl, tr (culling.cu:157-164).
    blx, bly = u - v1x - v2x, v - v1y - v2y
    brx, bry = u + v1x - v2x, v + v1y - v2y
    tlx, tly = u - v1x + v2x, v - v1y + v2y
    trx, try_ = u + v1x + v2x, v + v1y + v2y

    left = tile_x.astype(jnp.float32) * tile_size
    right = left + extent
    top = tile_y.astype(jnp.float32) * tile_size
    bottom = top + extent

    # Axis 0: X
    obb_min_x = jnp.minimum(jnp.minimum(blx, brx), jnp.minimum(tlx, trx))
    obb_max_x = jnp.maximum(jnp.maximum(blx, brx), jnp.maximum(tlx, trx))
    ok = (obb_min_x <= right) & (obb_max_x >= left)

    # Axis 1: Y
    obb_min_y = jnp.minimum(jnp.minimum(bly, bry), jnp.minimum(tly, try_))
    obb_max_y = jnp.maximum(jnp.maximum(bly, bry), jnp.maximum(tly, try_))
    ok &= (obb_min_y <= bottom) & (obb_max_y >= top)

    def _axis_test(ax, ay, pa_x, pa_y, pb_x, pb_y):
        t1 = ax * left + ay * top
        t2 = ax * right + ay * top
        t3 = ax * left + ay * bottom
        t4 = ax * right + ay * bottom
        tile_min = jnp.minimum(jnp.minimum(t1, t2), jnp.minimum(t3, t4))
        tile_max = jnp.maximum(jnp.maximum(t1, t2), jnp.maximum(t3, t4))
        o1 = ax * pa_x + ay * pa_y
        o2 = ax * pb_x + ay * pb_y
        obb_min = jnp.minimum(o1, o2)
        obb_max = jnp.maximum(o1, o2)
        return (tile_min <= obb_max) & (tile_max >= obb_min)

    # Axis 2: OBB major axis (br - bl), projections of br and bl corners.
    ok &= _axis_test(brx - blx, bry - bly, brx, bry, blx, bly)
    # Axis 3: OBB minor axis (br - tr), projections of br and tr corners.
    ok &= _axis_test(brx - trx, bry - try_, brx, bry, trx, try_)
    return ok


def _strip_x_extreme(u, a1x, a1y, a2x, a2y, dy0, dy1):
    """Exact max-x of the OBB restricted to the strip dy in [dy0, dy1].

    OBB points: (s*a1x + t*a2x, s*a1y + t*a2y) around center, |s|,|t| <= 1;
    dy measured relative to the center. If the unconstrained maximizer's y
    falls inside the strip, the answer is the OBB's global x-extent;
    otherwise the maximum lies on the clamped y level and the LP optimum has
    s or t at a bound (4 candidate vertices). Returns -inf (plus u) when the
    OBB does not reach the strip. Exact vs the 4-axis SAT test (fuzzed).
    """
    s0 = jnp.sign(jnp.where(a1x == 0, 1.0, a1x))
    t0 = jnp.sign(jnp.where(a2x == 0, 1.0, a2x))
    y_at = s0 * a1y + t0 * a2y
    x_unc = jnp.abs(a1x) + jnp.abs(a2x)
    d = jnp.clip(y_at, dy0, dy1)
    in_range = (y_at >= dy0) & (y_at <= dy1)
    eps = 1e-20
    a1y_s = jnp.where(jnp.abs(a1y) < eps, eps, a1y)
    a2y_s = jnp.where(jnp.abs(a2y) < eps, eps, a2y)
    cands = []
    for sv in (1.0, -1.0):
        t = (d - sv * a1y) / a2y_s
        ok = jnp.abs(t) <= 1.0 + 1e-5
        cands.append(jnp.where(ok, sv * a1x + jnp.clip(t, -1, 1) * a2x,
                               -jnp.inf))
    for tv in (1.0, -1.0):
        s = (d - tv * a2y) / a1y_s
        ok = jnp.abs(s) <= 1.0 + 1e-5
        cands.append(jnp.where(ok, jnp.clip(s, -1, 1) * a1x + tv * a2x,
                               -jnp.inf))
    x_con = jnp.maximum(jnp.maximum(cands[0], cands[1]),
                        jnp.maximum(cands[2], cands[3]))
    return u + jnp.where(in_range, x_unc, x_con)


def _strip_x_extreme_ell(u, e1x, e1y, e2x, e2y, dy0, dy1):
    """Exact max-x of the ELLIPSE {s*e1 + t*e2 : s^2+t^2 <= 1} within the
    strip dy in [dy0, dy1] (dy relative to the center).

    The disk analogue of _strip_x_extreme's square LP: with vx = (e1x,e2x),
    vy = (e1y,e2y) in the (s,t) parameter plane, maximize vx.p subject to
    vy.p = d (the clamped strip level) and |p| <= 1. Decompose
    vx = alpha*vy + w with w perp vy: on the level set vx.p = alpha*d + w.q
    where |q|^2 <= 1 - d^2/|vy|^2, so the constrained max is
    alpha*d + |w|*sqrt(1 - d^2/|vy|^2). If the unconstrained maximizer's
    y-level (vx.vy)/|vx| falls inside the strip, the answer is |vx|. Rows
    are enumerated from the ellipse's y-AABB, so every enumerated strip
    intersects [-|vy|, |vy|]; the d-clamp absorbs boundary fuzz (a strip
    fully outside the span has no above-cutoff pixels, so either branch is
    safe there)."""
    rx2 = e1x * e1x + e2x * e2x
    rx = jnp.sqrt(rx2)
    ry2 = e1y * e1y + e2y * e2y
    ry = jnp.sqrt(ry2)
    dot = e1x * e1y + e2x * e2y
    eps = 1e-20
    y_at = dot / jnp.maximum(rx, eps)
    in_range = (y_at >= dy0) & (y_at <= dy1)
    d = jnp.clip(jnp.clip(y_at, dy0, dy1), -ry, ry)
    alpha = dot / jnp.maximum(ry2, eps)
    w = jnp.sqrt(jnp.maximum(rx2 - alpha * dot, 0.0))
    x_con = alpha * d + w * jnp.sqrt(
        jnp.maximum(1.0 - (d * d) / jnp.maximum(ry2, eps), 0.0)
    )
    # Degenerate flat-in-y ellipse: the single enumerated strip contains
    # the center level, so the full x-extent applies.
    x_con = jnp.where(ry2 <= eps, rx, x_con)
    return u + jnp.where(in_range, rx, x_con)


def _span_y(v, a1y, a2y, s_e, tile_size, nty_eff):
    """Pixel-rect tile-row span of the OBB/ellipse intersection.

    hy = min(OBB y-extent, ellipse y-extent); tile row ty covers pixel rows
    ty*ts .. ty*ts + (ts-1), so ty is alive iff ty*ts <= v + hy AND
    ty*ts + (ts-1) >= v - hy."""
    hy = jnp.minimum(
        jnp.abs(a1y) + jnp.abs(a2y),
        s_e * jnp.sqrt(a1y * a1y + a2y * a2y),
    )
    ts = float(tile_size)
    ty0 = jnp.clip(
        jnp.ceil((v - hy - (ts - 1.0)) / ts).astype(jnp.int32), 0, nty_eff
    )
    ty1 = jnp.clip(
        jnp.floor((v + hy) / ts).astype(jnp.int32) + 1, 0, nty_eff
    )
    return ty0, ty1


from ..kernels.packing import (
    pack_bf16_pair, pack_f16_pair, pack_rgb_e5, unpack_bf16_pair,
    unpack_f16_pair, unpack_rgb_e5,
)


# Far-off screen position used to sanitize masked/empty records so their
# sentinel rows enumerate zero tiles through the SAME math as real rows
# (exactly representable in f32; any image is < 2^22 px).
_FAR = float(1 << 22)


def segment_ids(offsets: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Owning record of each of ``cap`` slots, records laid out back to
    back from their exclusive ``offsets`` (non-decreasing, from 0): the
    last record whose offset is <= the slot. Slots past the total map to
    the last record.

    One scatter-add of the record starts and a cumsum (the scheme of
    ``jnp.repeat(..., total_repeat_length=cap)``); offsets past ``cap``
    fall outside the scatter and are dropped."""
    starts = jnp.zeros((cap,), jnp.int32).at[offsets].add(1, mode="drop")
    return jnp.cumsum(starts, dtype=jnp.int32) - 1


def tile_sort(key, gid, payload: tuple) -> tuple:
    """Sort pairs by (key, gid); the payload columns ride the sort.

    XLA's own sort on the GPU. (key, gid) is unique for valid pairs, so the
    order is fully determined except inside the invalid tail."""
    return jax.lax.sort((key, gid) + tuple(payload), dimension=0,
                        is_stable=False, num_keys=2)


def build_tile_tables(
    uv: jnp.ndarray,
    z: jnp.ndarray,
    radius: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    attrs: jnp.ndarray,
    num_tiles_x: int,
    num_tiles_y: int,
    tile_size: int,
    pair_cap: int,
    row_cap: int | None = None,
    row_limit: jnp.ndarray | None = None,
    bf16_colors: bool = True,
    depth_rank: jnp.ndarray | None = None,
) -> TileTables:
    """Full binning pipeline; all inputs dense over the capacity axis.

    Args:
      uv: (N, 2) screen positions. z: (N,) camera depths. radius: (N, 4) OBB
      records. mask: (N,) visibility.
      attrs: (N, >=9) per-Gaussian attribute rows
        [u v c00 c01 c11 opa r g b ...] (ops/render.pack_attrs); the payload
        rides the tile sort to produce ``stream``. Values must match ``uv``
        in columns 0:2.
      row_limit: optional traced upper bound (<= num_tiles_y) on enumerated
        tile rows — used by tile-sharded rendering where the last strip's
        padding rows lie outside the global image.
      bf16_colors: the payload rides the sort as 4 packed int32 words
        (default) instead of 9 exact f32 columns.
      depth_rank: optional (N,) int32 dense depth rank (0 = nearest; e.g.
        argsort-of-argsort of z). EXACT-ORDERING MODE: the rank replaces
        the quantized log-depth as the sort key's depth field, so
        compositing order is the reference's exact f32 ordering
        (culling.cu:294-298) with Gaussian-id ties impossible. Available
        when bitlen(num_tiles) + bitlen(N-1) <= 30 (the packed int32 key
        budget); scripts/depth_quant_bound.py uses it to measure the
        default log-bucket divergence.

    Capacity semantics: every Gaussian record (visible or not) emits at
    least one tile row, and every row emits at least one candidate (empty
    ones as invalid sentinels), so ``row_cap`` must cover N + extra rows
    and ``pair_cap`` must cover true pairs + sentinel candidates;
    ``overflow`` / ``row_overflow`` report the exact requirement.
    """
    n = uv.shape[0]
    num_tiles = num_tiles_x * num_tiles_y
    if pair_cap % 512 != 0:
        raise ValueError("pair_cap must be a multiple of 512")
    if depth_rank is not None:
        qd_bits = max(1, int(n - 1).bit_length())
        if int(num_tiles).bit_length() + qd_bits > 30:
            raise ValueError(
                "exact depth-rank mode needs bitlen(tiles) + bitlen(N-1) "
                f"<= 30; got {int(num_tiles).bit_length()} + {qd_bits}"
            )
    else:
        qd_bits = depth_key_bits(num_tiles)

    cap = pair_cap
    # Row capacity: explicit (the trainer/bench grow it from row_overflow,
    # decoupled from the pair cap, so the pair cap tracks the true pair
    # count instead of 2x the row need) or derived (half the pair cap;
    # overflow then folds in 2*total_rows so single-cap growth covers row
    # truncation). Small caps get row_cap == cap, which can never truncate
    # rows (every row emits >= 1 candidate, so rows <= candidates).
    row_cap_derived = row_cap is None
    if row_cap_derived:
        row_cap = max(cap // 2, min(cap, 1 << 19))
    row_cap = ((row_cap + 511) // 512) * 512

    # EXACT two-level expansion (replaces the reference's conservative
    # bounding-square + SAT filter, culling.cu:97-244), in ORIGINAL Gaussian
    # order: level 1 enumerates the tile ROWS of each Gaussian's y-AABB;
    # level 2 computes, per row, the exact x-interval of the OBB within
    # that 16px strip in closed form (equal to the 4-axis SAT result —
    # OBB∩strip is convex, so its x-projection interval decides tile
    # membership exactly). Candidate count therefore equals the true pair
    # count (plus the sentinels): nothing is conservatively over-enumerated.
    u, v = uv[:, 0], uv[:, 1]
    r_major, r_minor = radius[:, 0], radius[:, 1]
    sin_t, cos_t = radius[:, 2], radius[:, 3]
    a1x, a1y = r_major * cos_t, r_major * sin_t
    a2x, a2y = -r_minor * sin_t, r_minor * cos_t
    # Ellipse/OBB scale (covariance ell_scale): the 1/255-cutoff ellipse
    # with semi-axes s_e*(a1, a2) contains every above-cutoff pixel, so
    # the pair set is the OBB tile test INTERSECTED with the ellipse's
    # exact strip support — the OBB's corner tiles (zero contribution,
    # zero gradient) never become pairs. (N, 4) records (hand-built OBBs)
    # get s_e = 2 >= sqrt(2): the ellipse then contains the OBB and the
    # behavior is pure-OBB.
    s_e = radius[:, 4] if radius.shape[1] >= 5 else jnp.full_like(u, 2.0)
    hx = jnp.minimum(
        jnp.abs(a1x) + jnp.abs(a2x),
        s_e * jnp.sqrt(a1x * a1x + a2x * a2x),
    )
    nty_eff = num_tiles_y if row_limit is None else row_limit
    ty0, ty1 = _span_y(v, a1y, a2y, s_e, tile_size, nty_eff)
    # Pixel-rect x gate: tile tx covers pixels tx*ts .. tx*ts + (ts-1).
    has_x = (
        jnp.floor((u + hx) / tile_size) >= 0
    ) & (jnp.ceil((u - hx - (tile_size - 1.0)) / tile_size) < num_tiles_x)
    row_counts = jnp.where(mask & has_x, jnp.maximum(0, ty1 - ty0), 0)

    # Sentinel-row trick, level 1: EVERY record owns >= 1 row, so no
    # visibility-compaction is needed. Records with row_counts == 0
    # (masked, off-screen, or NaN geometry) are SANITIZED to a far-off
    # position with zero axes: their single sentinel row then enumerates
    # zero tiles through the same strip math as real rows.
    live = row_counts > 0
    u = jnp.where(live, u, _FAR)
    v = jnp.where(live, v, _FAR)
    a1x = jnp.where(live, a1x, 0.0)
    a1y = jnp.where(live, a1y, 0.0)
    a2x = jnp.where(live, a2x, 0.0)
    a2y = jnp.where(live, a2y, 0.0)
    s_e = jnp.where(live, s_e, 1.0)
    if depth_rank is not None:
        qd = jnp.where(live, depth_rank.astype(jnp.int32), 0)
    else:
        qd = jnp.where(live, quantize_depth(z, qd_bits), 0)
    counts1 = jnp.maximum(row_counts, 1).astype(jnp.int32)
    offsets1 = jnp.cumsum(counts1) - counts1  # exclusive, original order
    total_rows = offsets1[-1] + counts1[-1]

    # Level 1: one slot per tile row; gather the owning Gaussian's values.
    gid_r = segment_ids(offsets1, row_cap)
    slot_r = jnp.arange(row_cap, dtype=jnp.int32)
    r_u, r_v = u[gid_r], v[gid_r]
    r_a1x, r_a1y, r_a2x, r_a2y = a1x[gid_r], a1y[gid_r], a2x[gid_r], a2y[gid_r]
    r_se = s_e[gid_r]
    row_y = ty0[gid_r] + (slot_r - offsets1[gid_r])
    # A sentinel row (its record enumerated zero tiles) is not real.
    real_row = live[gid_r]
    # Strip of PIXEL rows: pixel py = row_y*ts + 0..ts-1, dy = py - v.
    dy0 = row_y.astype(jnp.float32) * tile_size - r_v
    dy1 = dy0 + (tile_size - 1.0)
    # Exact x-interval of the OBB-ellipse INTERSECTION within the strip:
    # min/max of the two supports is a (safe, near-exact) superset bound
    # for the convex intersection; pairs beyond the ellipse support have
    # every pixel below the 1/255 alpha cutoff (zero value AND gradient).
    xhi_o = _strip_x_extreme(r_u, r_a1x, r_a1y, r_a2x, r_a2y, dy0, dy1)
    xlo_o = -_strip_x_extreme(-r_u, -r_a1x, r_a1y, -r_a2x, r_a2y, dy0, dy1)
    e1x, e1y = r_se * r_a1x, r_se * r_a1y
    e2x, e2y = r_se * r_a2x, r_se * r_a2y
    xhi_e = _strip_x_extreme_ell(r_u, e1x, e1y, e2x, e2y, dy0, dy1)
    xlo_e = -_strip_x_extreme_ell(-r_u, -e1x, e1y, -e2x, e2y, dy0, dy1)
    xhi = jnp.minimum(xhi_o, xhi_e)
    xlo = jnp.maximum(xlo_o, xlo_e)
    ok = jnp.isfinite(xlo) & jnp.isfinite(xhi)
    # Pixel-rect tile gate: tile tx covers pixels tx*ts .. tx*ts + (ts-1),
    # so tx is alive iff tx*ts <= xhi AND tx*ts + (ts-1) >= xlo.
    cx0 = jnp.clip(
        jnp.ceil(
            (jnp.where(ok, xlo, 0.0) - (tile_size - 1.0)) / tile_size
        ).astype(jnp.int32),
        0, num_tiles_x - 1,
    )
    cx1 = jnp.clip(
        jnp.floor(jnp.where(ok, xhi, -1.0) / tile_size).astype(jnp.int32),
        -1, num_tiles_x - 1,
    )
    # guard: xhi below image / xlo above image -> empty
    empty = (~ok) | (jnp.floor(xhi / tile_size) < 0) | (
        jnp.ceil((xlo - (tile_size - 1.0)) / tile_size) >= num_tiles_x
    )
    row_valid = slot_r < jnp.minimum(total_rows, row_cap)
    counts2 = jnp.where(
        row_valid & real_row & ~empty, jnp.maximum(0, cx1 - cx0 + 1), 0
    ).astype(jnp.int32)
    # Sentinel-candidate trick, level 2: every VALID row emits >= 1
    # candidate so the expansion stays contiguous without a compaction;
    # the sentinel of an empty row is marked invalid below (rel >= true
    # count) and sorts to the tail with the other invalid keys.
    counts2_off = jnp.where(row_valid, jnp.maximum(counts2, 1), 0)
    offsets2 = jnp.cumsum(counts2_off) - counts2_off  # exclusive, row order
    total_cand = offsets2[-1] + counts2_off[-1]

    # Level 2: one slot per (row, tile column) candidate.
    row_c = segment_ids(offsets2, cap)
    slot = jnp.arange(cap, dtype=jnp.int32)
    rel2 = slot - offsets2[row_c]
    tile_idx = row_y[row_c] * num_tiles_x + cx0[row_c] + rel2
    cand_valid = (slot < jnp.minimum(total_cand, cap)) & (
        rel2 < counts2[row_c]
    )
    gid_c = gid_r[row_c]

    tile_x = tile_idx % num_tiles_x
    tile_y = tile_idx // num_tiles_x
    # Composite single-int32 key: (tile << qd_bits) | quantized depth — the
    # analogue of the reference's uint64 radix key (culling.cu:294-298).
    # Invalid candidates key to the all-tiles sentinel.
    invalid_key = jnp.int32(num_tiles << qd_bits)
    key = jnp.where(cand_valid, (tile_idx << qd_bits) | qd[gid_c],
                    invalid_key).astype(jnp.int32)
    # Gaussian id as key2: the deterministic depth tiebreak (one pair per
    # (tile, Gaussian) -> the full key is unique). Invalid candidates get
    # the sentinel n (> any id).
    gid_key = jnp.where(cand_valid, gid_c, jnp.int32(n))

    # ONE sort by ((tile, qdepth), gid) — tile-major, depth-ascending, the
    # reference's composite ordering. The attribute columns ride the sort.
    attrs9 = attrs[:, :9]
    if bf16_colors:
        # u, v ride as ONE f16 pair of TILE-RELATIVE offsets (the tile
        # origin is recovered from the sorted key; sub-0.01px rounding near
        # the tile, ~2^-11-relative for a wide splat's far tiles); conic
        # and opacity ride as bf16 pairs and colour as one shared-exponent
        # word (<=0.4% relative rounding on splat shape and color — far
        # below the 8-bit render target and SGD noise). Invalid candidates
        # get zero offsets, and valid offsets are CLAMPED to +-16384:
        # covariance puts no upper bound on r_major, so a degenerate
        # near-camera splat can reach beyond f16's 65504 max. A splat
        # evaluated >16k px from its center has sigma ~5k px; the clamp
        # (and f16's ~8 px ulp out there) is far below its color scale.
        tsz = jnp.float32(tile_size)

        def _rel(col, tcoord):
            rel = col[gid_c] - tsz * tcoord.astype(jnp.float32)
            return jnp.where(
                cand_valid, jnp.clip(rel, -16384.0, 16384.0), 0.0
            )

        words = (
            pack_bf16_pair(attrs9[:, 2], attrs9[:, 3]),
            pack_bf16_pair(attrs9[:, 4], attrs9[:, 5]),
            pack_rgb_e5(attrs9[:, 6], attrs9[:, 7], attrs9[:, 8]),
        )
        sorted_ops = tile_sort(
            key, gid_key,
            (pack_f16_pair(_rel(uv[:, 0], tile_x), _rel(uv[:, 1], tile_y)),)
            + tuple(w[gid_c] for w in words),
        )
        key_sorted = sorted_ops[0]
        in_range = key_sorted < invalid_key
        tile_s = key_sorted >> qd_bits
        u_rel, v_rel = unpack_f16_pair(sorted_ops[2])
        c00, c01 = unpack_bf16_pair(sorted_ops[3])
        c11, opa = unpack_bf16_pair(sorted_ops[4])
        cols = [
            u_rel + tsz * (tile_s % num_tiles_x).astype(jnp.float32),
            v_rel + tsz * (tile_s // num_tiles_x).astype(jnp.float32),
            c00, c01, c11, opa, *unpack_rgb_e5(sorted_ops[5]),
        ]
    else:
        sorted_ops = tile_sort(
            key, gid_key, tuple(attrs9[gid_c, i] for i in range(9))
        )
        key_sorted = sorted_ops[0]
        in_range = key_sorted < invalid_key
        cols = list(sorted_ops[2:11])
    stream = jnp.stack([jnp.where(in_range, c, 0.0) for c in cols], axis=0)
    gid_sorted = sorted_ops[1]

    # Tile ranges via searchsorted at the qd-aligned key boundaries. Pair
    # slot == sorted slot (no chunk padding; the rasterizer masks both
    # unaligned ends of each tile's range).
    bounds = jnp.searchsorted(
        key_sorted,
        (jnp.arange(num_tiles + 1, dtype=jnp.int32) << qd_bits),
        side="left",
    ).astype(jnp.int32)
    tile_start = bounds[:-1]
    tile_count = bounds[1:] - bounds[:-1]
    num_pairs = bounds[-1]

    splat_gid = jnp.where(in_range, gid_sorted, -1)

    if row_cap_derived:
        # One scalar must cover both axes.
        overflow = jnp.maximum(total_cand, 2 * total_rows).astype(jnp.int32)
    else:
        overflow = total_cand.astype(jnp.int32)
    return TileTables(
        splat_gid=splat_gid,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=num_pairs,
        overflow=overflow,
        row_overflow=total_rows.astype(jnp.int32),
        stream=stream,
    )
