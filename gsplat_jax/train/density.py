"""Adaptive density control: prune / clone / split, opacity reset, Morton sort.

Fixed-capacity jitted reimplementation of the reference's host+thrust density
logic (cuda/trainer.cu:416-775, cuda/adaptive_density.cu):

- avg uv-gradient = accum / duration (ComputeAvgGrad, trainer.cu:416-425);
- prune when opacity-logit < logit(delete_opacity_threshold) OR
  max(exp(scale)) > 0.1*scene_extent — unless the Gaussian qualifies for
  densification (grad > threshold AND max_scale/1.6 <= 0.1*scene_extent; the
  1.6 is hardcoded in IdentifyPrune, trainer.cu:460);
- clone when kept, avg_grad > uv_grad_threshold and max_scale <=
  0.01*scene_extent (IdentifyClone); split when the scale is larger
  (IdentifySplit);
- if the step would exceed max_gaussians, skip it entirely
  (trainer.cu:579-585);
- new layout = [kept-compacted | clones | split children x2]
  (trainer.cu:645-766); Adam moments compact with kept rows, zero for new
  (trainer.cu:664-741);
- split children sample their centers from the parent's own N(0, Sigma)
  (adaptive_density.cu:123-136) and divide scales by split_scale_factor in
  log space (:144-146) — with a counter-based JAX PRNG instead of
  time(NULL)-seeded curand, so densification is deterministic and replica-
  identical across a mesh (reference seeds wall-clock, :201);
- afterwards all arrays are permuted into Morton order (trainer.cu:871-924)
  and the gradient accumulators reset (trainer.cu:1397).

Everything is scatter/cumsum-based over the fixed capacity; if the new count
exceeds the current capacity bucket the step reports ``needs_grow`` and the
host re-runs it after re-bucketing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .state import TrainState


@dataclasses.dataclass(frozen=True)
class DensityStatics:
    scene_extent: float
    uv_grad_threshold: float
    delete_opacity_threshold: float
    split_scale_factor: float
    max_gaussians: int
    # strict_reference=False extensions (dead flags in the reference):
    use_split: bool = True
    use_clone: bool = True
    use_delete: bool = True


class DensityInfo(NamedTuple):
    new_total: jnp.ndarray  # () int32
    num_pruned: jnp.ndarray
    num_cloned: jnp.ndarray
    num_split: jnp.ndarray
    applied: jnp.ndarray  # () bool — False if skipped (capacity)
    needs_grow: jnp.ndarray  # () bool — exceeds current bucket, re-run after grow


def _quat_rotate(quat: jnp.ndarray, vec: jnp.ndarray) -> jnp.ndarray:
    """Rotate (N,3) vectors by (N,4) (w,x,y,z) quats, rsqrt-normalized
    (adaptive_density.cu:94-131 semantics)."""
    inv = jax.lax.rsqrt(jnp.sum(quat * quat, axis=1))
    w, x, y, z = (quat[:, i] * inv for i in range(4))
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2),
        ],
        axis=1,
    ).reshape(-1, 3, 3)
    return jnp.einsum("nij,nj->ni", r, vec)


def adaptive_density_step(
    state: TrainState, key: jnp.ndarray, ds: DensityStatics
) -> tuple[TrainState, DensityInfo]:
    n_cap = state.capacity
    alive = state.alive
    p = state.params

    dur = jnp.maximum(state.accum_dur, 1)
    avg_grad = jnp.where(
        state.accum_dur > 0, state.uv_grad_accum / dur.astype(jnp.float32), 0.0
    )
    exp_scale = jnp.exp(p["scale"])
    scale_max = jnp.max(exp_scale, axis=1)

    max_scale = ds.scene_extent * 0.1
    clone_scale_thr = ds.scene_extent * 0.01
    import math

    op_thr = math.log(ds.delete_opacity_threshold) - math.log(
        1.0 - ds.delete_opacity_threshold
    )

    # IdentifyPrune (trainer.cu:439-470): low opacity always prunes; large
    # scale prunes unless the Gaussian qualifies for densification.
    densify_exempt = (avg_grad > ds.uv_grad_threshold) & (
        scale_max / 1.6 <= max_scale
    )
    prune = (p["opacity"] < op_thr) | (
        ~densify_exempt & (scale_max > max_scale)
    )
    if not ds.use_delete:
        prune = jnp.zeros_like(prune)
    prune = prune & alive

    densify = (avg_grad > ds.uv_grad_threshold) & ~prune & alive
    clone = densify & (scale_max <= clone_scale_thr)
    split = densify & (scale_max > clone_scale_thr)
    if not ds.use_clone:
        clone = jnp.zeros_like(clone)
    if not ds.use_split:
        split = jnp.zeros_like(split)

    keep = alive & ~(prune | split)

    n_keep = jnp.sum(keep.astype(jnp.int32))
    n_clone = jnp.sum(clone.astype(jnp.int32))
    n_split = jnp.sum(split.astype(jnp.int32))
    n_prune = jnp.sum(prune.astype(jnp.int32))
    new_total = n_keep + n_clone + 2 * n_split

    exceeds_max = new_total > ds.max_gaussians  # skip entirely (ref behavior)
    nothing = (n_clone + 2 * n_split == 0) & (n_prune == 0)
    needs_grow = (~exceeds_max) & (new_total > n_cap)
    apply = ~(exceeds_max | nothing | needs_grow)

    # Destination layout: [kept | clones | split children x2].
    keep_i = keep.astype(jnp.int32)
    clone_i = clone.astype(jnp.int32)
    split_i = split.astype(jnp.int32)
    dst_keep = jnp.cumsum(keep_i) - keep_i
    dst_clone = n_keep + jnp.cumsum(clone_i) - clone_i
    dst_split = n_keep + n_clone + 2 * (jnp.cumsum(split_i) - split_i)

    drop = jnp.int32(n_cap)
    dst_keep = jnp.where(keep, dst_keep, drop)
    dst_clone = jnp.where(clone, dst_clone, drop)
    dst_split0 = jnp.where(split, dst_split, drop)
    dst_split1 = jnp.where(split, dst_split + 1, drop)

    # Split children: centers sampled from the parent Gaussian.
    k1, k2 = jax.random.split(key)
    noise0 = jax.random.normal(k1, (n_cap, 3)) * exp_scale
    noise1 = jax.random.normal(k2, (n_cap, 3)) * exp_scale
    off0 = _quat_rotate(p["quat"], noise0)
    off1 = _quat_rotate(p["quat"], noise1)
    split_scale = jnp.log(exp_scale / ds.split_scale_factor)

    def rebuild(name, arr):
        out = jnp.zeros_like(arr)
        out = out.at[dst_keep].set(arr, mode="drop")
        out = out.at[dst_clone].set(arr, mode="drop")
        if name == "xyz":
            out = out.at[dst_split0].set(arr + off0, mode="drop")
            out = out.at[dst_split1].set(arr + off1, mode="drop")
        elif name == "scale":
            out = out.at[dst_split0].set(split_scale, mode="drop")
            out = out.at[dst_split1].set(split_scale, mode="drop")
        else:
            out = out.at[dst_split0].set(arr, mode="drop")
            out = out.at[dst_split1].set(arr, mode="drop")
        return out

    def rebuild_moment(arr):
        # Kept rows carry their moments; clones/splits start at zero
        # (trainer.cu:664-741).
        return jnp.zeros_like(arr).at[dst_keep].set(arr, mode="drop")

    new_params = {k: rebuild(k, v) for k, v in p.items()}
    new_m = {k: rebuild_moment(v) for k, v in state.adam_m.items()}
    new_v = {k: rebuild_moment(v) for k, v in state.adam_v.items()}
    iota = jnp.arange(n_cap, dtype=jnp.int32)
    new_alive = iota < new_total

    def pick(tree_new, tree_old):
        return jax.tree.map(
            lambda a, b: jnp.where(
                apply.reshape((1,) * a.ndim), a, b
            ),
            tree_new,
            tree_old,
        )

    out_state = TrainState(
        params=pick(new_params, p),
        adam_m=pick(new_m, state.adam_m),
        adam_v=pick(new_v, state.adam_v),
        alive=jnp.where(apply, new_alive, alive),
        # accumulators are reset after every density step (trainer.cu:1397)
        uv_grad_accum=jnp.zeros_like(state.uv_grad_accum),
        accum_dur=jnp.zeros_like(state.accum_dur),
    )
    info = DensityInfo(
        new_total=jnp.where(apply, new_total, jnp.sum(alive.astype(jnp.int32))),
        num_pruned=n_prune,
        num_cloned=n_clone,
        num_split=n_split,
        applied=apply,
        needs_grow=needs_grow,
    )
    return out_state, info


def morton_sort(state: TrainState) -> TrainState:
    """Permute all per-Gaussian arrays into Morton order (trainer.cu:871-924).

    Dead (non-alive) rows key to the max code so they stay at the tail and
    the alive prefix remains contiguous.
    """
    from ..ops.morton import morton_codes

    codes = morton_codes(state.params["xyz"], state.alive)
    order = jnp.argsort(codes, stable=True)

    def permute(x):
        return x[order]

    return TrainState(
        params=jax.tree.map(permute, state.params),
        adam_m=jax.tree.map(permute, state.adam_m),
        adam_v=jax.tree.map(permute, state.adam_v),
        alive=state.alive[order],
        uv_grad_accum=state.uv_grad_accum[order],
        accum_dur=state.accum_dur[order],
    )


def reset_opacity(state: TrainState, reset_value: float) -> TrainState:
    """opacity := logit(reset_value); opacity Adam moments zeroed
    (trainer.cu:238-245). Accumulators also reset (trainer.cu:1400-1404)."""
    import math

    logit = math.log(reset_value) - math.log(1.0 - reset_value)
    params = dict(state.params)
    params["opacity"] = jnp.where(
        state.alive, jnp.float32(logit), state.params["opacity"]
    )
    m = dict(state.adam_m)
    v = dict(state.adam_v)
    m["opacity"] = jnp.zeros_like(m["opacity"])
    v["opacity"] = jnp.zeros_like(v["opacity"])
    return TrainState(
        params=params,
        adam_m=m,
        adam_v=v,
        alive=state.alive,
        uv_grad_accum=jnp.zeros_like(state.uv_grad_accum),
        accum_dur=jnp.zeros_like(state.accum_dur),
    )


def zero_sh(state: TrainState) -> TrainState:
    """The l_max 0->1 transition zeroes the SH array (trainer.cu:381-385).
    Higher transitions are pure l_max bumps in our (l,m)-indexed layout."""
    params = dict(state.params)
    params["sh"] = jnp.zeros_like(params["sh"])
    return state._replace(params=params)


@functools.lru_cache(maxsize=8)
def get_density_fns(ds: DensityStatics):
    step = jax.jit(functools.partial(adaptive_density_step, ds=ds))
    sort = jax.jit(morton_sort)
    return step, sort
