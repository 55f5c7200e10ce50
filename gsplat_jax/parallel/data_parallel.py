"""Multi-chip data-parallel training (shard_map over a camera batch).

The reference is strictly single-GPU/single-process (SURVEY §2.6); this is
the scale-out designed per the north star (BASELINE.json):

- a 1-D ``data`` mesh axis shards a batch of cameras (one image per chip,
  a capability extension over the reference's 1 image/step);
- Gaussian parameters and Adam state are fully REPLICATED; each chip
  rasterizes its own camera against the replicated parameters;
- per-chip gradients, visibility masks, and densification statistics are
  ``psum``'d over ICI (XLA overlaps the all-reduce with the remaining
  backward work), then every chip applies the identical masked-Adam update —
  replicas stay bit-identical with zero resharding;
- densification runs replicated with a shared counter-based PRNG key, so the
  parameter arrays never need to be re-synchronized (SURVEY §2.6 design row
  "Distributed backend").

Gradient semantics for batch B: the loss is the MEAN over cameras (each
camera's fused loss is already pixel-mean normalized, so B cameras average —
keeping LR scales comparable with the reference's 1-camera steps).
Visibility for Adam is the union across the batch; the densify duration
accumulator counts per-camera visibility (trainer.cu:1152-1153 generalized).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..train.state import TrainState
from ..train.step import StepStatics, apply_adam, compute_loss_and_grads


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def dp_train_step(
    state: TrainState,
    views: jnp.ndarray,  # (B, 4, 4)
    projs: jnp.ndarray,  # (B, 4, 4)
    campos: jnp.ndarray,  # (B, 3)
    gt_images: jnp.ndarray,  # (B, H, W, 3)
    bgs: jnp.ndarray,  # (B,)
    iteration: jnp.ndarray,  # () int32
    st: StepStatics,
    mesh: Mesh,
    axis: str = "data",
):
    """One replicated optimizer step over a sharded camera batch."""

    def shard_fn(params, alive, view, proj, cpos, gt, bg):
        # Each chip holds exactly one camera of the batch.
        loss, image, mask, tables, grads, g_uv = compute_loss_and_grads(
            params, alive,
            view[0], proj[0], cpos[0], gt[0], bg[0], st,
        )
        b = jax.lax.psum(1, axis)
        # Densify statistic BEFORE averaging: each camera contributes its own
        # ||grad_uv|| (trainer.cu:1144-1150 per-image semantics), summed over
        # the batch along with per-camera visibility counts.
        g_norm = jax.lax.psum(jnp.sqrt(jnp.sum(g_uv * g_uv, axis=1)), axis)
        visible_count = jax.lax.psum(mask.astype(jnp.int32), axis)
        union_mask = visible_count > 0
        # Mean-of-cameras loss => grads averaged over the batch.
        grads = jax.tree.map(lambda g: jax.lax.psum(g, axis) / b, grads)
        g_uv = jax.lax.psum(g_uv, axis) / b
        loss = jax.lax.pmean(loss, axis)
        n_pairs = jax.lax.pmax(tables.num_pairs, axis)
        overflow = jax.lax.pmax(tables.overflow, axis)
        row_overflow = jax.lax.pmax(tables.row_overflow, axis)
        return (
            grads, g_uv, g_norm, union_mask, visible_count, loss, n_pairs,
            overflow, row_overflow,
        )

    shd = NamedSharding(mesh, P(axis))

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(), P(), P(), P(), P(), P()),
        # pallas_call out_shapes carry no varying-mesh-axes metadata yet.
        check_vma=False,
    )
    views = jax.device_put(views, shd)
    projs = jax.device_put(projs, shd)
    campos_s = jax.device_put(campos, shd)
    gts = jax.device_put(gt_images, shd)
    bgs = jax.device_put(bgs, shd)

    (grads, g_uv, g_norm, union_mask, visible_count, loss, n_pairs,
     overflow, row_overflow) = fn(
        state.params, state.alive, views, projs, campos_s, gts, bgs
    )
    new_state = apply_adam(
        state, grads, g_uv, union_mask, iteration, st,
        visible_count=visible_count, g_norm=g_norm,
    )
    return new_state, {
        "loss": loss,
        "num_pairs": n_pairs,
        "overflow": overflow,
        "row_overflow": row_overflow,
    }


@functools.lru_cache(maxsize=8)
def get_dp_train_step(st: StepStatics, mesh_devices: tuple, axis: str = "data"):
    mesh = make_mesh(list(mesh_devices), axis)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, views, projs, campos, gts, bgs, iteration):
        return dp_train_step(
            state, views, projs, campos, gts, bgs, iteration, st, mesh, axis
        )

    return step


@functools.lru_cache(maxsize=8)
def get_monitored_dp_train_step(
    st: StepStatics, mesh_devices: tuple, axis: str = "data"
):
    """DP step + the Trainer's on-device window monitor (train/step.py):
    [max_pair_overflow, max_row_overflow, all_losses_finite] reduced every
    step so host boundaries cover the whole window with one fetch."""
    mesh = make_mesh(list(mesh_devices), axis)

    @functools.partial(jax.jit, donate_argnums=(0, 7))
    def step(state, views, projs, campos, gts, bgs, iteration, monitor):
        new_state, m = dp_train_step(
            state, views, projs, campos, gts, bgs, iteration, st, mesh, axis
        )
        new_monitor = jnp.stack(
            [
                jnp.maximum(monitor[0], m["overflow"].astype(jnp.float32)),
                jnp.maximum(
                    monitor[1], m["row_overflow"].astype(jnp.float32)
                ),
                jnp.minimum(
                    monitor[2], jnp.isfinite(m["loss"]).astype(jnp.float32)
                ),
            ]
        )
        return new_state, m, new_monitor

    return step
