"""The jitted training step: forward render -> loss -> gradients -> Adam.

One fused XLA computation per step, replacing the reference's ~30 kernel
launches + 4 host syncs per iteration (SURVEY §3.3-3.5). The per-Gaussian
pipeline runs dense over the capacity axis (visibility is a mask, not a
compaction); gradients flow by JAX AD through forward math that matches the
reference's hand-derived chain (see ops/*.py docstrings), with the rasterizer
and fused loss as the only custom-VJP boundaries.

The uv-gradient densification statistic (trainer.cu:1137-1157) is obtained
with a zero "probe" added to uv before rasterization: grad w.r.t. the probe
is exactly the reference's grad_uv buffer (including its x0.5*W scale).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import adam as adam_ops
from ..ops import projection, covariance, sh as sh_ops
from ..ops.binning import build_tile_tables
from ..ops.loss import compute_psnr, fused_loss
from ..ops.render import rasterize
from .state import TrainState


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Hashable per-geometry constants baked into the jitted step."""

    width: int
    height: int
    tile: int
    chunk: int
    pair_cap: int
    l_max: int
    # camera intrinsics
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float
    # config-derived
    near_thresh: float
    mh_dist: float
    cull_padding: int
    ssim_frac: float
    base_lr: float
    xyz_lr_init: float
    xyz_lr_final: float
    quat_lr: float
    scale_lr: float
    opacity_lr: float
    rgb_lr: float
    sh_lr: float
    scene_extent: float
    num_iters: int
    # Tile-row expansion capacity; 0 = derive from pair_cap (legacy
    # coupling). The trainer/bench size it from row_overflow so the pair
    # cap tracks the true pair count instead of 2x the row need.
    row_cap: int = 0
    # Run the Pallas rasterizer in interpret mode (CPU tests); otherwise it
    # compiles for the GPU. ``raster="reference"`` swaps in the plain XLA
    # rasterizer (ops/raster_ref.py), the baseline it is timed against.
    interpret: bool = False
    raster: str = "kernel"

    @property
    def num_tiles_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def num_tiles_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


class StepMetrics(NamedTuple):
    loss: jnp.ndarray
    psnr: jnp.ndarray
    num_visible: jnp.ndarray
    num_pairs: jnp.ndarray
    overflow: jnp.ndarray  # required pair capacity; grow if > pair_cap
    row_overflow: jnp.ndarray  # required row capacity; grow if > row_cap


def _per_gaussian(params, alive, view, proj, campos, st: StepStatics):
    """Dense per-Gaussian forward pipeline (SURVEY §3.3 steps 1-8)."""
    xyz_c = projection.world_to_camera(params["xyz"], view)
    uv = projection.project_to_screen(xyz_c, proj, st.width, st.height)
    mask = (
        projection.frustum_cull_mask(
            uv, xyz_c, st.near_thresh, st.cull_padding, st.width, st.height
        )
        & alive
    )
    jac = projection.projection_jacobian(
        xyz_c, st.focal_x, st.focal_y, st.tan_fovx, st.tan_fovy
    )
    sigma = covariance.sigma_from_quat_scale(params["quat"], params["scale"])
    conic, radius = covariance.conic_and_radius(
        sigma, jac, view, st.mh_dist, opacity_logit=params["opacity"]
    )
    rgb = sh_ops.sh_to_rgb(
        params["xyz"], params["rgb"], params["sh"], campos, st.l_max
    )
    z = xyz_c[:, 2]
    return uv, conic, rgb, mask, radius, z


def render_image(params, alive, view, proj, campos, bg, st: StepStatics):
    """Forward-only render (eval / image dumps); not differentiated."""
    uv, conic, rgb, mask, radius, z = _per_gaussian(
        params, alive, view, proj, campos, st
    )
    from ..ops.render import pack_attrs

    tables = build_tile_tables(
        uv, z, radius, mask,
        attrs=pack_attrs(uv, conic, rgb, params["opacity"]),
        num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y,
        tile_size=st.tile, pair_cap=st.pair_cap,
        row_cap=st.row_cap or None,
    )
    out = rasterize(
        uv, conic, rgb, params["opacity"], tables, bg,
        width=st.width, height=st.height, tile=st.tile, chunk=st.chunk,
        interpret=st.interpret, impl=st.raster,
    )
    return out.image, tables


def compute_loss_and_grads(
    params: dict,
    alive: jnp.ndarray,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    campos: jnp.ndarray,
    gt_image: jnp.ndarray,
    bg: jnp.ndarray,
    st: StepStatics,
):
    """Forward + backward for one camera. Returns
    (loss, image, mask, tables, grads, g_uv) — the reusable core shared by
    the single-chip step and the sharded multi-chip step."""

    def loss_fn(p, uv_probe):
        uv, conic, rgb, mask, radius, z = _per_gaussian(
            p, alive, view, proj, campos, st
        )
        uv = uv + uv_probe
        sg = jax.lax.stop_gradient
        from ..ops.render import pack_attrs

        attrs = pack_attrs(uv, conic, rgb, p["opacity"])
        tables = build_tile_tables(
            sg(uv), sg(z), radius, mask, attrs=sg(attrs),
            num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y,
            tile_size=st.tile, pair_cap=st.pair_cap,
            row_cap=st.row_cap or None,
        )
        out = rasterize(
            uv, conic, rgb, p["opacity"], tables, bg,
            width=st.width, height=st.height, tile=st.tile, chunk=st.chunk,
            interpret=st.interpret, impl=st.raster,
        )
        loss = fused_loss(out.image, gt_image, st.ssim_frac)
        return loss, (out.image, mask, tables)

    n_cap = alive.shape[0]
    uv_probe = jnp.zeros((n_cap, 2), jnp.float32)
    (loss, (image, mask, tables)), (grads, g_uv) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True
    )(params, uv_probe)
    return loss, image, mask, tables, grads, g_uv


def apply_adam(
    state: TrainState,
    grads: dict,
    g_uv: jnp.ndarray,
    mask: jnp.ndarray,
    iteration: jnp.ndarray,
    st: StepStatics,
    visible_count: jnp.ndarray | None = None,
    g_norm: jnp.ndarray | None = None,
) -> TrainState:
    """Masked Adam update + densification accumulators.

    ``visible_count`` (per-Gaussian int) and ``g_norm`` (pre-summed per-camera
    uv-grad norms) generalize the accumulators to camera batches > 1
    (multi-chip DP); they default to single-camera semantics."""
    it_f = iteration.astype(jnp.float32)
    bias1 = 1.0 - jnp.power(adam_ops.B1, it_f + 1.0)
    bias2 = 1.0 - jnp.power(adam_ops.B2, it_f + 1.0)
    # xyz LR: exponential decay scaled by scene extent (trainer.cu:1049-1054).
    decay = jnp.power(
        st.xyz_lr_final / st.xyz_lr_init, it_f / float(st.num_iters)
    )
    lrs = {
        "xyz": st.scene_extent * st.base_lr * st.xyz_lr_init * decay,
        "rgb": st.base_lr * st.rgb_lr,
        "opacity": st.base_lr * st.opacity_lr,
        "scale": st.base_lr * st.scale_lr,
        "quat": st.base_lr * st.quat_lr,
        "sh": st.base_lr * st.sh_lr,
    }

    new_params, new_m, new_v = {}, {}, {}
    for name in state.params:
        if name == "sh" and st.l_max == 0:
            # l_max=0: SH not optimized (trainer.cu:1087 gates on l_max>0).
            new_params[name] = state.params[name]
            new_m[name] = state.adam_m[name]
            new_v[name] = state.adam_v[name]
            continue
        p, m, v = adam_ops.masked_adam_update(
            state.params[name], grads[name],
            state.adam_m[name], state.adam_v[name],
            mask, lrs[name], bias1, bias2,
        )
        new_params[name] = p
        new_m[name] = m
        new_v[name] = v

    # Densification accumulators (trainer.cu:1137-1157): ||grad_uv|| summed
    # per visible Gaussian + visibility duration.
    if g_norm is None:
        g_norm = jnp.sqrt(jnp.sum(g_uv * g_uv, axis=1))
    uv_accum = jnp.where(
        mask, state.uv_grad_accum + g_norm, state.uv_grad_accum
    )
    if visible_count is None:
        visible_count = mask.astype(jnp.int32)
    dur = state.accum_dur + visible_count

    return TrainState(
        params=new_params,
        adam_m=new_m,
        adam_v=new_v,
        alive=state.alive,
        uv_grad_accum=uv_accum,
        accum_dur=dur,
    )


def train_step(
    state: TrainState,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    campos: jnp.ndarray,
    gt_image: jnp.ndarray,  # (H, W, 3) float32
    bg: jnp.ndarray,  # () float32
    iteration: jnp.ndarray,  # () int32
    st: StepStatics,
):
    """One optimizer step on one camera. Returns (new_state, metrics)."""
    loss, image, mask, tables, grads, g_uv = compute_loss_and_grads(
        state.params, state.alive, view, proj, campos, gt_image, bg, st
    )
    new_state = apply_adam(state, grads, g_uv, mask, iteration, st)
    metrics = StepMetrics(
        loss=loss,
        psnr=compute_psnr(image, gt_image),
        num_visible=jnp.sum(mask.astype(jnp.int32)),
        num_pairs=tables.num_pairs,
        overflow=tables.overflow,
        row_overflow=tables.row_overflow,
    )
    return new_state, metrics


# Cache sizes cover multi-camera rigs (a distinct StepStatics per intrinsics
# bundle recompiles); 64 geometries before silent thrash (round-1 review
# weak item 8).
@functools.lru_cache(maxsize=64)
def get_train_step(st: StepStatics):
    """Jitted train step for one static geometry bundle."""
    return jax.jit(
        functools.partial(train_step, st=st), donate_argnums=(0,)
    )


def monitored_train_step(
    state, view, proj, campos, gt_image, bg, iteration, monitor,
    st: StepStatics,
):
    """train_step + on-device window accumulators.

    ``monitor`` is a (3,) f32 array [max_pair_overflow_seen,
    max_row_overflow_seen, all_losses_finite] reduced ON DEVICE every
    step, so host boundaries (print/density intervals) can check the
    WHOLE window with one tiny fetch — no step's dropped pairs or
    non-finite loss can hide between boundaries (the reference has no
    such check at all; its trainer syncs every iteration). Reset the
    monitor with fresh_monitor() after each boundary check.
    """
    new_state, metrics = train_step(
        state, view, proj, campos, gt_image, bg, iteration, st
    )
    new_monitor = jnp.stack(
        [
            jnp.maximum(monitor[0], metrics.overflow.astype(jnp.float32)),
            jnp.maximum(
                monitor[1], metrics.row_overflow.astype(jnp.float32)
            ),
            jnp.minimum(
                monitor[2], jnp.isfinite(metrics.loss).astype(jnp.float32)
            ),
        ]
    )
    return new_state, metrics, new_monitor


def fresh_monitor() -> jnp.ndarray:
    return jnp.array([0.0, 0.0, 1.0], jnp.float32)


@functools.lru_cache(maxsize=64)
def get_monitored_train_step(st: StepStatics):
    return jax.jit(
        functools.partial(monitored_train_step, st=st),
        donate_argnums=(0, 7),
    )


@functools.lru_cache(maxsize=64)
def get_render_fn(st: StepStatics):
    def fn(params, alive, view, proj, campos, bg):
        img, _ = render_image(params, alive, view, proj, campos, bg, st)
        return img

    return jax.jit(fn)
