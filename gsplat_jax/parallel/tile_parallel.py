"""Multi-chip tile-sharded rendering of a SINGLE camera (shard_map).

The workload's analogue of sequence parallelism (SURVEY §5): the pixel/tile
axis of one image is sharded across chips, parameters stay replicated —
for very high resolutions or very dense scenes where one chip's pair stream
per camera is the bottleneck.

Design:
- the mesh's ``tile`` axis splits the image into horizontal strips of whole
  16px tile rows (the last strip padded; padding rows render but are cropped
  before the loss);
- every chip runs the (cheap, dense) per-Gaussian pipeline on the replicated
  parameters, then bins and rasterizes ONLY its strip: binning's exact
  row-range enumeration clips to the strip for free, so per-chip pair
  streams are ~1/D of the full image's;
- image strips are all-gathered (a few MB over ICI) and the fused SSIM+L1
  loss is computed REPLICATED on the full image — duplicated but tiny
  compared to rasterization;
- AD through the all_gather gives each chip the full-image cotangent; its
  local rasterizer backward produces partial per-Gaussian gradients which
  are combined with ``pmean`` (every chip's backward saw a D-times-counted
  image cotangent, so the mean restores the true sum — see the derivation
  in dp_train_step's docstring pattern).

Semantics match the single-chip train_step exactly (same loss, same
reference uv-grad convention via grad_scale_wh = global (W, H)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.binning import build_tile_tables
from ..ops.loss import compute_psnr, fused_loss
from ..ops.render import rasterize
from ..train.state import TrainState
from ..train.step import StepStatics, StepMetrics, _per_gaussian, apply_adam


def make_tile_mesh(devices=None, axis: str = "tile") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _strip_rows(st: StepStatics, n_chips: int) -> int:
    return (st.num_tiles_y + n_chips - 1) // n_chips


def tp_train_step(
    state: TrainState,
    view: jnp.ndarray,  # (4, 4)
    proj: jnp.ndarray,  # (4, 4)
    campos: jnp.ndarray,  # (3,)
    gt_image: jnp.ndarray,  # (H, W, 3)
    bg: jnp.ndarray,  # ()
    iteration: jnp.ndarray,  # () int32
    st: StepStatics,
    mesh: Mesh,
    axis: str = "tile",
):
    """One optimizer step, one camera, tiles sharded over the mesh axis."""
    n_chips = int(mesh.shape[axis])
    rows_local = _strip_rows(st, n_chips)
    h_local = rows_local * st.tile
    h_pad = h_local * n_chips
    gt_pad = jnp.pad(
        gt_image, ((0, h_pad - gt_image.shape[0]), (0, 0), (0, 0))
    )

    def shard_fn(params, alive, view, proj, cpos, gt_pad, bg):
        d = jax.lax.axis_index(axis)
        y_off = (d * h_local).astype(jnp.float32)

        def loss_fn(p, uv_probe):
            uv, conic, rgb, mask, radius, z = _per_gaussian(
                p, alive, view, proj, cpos, st
            )
            uv = uv + uv_probe
            # Shift into strip-local coordinates; binning's exact row
            # enumeration clips everything outside [0, rows_local) for free.
            shift = jnp.stack([jnp.float32(0.0), y_off])
            uv_l = uv - shift
            radius_l = radius
            sg = jax.lax.stop_gradient
            # Last strip's padding rows lie past the global image; exclude
            # them so the sharded pair set equals the single-chip one.
            row_limit = jnp.clip(
                st.num_tiles_y - d * rows_local, 0, rows_local
            )
            from ..ops.render import pack_attrs

            attrs_l = pack_attrs(uv_l, conic, rgb, p["opacity"])
            tables = build_tile_tables(
                sg(uv_l), sg(z), radius_l, mask, attrs=sg(attrs_l),
                num_tiles_x=st.num_tiles_x, num_tiles_y=rows_local,
                tile_size=st.tile, pair_cap=st.pair_cap,
                row_cap=st.row_cap or None, row_limit=row_limit,
            )
            out = rasterize(
                uv_l, conic, rgb, p["opacity"], tables, bg,
                width=st.width, height=h_local, tile=st.tile,
                chunk=st.chunk, interpret=st.interpret, impl=st.raster,
                grad_scale_wh=(st.width, st.height),  # global convention
            )
            strip = out.image  # (h_local, W, 3)
            full = jax.lax.all_gather(strip, axis, axis=0, tiled=True)
            image = full[: st.height]
            loss = fused_loss(image, gt_pad[: st.height], st.ssim_frac)
            return loss, (image, mask, tables)

        n_cap = alive.shape[0]
        probe = jnp.zeros((n_cap, 2), jnp.float32)
        (loss, (image, mask, tables)), (grads, g_uv) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(params, probe)
        # Every chip back-propagated the full (replicated) image cotangent;
        # its local path contributes only its strip, but the all_gather
        # transpose sums D identical cotangent copies -> pmean restores the
        # true single-loss gradient.
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
        g_uv = jax.lax.pmean(g_uv, axis)
        mask_any = jax.lax.psum(mask.astype(jnp.int32), axis) > 0
        n_pairs = jax.lax.psum(tables.num_pairs, axis)
        overflow = jax.lax.pmax(tables.overflow, axis)
        row_overflow = jax.lax.pmax(tables.row_overflow, axis)
        psnr = compute_psnr(image, gt_pad[: st.height])
        return (grads, g_uv, mask_any, loss, psnr, n_pairs, overflow,
                row_overflow)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )
    (grads, g_uv, mask_any, loss, psnr, n_pairs, overflow,
     row_overflow) = fn(
        state.params, state.alive, view, proj, campos, gt_pad,
        jnp.asarray(bg, jnp.float32),
    )
    new_state = apply_adam(state, grads, g_uv, mask_any, iteration, st)
    metrics = StepMetrics(
        loss=loss, psnr=psnr,
        num_visible=jnp.sum(mask_any.astype(jnp.int32)),
        num_pairs=n_pairs, overflow=overflow, row_overflow=row_overflow,
    )
    return new_state, metrics


@functools.lru_cache(maxsize=8)
def get_tp_train_step(st: StepStatics, mesh_devices: tuple,
                      axis: str = "tile"):
    mesh = make_tile_mesh(list(mesh_devices), axis)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, view, proj, campos, gt, bg, iteration):
        return tp_train_step(
            state, view, proj, campos, gt, bg, iteration, st, mesh, axis
        )

    return step


@functools.lru_cache(maxsize=8)
def get_monitored_tp_train_step(st: StepStatics, mesh_devices: tuple,
                                axis: str = "tile"):
    """TP step + the Trainer's on-device window monitor (train/step.py):
    [max_pair_overflow, max_row_overflow, all_losses_finite] reduced every
    step so host boundaries cover the whole window with one fetch."""
    mesh = make_tile_mesh(list(mesh_devices), axis)

    @functools.partial(jax.jit, donate_argnums=(0, 7))
    def step(state, view, proj, campos, gt, bg, iteration, monitor):
        new_state, m = tp_train_step(
            state, view, proj, campos, gt, bg, iteration, st, mesh, axis
        )
        new_monitor = jnp.stack(
            [
                jnp.maximum(monitor[0], m.overflow.astype(jnp.float32)),
                jnp.maximum(
                    monitor[1], m.row_overflow.astype(jnp.float32)
                ),
                jnp.minimum(
                    monitor[2], jnp.isfinite(m.loss).astype(jnp.float32)
                ),
            ]
        )
        return new_state, m, new_monitor

    return step
