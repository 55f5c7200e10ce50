"""Training orchestration — the Trainer.

Mirrors the reference Trainer facade and training loop
(include/gsplat/trainer.hpp:21-77, cuda/trainer.cu:1199-1458):
constructor takes (config, gaussians, images, cameras); ``test_train_split``
sorts images by name and sends every ``test_split_ratio``-th to the test set
while keeping ALL images in the train set (trainer.cu:203-231); ``train``
runs the full schedule — SH band growth, adaptive densification with Morton
re-sort and accumulator resets, opacity resets, periodic eval PSNR and image
dumps — and ``save_to_ply`` exports the result.

Differences by design:
- the whole iteration is ONE jitted XLA program (per camera-geometry bucket);
  the host never syncs except at print/eval/density boundaries;
- Gaussian capacity and the pair-stream capacity live in power-of-two buckets
  that grow on demand (re-jit amortized), replacing the reference's exact
  per-step sizing D2H syncs (SURVEY §3.3);
- densification RNG is a counter-based JAX PRNG keyed by (seed, iter),
  deterministic across runs and replicas (the reference seeds time(NULL)).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConfigParameters
from ..io.colmap import Camera, Image, compute_max_diagonal
from ..io.images import AsyncImageLoader, load_image, write_ppm
from ..io.ply import save_ply
from ..ops.camera import CameraMatrices, build_camera_matrices
from ..ops.loss import compute_psnr
from ..utils.platform import kernel_interpret
from .density import DensityStatics, get_density_fns, reset_opacity, zero_sh
from .init import GaussianData
from .progress import ProgressBar
from .state import (
    grow_state, init_state, round_capacity, round_pair_cap, round_row_cap,
    to_gaussian_data,
)
from .step import (
    StepStatics, fresh_monitor, get_monitored_train_step, get_render_fn,
)


def _auto_pair_cap(
    n_gaussians: int, width: int, height: int, tile: int = 16
) -> int:
    # Rough initial sizing; grows on overflow. ~8 tiles/Gaussian visible,
    # but never beyond the hard bound of every Gaussian in every tile
    # (which keeps toy scenes on toy-sized graphs).
    n_tiles = ((width + tile - 1) // tile) * ((height + tile - 1) // tile)
    return round_pair_cap(
        min(8 * n_gaussians, n_gaussians * n_tiles), minimum=512
    )


class Trainer:
    def __init__(
        self,
        config: ConfigParameters,
        gaussians: GaussianData,
        images: dict[int, Image],
        cameras: dict[int, Camera],
        dp: int = 0,
        tp: int = 0,
    ):
        """``dp``: number of devices for camera-batch data parallelism
        (0/1 = single-chip). Each step shards ``dp`` cameras over a 1-D
        device mesh with replicated parameters (parallel/data_parallel.py).
        Heterogeneous camera intrinsics are supported by geometry
        bucketing: each batch draws within one (W, H, fx, fy) bucket.
        ``tp``: number of devices for tile-sharded single-camera training
        (parallel/tile_parallel.py) — one camera per step, the image's
        tile rows sharded over the mesh. dp and tp are mutually exclusive.
        Both are capability extensions — the reference is strictly
        single-GPU (SURVEY §2.6)."""
        self.config = config
        self.images = images
        self.cameras = cameras
        self.dp = int(dp) if dp and dp > 1 else 0
        self.tp = int(tp) if tp and tp > 1 else 0
        if self.dp and self.tp:
            raise ValueError("dp and tp modes are mutually exclusive")
        if self.dp or self.tp:
            n_dev = len(jax.devices())
            want = self.dp or self.tp
            if want > n_dev:
                raise ValueError(
                    f"dp/tp={want} exceeds available devices ({n_dev})"
                )
        # dp with heterogeneous intrinsics: cameras are BUCKETED by
        # geometry (W, H, fx, fy) and every DP batch is drawn within one
        # bucket, so each jitted step sees a single static geometry. The
        # reference rebuilds proj per image each iteration
        # (trainer.cu:1299-1339); a jitted step compiles once per bucket
        # instead. See train() for the counter-based bucket draw.
        # Kernels compile for the GPU; interpret mode only when the caller
        # asked for the CPU (JAX_PLATFORMS=cpu).
        self.interpret = kernel_interpret()
        self.state = init_state(
            gaussians, max_gaussians=config.max_gaussians
        )
        self.iter = 0
        self.l_max = 0
        # scene extent for density thresholds and the xyz LR
        # (trainer.cu:1275): 1.1 x max camera-center spread.
        self.scene_extent = 1.1 * compute_max_diagonal(images)
        self.train_images: list[Image] = []
        self.test_images: list[Image] = []
        self.pair_cap = config.pair_cap or _auto_pair_cap(
            gaussians.num,
            max((c.width for c in cameras.values()), default=1024),
            max((c.height for c in cameras.values()), default=1024),
        )
        # Floor for overflow-driven growth (amortizes early recompiles at
        # production scale) — bounded by the scene's hard pair maximum so
        # toy scenes never jump to production-sized graphs.
        # Camera dims are already downsample-rescaled by the COLMAP reader.
        n_tiles_max = max(
            (
                ((c.width + 15) // 16) * ((c.height + 15) // 16)
                for c in cameras.values()
            ),
            default=1 << 12,
        )
        self.pair_cap_minimum = min(
            1 << 20,
            round_pair_cap(
                config.max_gaussians * n_tiles_max, minimum=2048
            ),
        )
        # Tile-row expansion capacity, grown independently from the pair
        # cap (row_overflow vs overflow): scenes where rows ~= 0.6 x pairs
        # would otherwise force the pair cap to 2x the row need (20-30%
        # dead tail in every pair-wide sort/kernel).
        self.row_cap = max(self.pair_cap // 2, 2048)
        self._cam_cache: dict[tuple, CameraMatrices] = {}
        self.test_train_split()

    # ------------------------------------------------------------------
    def test_train_split(self) -> None:
        """Every split-th image (sorted by name) also goes to the test set;
        ALL images remain in the train set (trainer.cu:203-231)."""
        split = self.config.test_split_ratio
        ordered = sorted(self.images.values(), key=lambda im: im.name)
        self.test_images = []
        self.train_images = []
        if not ordered:
            return
        if split <= 0:
            self.train_images = list(ordered)
            return
        for i, img in enumerate(ordered):
            if i % split == 0:
                self.test_images.append(img)
            self.train_images.append(img)

    # ------------------------------------------------------------------
    def _matrices(self, img: Image) -> CameraMatrices:
        key = (img.id,)
        if key not in self._cam_cache:
            cam = self.cameras[img.camera_id]
            self._cam_cache[key] = build_camera_matrices(
                img.qvec, img.tvec, cam.width, cam.height,
                cam.focal_x, cam.focal_y,
            )
        return self._cam_cache[key]

    def _statics(self, cm: CameraMatrices) -> StepStatics:
        c = self.config
        return StepStatics(
            width=cm.width, height=cm.height,
            tile=c.tile_size, chunk=c.chunk_size, pair_cap=self.pair_cap,
            row_cap=self.row_cap, l_max=self.l_max,
            focal_x=cm.focal_x, focal_y=cm.focal_y,
            tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
            near_thresh=c.near_thresh, mh_dist=c.mh_dist,
            cull_padding=c.cull_mask_padding, ssim_frac=c.ssim_frac,
            base_lr=c.base_lr,
            xyz_lr_init=c.xyz_lr_multiplier_init,
            xyz_lr_final=c.xyz_lr_multiplier_final,
            quat_lr=c.quat_lr_multiplier, scale_lr=c.scale_lr_multiplier,
            opacity_lr=c.opacity_lr_multiplier, rgb_lr=c.rgb_lr_multiplier,
            sh_lr=c.sh_lr_multiplier,
            scene_extent=float(self.scene_extent),
            num_iters=c.num_iters, interpret=self.interpret,
        )

    def _density_statics(self) -> DensityStatics:
        c = self.config
        strict = c.strict_reference
        return DensityStatics(
            scene_extent=float(self.scene_extent),
            uv_grad_threshold=c.uv_grad_threshold,
            delete_opacity_threshold=c.delete_opacity_threshold,
            split_scale_factor=c.split_scale_factor,
            max_gaussians=c.max_gaussians,
            use_split=True if strict else c.use_split,
            use_clone=True if strict else c.use_clone,
            use_delete=True if strict else c.use_delete,
        )

    # ------------------------------------------------------------------
    def _bg(self, iteration: int) -> float:
        c = self.config
        if not c.use_background:
            return 0.0
        if not c.strict_reference and iteration >= c.use_background_end:
            return 0.0  # live extension of the dead use_background_end field
        return (iteration % 255) / 255.0

    def _dp_bucket_choice(self, k: int, buckets: list[list[int]]) -> int:
        """Counter-based, size-weighted geometry-bucket draw for iteration
        ``k``: depends only on (seed, k) — like AsyncImageLoader's draws —
        so a resumed run picks the identical bucket sequence. Weighting by
        bucket size keeps every image's long-run sampling frequency equal
        to the homogeneous case."""
        import random as _random

        n = len(self.train_images)
        r = _random.Random(self.config.seed * 7_919 + k).randrange(n)
        for j, b in enumerate(buckets):
            r -= len(b)
            if r < 0:
                return j
        return len(buckets) - 1

    def _maybe_add_sh_band(self, iteration: int) -> None:
        c = self.config
        if (
            iteration % c.add_sh_band_interval == 0
            and iteration >= c.add_sh_band_interval
            and self.l_max < c.max_sh_band
        ):
            if self.l_max == 0:
                self.state = zero_sh(self.state)
            self.l_max += 1

    # ------------------------------------------------------------------
    def train(self, max_iters: int | None = None, verbose: bool = True) -> None:
        c = self.config
        num_iters = max_iters if max_iters is not None else c.num_iters
        if self.dp:
            # Bucket train-image positions by camera geometry; each DP
            # batch draws within ONE bucket so the jitted step's static
            # (W, H, focal) holds (one compiled program per bucket). The
            # bucket choice is counter-based and size-weighted, so resume
            # replays the identical bucket/image sequence. A single-
            # geometry scene degrades to exactly the old single-loader
            # path (one bucket, seed unchanged).
            groups: dict[tuple, list[int]] = {}
            for pos, im in enumerate(self.train_images):
                cam = self.cameras[im.camera_id]
                key = (cam.width, cam.height, cam.focal_x, cam.focal_y)
                groups.setdefault(key, []).append(pos)
            dp_buckets = list(groups.values())
            consumed = [0] * len(dp_buckets)
            if len(dp_buckets) > 1:
                for k in range(self.iter):
                    consumed[self._dp_bucket_choice(k, dp_buckets)] += 1
            else:
                consumed[0] = self.iter
            loaders = [
                AsyncImageLoader(
                    [self.train_images[p].name for p in bucket],
                    seed=c.seed + 1_000_003 * bi,
                    # Queue depth covers a full dp batch plus the next one
                    # so the dp step's B draws were all decoded during the
                    # previous device step.
                    prefetch=2 * self.dp,
                    start=consumed[bi] * self.dp,
                )
                for bi, bucket in enumerate(dp_buckets)
            ]
            loader = loaders[0]
        else:
            dp_buckets = [list(range(len(self.train_images)))]
            loader = AsyncImageLoader(
                [im.name for im in self.train_images], seed=c.seed,
                # counter-based draws: resume == uninterrupted.
                prefetch=2,
                start=self.iter,
            )
            loaders = [loader]
        bar = ProgressBar(num_iters) if verbose else None
        out_dir = Path(c.output_dir)
        eval_interval = (
            3000 if c.strict_reference else max(c.test_eval_interval, 1)
        )
        monitor = fresh_monitor()
        window_start = self.iter
        try:
            while self.iter < num_iters:
                self._maybe_add_sh_band(self.iter)
                if self.dp:
                    bi = (
                        self._dp_bucket_choice(self.iter, dp_buckets)
                        if len(dp_buckets) > 1 else 0
                    )
                    posmap = dp_buckets[bi]
                    draws = [loaders[bi].next() for _ in range(self.dp)]
                    cms = [
                        self._matrices(self.train_images[posmap[i]])
                        for i, _ in draws
                    ]
                    cm = cms[0]
                    st = self._statics(cm)
                    from ..parallel.data_parallel import (
                        get_monitored_dp_train_step,
                    )

                    step = get_monitored_dp_train_step(
                        st, tuple(jax.devices()[: self.dp])
                    )
                    bg = jnp.float32(self._bg(self.iter))
                    self.state, dpm, monitor = step(
                        self.state,
                        jnp.stack([jnp.asarray(m.view) for m in cms]),
                        jnp.stack([jnp.asarray(m.proj) for m in cms]),
                        jnp.stack([jnp.asarray(m.campos) for m in cms]),
                        jnp.stack([gt for _, gt in draws]),
                        jnp.broadcast_to(bg, (self.dp,)),
                        jnp.int32(self.iter),
                        monitor,
                    )
                    loss_arr = dpm["loss"]
                elif self.tp:
                    idx, gt = loader.next()
                    img = self.train_images[idx]
                    cm = self._matrices(img)
                    st = self._statics(cm)
                    from ..parallel.tile_parallel import (
                        get_monitored_tp_train_step,
                    )

                    step = get_monitored_tp_train_step(
                        st, tuple(jax.devices()[: self.tp])
                    )
                    self.state, metrics, monitor = step(
                        self.state,
                        jnp.asarray(cm.view), jnp.asarray(cm.proj),
                        jnp.asarray(cm.campos), gt,
                        jnp.float32(self._bg(self.iter)),
                        jnp.int32(self.iter),
                        monitor,
                    )
                    loss_arr = metrics.loss
                else:
                    idx, gt = loader.next()
                    img = self.train_images[idx]
                    cm = self._matrices(img)
                    st = self._statics(cm)
                    step = get_monitored_train_step(st)
                    self.state, metrics, monitor = step(
                        self.state,
                        jnp.asarray(cm.view), jnp.asarray(cm.proj),
                        jnp.asarray(cm.campos), gt,
                        jnp.float32(self._bg(self.iter)),
                        jnp.int32(self.iter),
                        monitor,
                    )
                    loss_arr = metrics.loss

                boundary = (
                    self.iter % c.print_interval == 0
                    or (
                        self.iter > c.adaptive_control_start
                        and self.iter % c.adaptive_control_interval == 0
                        and self.iter < c.adaptive_control_end
                    )
                )
                if boundary:
                    # The monitor accumulates ON DEVICE every step, so this
                    # one fetch covers every iteration since window_start —
                    # no silent pair drop or NaN can hide inside a window.
                    mon = np.asarray(monitor)
                    monitor = fresh_monitor()
                    overflow = int(mon[0])
                    row_overflow = int(mon[1])
                    # Headroom: during densification the pair count climbs
                    # steadily and every cap bump recompiles the step —
                    # overshoot 25% to amortize. Once densification ends
                    # the counts only drift with the camera, so size tight
                    # (~6%): every pair-wide sort/kernel pays for the cap.
                    densifying = self.iter < c.adaptive_control_end
                    shift = 2 if densifying else 4
                    if overflow > self.pair_cap:
                        self.pair_cap = round_pair_cap(
                            overflow + (overflow >> shift),
                            minimum=self.pair_cap_minimum,
                        )
                    if row_overflow > self.row_cap:
                        self.row_cap = round_row_cap(
                            row_overflow + (row_overflow >> shift)
                        )
                    if not mon[2] > 0.0:
                        # Failure detection (capability extension; the
                        # reference exits blindly, SURVEY §5): surface the
                        # window and stop rather than training on NaN.
                        raise FloatingPointError(
                            "non-finite loss in iterations "
                            f"[{window_start}, {self.iter}]"
                        )
                    window_start = self.iter + 1
                    if bar is not None:
                        bar.update(
                            self.iter, float(loss_arr),
                            int(jnp.sum(self.state.alive)),
                        )

                if self.iter % c.print_interval == 0:
                    self._dump_image(cm, out_dir)

                if self.iter % eval_interval == 0:
                    self.evaluate(verbose=verbose)

                if (
                    self.iter > c.adaptive_control_start
                    and self.iter % c.adaptive_control_interval == 0
                    and self.iter < c.adaptive_control_end
                ):
                    self._density_step()

                if (
                    self.iter > c.reset_opacity_start
                    and self.iter % c.reset_opacity_interval == 0
                    and self.iter < c.reset_opacity_end
                ):
                    self.state = reset_opacity(
                        self.state, c.reset_opacity_value
                    )

                self.iter += 1
        finally:
            for ld in loaders:
                ld.close()
            if bar is not None:
                bar.finish()

    # ------------------------------------------------------------------
    def _density_step(self) -> None:
        ds = self._density_statics()
        step, sort = get_density_fns(ds)
        key = jax.random.key(self.config.seed * 1_000_003 + self.iter)
        new_state, info = step(self.state, key)
        if bool(info.needs_grow):
            new_cap = round_capacity(
                int(info.new_total),
                minimum=self.state.capacity * 2,
            )
            new_cap = min(new_cap, round_capacity(self.config.max_gaussians))
            self.state = grow_state(self.state, new_cap)
            new_state, info = step(self.state, key)
        self.state = sort(new_state)

    # ------------------------------------------------------------------
    def _dump_image(self, cm: CameraMatrices, out_dir: Path) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        img = self.render(cm, bg=self._bg(self.iter))
        arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        write_ppm(out_dir / f"rendered_image_{self.iter}.ppm", arr)

    def render(self, cm: CameraMatrices, bg: float = 0.0):
        st = self._statics(cm)
        fn = get_render_fn(st)
        return fn(
            self.state.params, self.state.alive,
            jnp.asarray(cm.view), jnp.asarray(cm.proj),
            jnp.asarray(cm.campos), jnp.float32(bg),
        )

    def evaluate(self, verbose: bool = True) -> float | None:
        """Render all test images (black background) and report mean PSNR
        (trainer.cu:263-361).

        Pipelined, unlike the reference's serial load->render->sync loop:
        a decode thread prefetches the next image while the device renders
        the current one, and the per-image PSNR scalars stay ON DEVICE
        until one stacked fetch at the end, so the host never waits on the
        device between images."""
        if not self.test_images:
            return None
        import queue as _queue
        import threading

        loads: _queue.Queue = _queue.Queue(maxsize=2)

        def _producer():
            for img in self.test_images:
                try:
                    gt = load_image(img.name)
                except OSError as e:
                    loads.put((img, None, e))
                else:
                    loads.put((img, gt, None))
            loads.put(None)

        thread = threading.Thread(target=_producer, daemon=True)
        thread.start()
        psnrs = []  # device scalars; drained once below
        skipped = []
        while True:
            item = loads.get()
            if item is None:
                break
            img, gt, err = item
            if err is not None:
                skipped.append(f"{img.name}: {err}")
                continue
            cm = self._matrices(img)
            pred = self.render(cm, bg=0.0)
            psnrs.append(compute_psnr(pred, jnp.asarray(gt)))
        thread.join()
        if psnrs:
            psnrs = list(np.asarray(jnp.stack(psnrs)))  # one device fetch
        if skipped:
            # Loud: a broken dataset path must not silently shrink the
            # eval set (round-1 review weak item 7).
            import warnings

            warnings.warn(
                f"evaluate(): skipped {len(skipped)}/"
                f"{len(self.test_images)} unreadable test images "
                f"(first: {skipped[0]})",
                stacklevel=2,
            )
        if not psnrs:
            return None
        mean = float(np.mean(psnrs))
        if verbose:
            print(f"\n[ITER {self.iter}] Eval PSNR: {mean:.4f}")
        return mean

    # ------------------------------------------------------------------
    def save_to_ply(self, filename: str | Path) -> None:
        g = to_gaussian_data(self.state, self.l_max)
        sh = None
        if g.sh is not None and g.sh.size:
            sh = g.sh.reshape(g.num, -1)
        save_ply(filename, g.xyz, g.rgb, g.opacity, g.scale, g.quaternion, sh)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str | Path) -> None:
        from ..utils.checkpoint import config_hash, save_checkpoint

        save_checkpoint(
            path, self.state, self.iter, self.l_max,
            pair_cap=self.pair_cap, cfg_hash=config_hash(self.config),
            row_cap=self.row_cap,
        )

    def load_checkpoint(self, path: str | Path) -> None:
        from ..utils.checkpoint import config_hash, load_checkpoint

        ck = load_checkpoint(path)
        if ck.config_hash and ck.config_hash != config_hash(self.config):
            # Loud, not fatal: resuming under a changed config (e.g. more
            # iterations) is a legitimate workflow, but it must never be
            # silent — the run is no longer a reproduction of the original.
            import warnings

            warnings.warn(
                f"checkpoint {path} was written under a different config "
                "(hash mismatch); resumed run will not bit-reproduce the "
                "original schedule",
                stacklevel=2,
            )
        self.state, self.iter, self.l_max = ck.state, ck.iteration, ck.l_max
        if ck.pair_cap:
            self.pair_cap = ck.pair_cap
        if getattr(ck, "row_cap", 0):
            self.row_cap = ck.row_cap
        else:  # pre-decoupling checkpoint: legacy coupled sizing
            self.row_cap = max(self.pair_cap // 2, 2048)
