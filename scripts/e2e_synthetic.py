"""End-to-end convergence drive on the GPU with a synthetic scene.

Builds a ground-truth Gaussian scene, renders K camera views with the
framework's own renderer (gsplat_jax.tools.synthetic), then trains a fresh
model from a noisy point cloud through the full Trainer (densify, SH
schedule, PLY export) and asserts the eval PSNR improves substantially.
This is the no-dataset proxy for the garden benchmark (zero-egress
environment: Mip-NeRF 360 data cannot be downloaded).

Usage: python scripts/e2e_synthetic.py [iters]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 600


def main():
    from gsplat_jax.config import parse_config
    from gsplat_jax.tools.synthetic import write_synthetic_dataset
    from gsplat_jax.train.init import initialize_gaussians
    from gsplat_jax.train.trainer import Trainer

    tmp = Path(tempfile.mkdtemp(prefix="gsplat_e2e_"))
    scene = write_synthetic_dataset(
        tmp, name="scene", n_views=16, width=384, height=256,
        n_gaussians=1200, n_points=4000,
    )
    print(f"GT views rendered to {tmp}/scene")

    cfg = dataclasses.replace(
        parse_config(Path(__file__).resolve().parents[1] / "configs" / "base.yaml"),
        dataset_path="scene", downsample_factor=1,
        num_iters=ITERS, max_gaussians=200_000,
        print_interval=10 ** 9, test_eval_interval=10 ** 9,
        adaptive_control_start=150, adaptive_control_interval=100,
        adaptive_control_end=max(ITERS - 100, 151),
        reset_opacity_start=10 ** 9, reset_opacity_interval=10 ** 9,
        reset_opacity_end=10 ** 9,
        add_sh_band_interval=200, max_sh_band=2,
        use_background=False, output_dir=str(tmp / "out"),
        test_split_ratio=8, seed=3, strict_reference=False,
    )

    gaussians = initialize_gaussians(
        scene.points_xyz, scene.points_rgb, cfg
    )
    trainer = Trainer(cfg, gaussians, scene.images, scene.cameras)
    p0 = trainer.evaluate(verbose=False)
    print(f"init: {gaussians.num} gaussians, eval PSNR {p0:.2f} dB")
    t0 = time.time()
    trainer.train(verbose=False)
    dt = time.time() - t0
    p1 = trainer.evaluate(verbose=False)
    alive = int(np.asarray(trainer.state.alive).sum())
    print(f"after {ITERS} iters ({dt:.1f}s, {ITERS/dt:.1f} it/s): "
          f"eval PSNR {p1:.2f} dB, {alive} gaussians, l_max={trainer.l_max}")
    trainer.save_to_ply(tmp / "final.ply")
    print("PLY saved:", (tmp / "final.ply").stat().st_size, "bytes")
    assert p1 > p0 + 6.0, f"insufficient convergence: {p0:.2f} -> {p1:.2f}"
    print("E2E CONVERGENCE OK")


if __name__ == "__main__":
    main()
