"""Garden-scale stability run on the GPU: full resolution, long
schedule, densification growth, opacity resets, SH schedule, cap growth.

The zero-egress proxy for training Mip-NeRF 360 garden @ /4 (1296x840):
a synthetic scene at the same resolution and schedule shape. Validates that
the trainer survives thousands of steps with capacity growth and reports
eval PSNR trajectory + throughput.

Usage: python scripts/train_at_scale.py [iters] [width height]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
W = int(sys.argv[2]) if len(sys.argv) > 2 else 1296
H = int(sys.argv[3]) if len(sys.argv) > 3 else 840


def main():
    from gsplat_jax.config import parse_config
    from gsplat_jax.io.colmap import (
        read_cameras_binary, read_images_binary, read_points3d_binary,
    )
    from gsplat_jax.tools.synthetic import write_synthetic_dataset
    from gsplat_jax.train.init import initialize_gaussians
    from gsplat_jax.train.trainer import Trainer

    tmp = Path(tempfile.mkdtemp(prefix="gsplat_scale_"))
    print(f"dataset dir: {tmp}")
    t0 = time.time()
    write_synthetic_dataset(
        tmp, name="scene", n_views=24, width=W, height=H,
        n_gaussians=6000, n_points=20000, point_jitter=0.1,
    )
    print(f"dataset written in {time.time() - t0:.1f}s")

    cfg = dataclasses.replace(
        parse_config(Path(__file__).resolve().parents[1] / "configs" / "base.yaml"),
        dataset_path="scene", downsample_factor=1,
        num_iters=ITERS, max_gaussians=2_000_000,
        print_interval=500, test_eval_interval=500,
        adaptive_control_start=300, adaptive_control_interval=100,
        adaptive_control_end=max(ITERS - 300, 301),
        reset_opacity_start=900, reset_opacity_interval=1500,
        reset_opacity_end=max(ITERS - 300, 901),
        add_sh_band_interval=500, max_sh_band=3,
        use_background=False, output_dir=str(tmp / "out"),
        test_split_ratio=8, seed=11, strict_reference=False,
    )

    sparse = tmp / "scene" / "sparse" / "0"
    cameras = read_cameras_binary(sparse / "cameras.bin", 1)
    images = read_images_binary(sparse / "images.bin", str(tmp / "scene") + "/", 1)
    points = read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in points.values()])
    rgb = np.stack([p.rgb for p in points.values()])
    g = initialize_gaussians(xyz, rgb, cfg)
    trainer = Trainer(cfg, g, images, cameras)

    p0 = trainer.evaluate(verbose=False)
    print(f"init: {g.num} gaussians, PSNR {p0:.2f} dB, "
          f"pair_cap {trainer.pair_cap}")
    t0 = time.time()
    trainer.train(verbose=True)
    dt = time.time() - t0
    p1 = trainer.evaluate(verbose=False)
    alive = int(np.asarray(trainer.state.alive).sum())
    trainer.save_to_ply(tmp / "final.ply")
    trainer.save_checkpoint(tmp / "final.npz")
    result = {
        "iters": ITERS, "wall_s": round(dt, 1),
        "it_per_s": round(ITERS / dt, 2),
        "psnr_init": round(p0, 2), "psnr_final": round(p1, 2),
        "gaussians_final": alive, "pair_cap_final": trainer.pair_cap,
        "l_max": trainer.l_max, "resolution": f"{W}x{H}",
    }
    print("RESULT " + json.dumps(result))


if __name__ == "__main__":
    main()
