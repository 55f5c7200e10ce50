"""CLI entry point: ``python -m gsplat_jax.cli <config.yaml> <dataset_root>``.

Parity with the reference binary (src/main.cpp:10-98):
parse config, read the three COLMAP .bin files from
``<dataset_root>/<dataset_path>/sparse/0/``, initialize Gaussians from the
SfM points, split, train, and write ``<output_dir>/trained.ply``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> int:
    from .utils.platform import enable_compile_cache

    enable_compile_cache()

    argv = list(sys.argv[1:] if argv is None else argv)

    def usage() -> int:
        print(
            "Usage: python -m gsplat_jax.cli <config.yaml> <dataset_root> "
            "[--resume ckpt.npz] [--dp N] [--tp N] [--max-iters N]",
            file=sys.stderr,
        )
        return 1

    def take_flag(name: str, cast):
        """Pop '--name value' from argv; None if absent, usage-error on a
        missing or malformed value (instead of an IndexError traceback)."""
        if name not in argv:
            return None, None
        i = argv.index(name)
        if i + 1 >= len(argv):
            return None, f"{name} needs a value"
        try:
            val = cast(argv[i + 1])
        except ValueError:
            return None, f"{name} got non-{cast.__name__} {argv[i + 1]!r}"
        del argv[i : i + 2]
        return val, None

    vals = {}
    for name, cast in (("--resume", str), ("--dp", int), ("--tp", int),
                       ("--max-iters", int)):
        # --dp: camera-batch data parallelism over a 1-D device mesh
        #   (capability extension; parallel/data_parallel.py).
        # --tp: tile-sharded single-camera training (tile rows over N
        #   devices; parallel/tile_parallel.py).
        # --max-iters: stop early without changing the config's schedule
        #   (useful for partial runs later resumed with --resume).
        vals[name], err = take_flag(name, cast)
        if err is not None:
            print(f"error: {err}", file=sys.stderr)
            return usage()
    resume = vals["--resume"]
    dp = vals["--dp"] or 0
    tp = vals["--tp"] or 0
    max_iters = vals["--max-iters"]
    if len(argv) != 2:
        return usage()

    from .config import parse_config
    from .io.colmap import (
        read_cameras_binary, read_images_binary, read_points3d_binary,
    )
    from .train.init import initialize_gaussians
    from .train.trainer import Trainer

    config = parse_config(argv[0])
    root = Path(argv[1]) / config.dataset_path
    sparse = root / "sparse" / "0"

    print(f"Loading COLMAP reconstruction from {sparse} ...")
    cameras = read_cameras_binary(
        sparse / "cameras.bin", config.downsample_factor
    )
    images = read_images_binary(
        sparse / "images.bin", str(root) + "/", config.downsample_factor
    )
    from .io import native

    if native.available():
        xyz, rgb, _, _ = native.parse_points3d(sparse / "points3D.bin")
        n_points = xyz.shape[0]
    else:
        points = read_points3d_binary(sparse / "points3D.bin")
        xyz = np.stack([p.xyz for p in points.values()])
        rgb = np.stack([p.rgb for p in points.values()])
        n_points = len(points)
    print(f"  {len(cameras)} cameras, {len(images)} images, "
          f"{n_points} points")
    t0 = time.time()
    gaussians = initialize_gaussians(xyz, rgb, config)
    print(f"Initialized {gaussians.num} gaussians in {time.time() - t0:.2f}s")

    trainer = Trainer(config, gaussians, images, cameras, dp=dp, tp=tp)
    if resume is not None:
        trainer.load_checkpoint(resume)
        print(f"Resumed from {resume} at iteration {trainer.iter}")
    trainer.train(max_iters=max_iters)

    ck = Path(config.output_dir) / "checkpoint.npz"
    trainer.save_checkpoint(ck)
    print(f"Saved checkpoint to {ck}")

    out = Path(config.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    trainer.save_to_ply(out / "trained.ply")
    print(f"Saved PLY to {out / 'trained.ply'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
