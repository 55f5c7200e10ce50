"""STANDING seeded quality gate: one dense real-texture training recipe as
a single re-runnable command.

Recipe (fixed): real-texture LAYERS dataset (gsplat_jax/tools/real_plane.py,
the zero-egress stand-in for Mip-NeRF 360 garden — reference README.md:75),
32 views at 1296x840, 7000 iterations of the base.yaml-shaped schedule with
uv_grad_threshold x0.4 (a dense setting), seed 0 everywhere.

Writes RESULT_QUALITY_r{NN}.json {psnr, final_gaussians, wall_s, ...} and
EXITS NONZERO if held-out PSNR regresses > 0.3 dB against the best prior
RESULT_QUALITY_r*.json (the first run sets the bar).

Usage: python scripts/quality_gate.py [round_number] [iters]
(round_number defaults to the next free rNN slot; iters defaults to 7000 —
override ONLY for smoke-testing the harness, a non-7000 run never becomes
a gate artifact.)
"""

import glob
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses

REPO = Path(__file__).resolve().parents[1]
PSNR_REGRESSION_DB = 0.3

# Fixed recipe (do not tune per round — this is the point of the gate).
VIEWS = 32
W, H = 1296, 840
ITERS = 7000
THRESH_MUL = 0.4
SEED = 0


def prior_best_psnr() -> tuple[float, str]:
    best, src = None, ""
    for p in glob.glob(str(REPO / "RESULT_QUALITY_r*.json")):
        try:
            v = json.load(open(p)).get("eval_psnr_db_heldout")
        except Exception:
            continue
        if v is not None and (best is None or v > best):
            best, src = float(v), Path(p).name
    if best is None:
        best, src = 0.0, "none"
    return best, src


def next_round_slot() -> int:
    rounds = [
        int(m.group(1))
        for p in glob.glob(str(REPO / "RESULT_QUALITY_r*.json"))
        if (m := re.search(r"RESULT_QUALITY_r(\d+)\.json$", p))
    ]
    return (max(rounds) + 1) if rounds else 5


def main() -> int:
    rnd = int(sys.argv[1]) if len(sys.argv) > 1 else next_round_slot()
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else ITERS

    from gsplat_jax.config import parse_config
    from gsplat_jax.tools.real_plane import write_real_layers_dataset
    from gsplat_jax.train.init import initialize_gaussians
    from gsplat_jax.train.trainer import Trainer
    from gsplat_jax.utils.platform import enable_compile_cache

    # Persistent compile cache: a 7K densifying run crosses ~8 capacity/
    # pair-cap buckets; a rerun finds their programs compiled.
    enable_compile_cache()

    root = Path("/tmp/quality_gate_run")
    t0 = time.time()
    scene = write_real_layers_dataset(root, n_views=VIEWS, width=W, height=H)
    print(f"dataset: layers {VIEWS} views {W}x{H} in {time.time()-t0:.1f}s",
          flush=True)

    cfg_path = REPO / "configs" / "base.yaml"
    frac = iters / parse_config(cfg_path).num_iters

    def s(v):
        return max(1, int(v * frac))

    cfg = dataclasses.replace(
        parse_config(cfg_path),
        dataset_path=scene.name, downsample_factor=1,
        num_iters=iters, print_interval=max(1, iters // 60),
        test_eval_interval=max(50, iters // 10), test_split_ratio=8,
        adaptive_control_start=s(500), adaptive_control_end=s(5000),
        adaptive_control_interval=max(20, s(100)),
        reset_opacity_start=s(1050), reset_opacity_end=s(5000),
        reset_opacity_interval=s(3000),
        use_background_end=s(2000),
        add_sh_band_interval=max(2, s(1000)),
        output_dir=str(root / "out"), strict_reference=False,
        seed=SEED,
    )
    cfg = dataclasses.replace(
        cfg, uv_grad_threshold=cfg.uv_grad_threshold * THRESH_MUL
    )
    g = initialize_gaussians(scene.points_xyz, scene.points_rgb, cfg)
    print(f"init: {g.num} gaussians", flush=True)
    tr = Trainer(cfg, g, scene.images, scene.cameras)
    # TRUE holdout (unlike trainer.cu:203-231's overlapping split).
    test_names = {im.name for im in tr.test_images}
    tr.train_images = [
        im for im in tr.train_images if im.name not in test_names
    ]
    print(f"split: {len(tr.train_images)} train / "
          f"{len(tr.test_images)} held-out", flush=True)
    t0 = time.time()
    tr.train()
    wall_s = time.time() - t0
    psnr = float(tr.evaluate())
    n_alive = int(tr.state.alive.sum())

    import jax

    best, src = prior_best_psnr()
    out = {
        "recipe": {"layout": "layers", "views": VIEWS, "width": W,
                   "height": H, "num_iters": iters,
                   "uv_grad_threshold": cfg.uv_grad_threshold,
                   "seed": SEED},
        "backend": jax.default_backend(),
        "wall_s": round(wall_s, 1),
        "iters_per_second": round(iters / wall_s, 3),
        "final_gaussians": n_alive,
        "eval_psnr_db_heldout": round(psnr, 3),
        "prior_best_psnr_db": round(best, 3),
        "prior_best_source": src,
        "regression_gate_db": PSNR_REGRESSION_DB,
    }
    ok = psnr >= best - PSNR_REGRESSION_DB
    out["gate_ok"] = bool(ok)
    if iters == ITERS:
        path = REPO / f"RESULT_QUALITY_r{rnd:02d}.json"
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}", flush=True)
    print(json.dumps(out), flush=True)
    if not ok:
        print(
            f"QUALITY GATE FAILED: {psnr:.2f} dB < prior best {best:.2f} "
            f"({src}) - {PSNR_REGRESSION_DB}",
            file=sys.stderr, flush=True,
        )
        return 1
    print(f"QUALITY GATE OK: {psnr:.2f} dB (prior best {best:.2f}, {src})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
