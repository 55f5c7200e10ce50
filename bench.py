"""Benchmark: train-step and render throughput on one GPU.

Times the full jitted train step (projection + SH, binning and the tile
sort, forward and backward rasterize, SSIM+L1 loss, Adam) and the
forward-only render at 1296x840 (the base.yaml operating point, garden at
/4), SH degree 3, for 100K and 1M Gaussians by default (``--gaussians
4250000`` times base.yaml's densification ceiling). Runs only on the GPU.

Usage: python bench.py [--chunk K] [--raster kernel|reference] [--iters N]
                       [--gaussians N,N,...]

``--raster reference`` swaps the Pallas rasterizer for the plain XLA one
(ops/raster_ref.py), the baseline the kernels are timed against.

Prints the device line (JAX's device kind and count, and the card's name
and power limit from nvidia-smi), then ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpix/s", "detail": {...}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

WIDTH, HEIGHT = 1296, 840  # garden @ /4 scale (base.yaml operating point)
BG = 0.2


def bench_scene(n, seed=0):
    """Seeded Gaussians clustered in front of the bench camera."""
    rng = np.random.default_rng(seed)
    from gsplat_jax.train.init import GaussianData
    from gsplat_jax.train.state import init_state, round_capacity

    g = GaussianData(
        xyz=(rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0]).astype(
            np.float32
        ),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(-1.0, 2.0, size=n).astype(np.float32),
        scale=np.log(
            rng.uniform(0.004, 0.04, size=(n, 3)) * (1e6 / n) ** 0.33
        ).astype(np.float32),
        quaternion=np.concatenate(
            [np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1
        ).astype(np.float32),
    )
    return init_state(g, n_cap=round_capacity(n))


def bench_statics(chunk=16, raster="kernel", pair_cap=1 << 21,
                  row_cap=1 << 20):
    """(statics, (view, proj, campos), gt image) of the bench camera."""
    import jax.numpy as jnp

    from gsplat_jax.ops.camera import build_camera_matrices
    from gsplat_jax.train.step import StepStatics

    cm = build_camera_matrices(
        np.array([1.0, 0, 0, 0]), np.zeros(3), WIDTH, HEIGHT,
        WIDTH * 0.85, WIDTH * 0.85,
    )
    st = StepStatics(
        width=WIDTH, height=HEIGHT, tile=16, chunk=chunk, pair_cap=pair_cap,
        row_cap=row_cap, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
        quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=4.0, num_iters=7000, raster=raster,
    )
    cam = (jnp.asarray(cm.view), jnp.asarray(cm.proj), jnp.asarray(cm.campos))
    gt = jnp.asarray(
        np.random.default_rng(1).uniform(0, 1, (HEIGHT, WIDTH, 3))
        .astype(np.float32)
    )
    return st, cam, gt


def sized_step(state, st, cam, gt):
    """Run the first train step, growing the pair and row capacities to
    the bucket just above the true counts (as the Trainer's overflow
    growth does) until nothing is dropped. Returns (state, st, metrics)."""
    import jax.numpy as jnp

    from gsplat_jax.train.state import round_pair_cap, round_row_cap
    from gsplat_jax.train.step import get_train_step

    while True:
        state, metrics = get_train_step(st)(
            state, *cam, gt, jnp.float32(BG), jnp.int32(0)
        )
        overflow = int(metrics.overflow)
        row_overflow = int(metrics.row_overflow)
        if overflow <= st.pair_cap and row_overflow <= st.row_cap:
            return state, st, metrics
        st = dataclasses.replace(
            st,
            pair_cap=round_pair_cap(max(overflow, st.pair_cap)),
            row_cap=round_row_cap(max(row_overflow, st.row_cap)),
        )


def bench_point(n_gaussians: int, iters: int, chunk: int, raster: str):
    import jax.numpy as jnp

    from gsplat_jax.train.step import get_render_fn, get_train_step

    st, cam, gt = bench_statics(chunk, raster)
    t0 = time.perf_counter()
    state, st, metrics = sized_step(bench_scene(n_gaussians), st, cam, gt)
    setup_s = time.perf_counter() - t0
    step = get_train_step(st)
    # A host fetch (not just dispatch) brackets every timed region.
    _ = float(metrics.loss)
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step(state, *cam, gt, jnp.float32(BG),
                              jnp.int32(i + 1))
    loss = float(metrics.loss)
    dt = (time.perf_counter() - t0) / iters

    render = get_render_fn(st)
    img = render(state.params, state.alive, *cam, jnp.float32(BG))
    _ = float(img[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        img = render(state.params, state.alive, *cam, jnp.float32(BG))
    _ = float(img[0, 0, 0])
    fwd_dt = (time.perf_counter() - t0) / iters
    return {
        "mpix_s": WIDTH * HEIGHT / dt / 1e6,
        "step_ms": dt * 1e3,
        "render_ms": fwd_dt * 1e3,
        "render_mpix_s": WIDTH * HEIGHT / fwd_dt / 1e6,
        "num_pairs": int(metrics.num_pairs),
        "pair_cap": st.pair_cap,
        "row_overflow": int(metrics.row_overflow),
        "row_cap": st.row_cap,
        "loss": loss,
        "setup_s": setup_s,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunk", type=int, default=16,
                   help="splats per rasterizer chunk (StepStatics.chunk)")
    p.add_argument("--raster", choices=("kernel", "reference"),
                   default="kernel")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--gaussians", default="100000,1000000",
                   help="comma-separated scene sizes; the headline value "
                        "is the last one's")
    args = p.parse_args(argv)

    import jax

    from gsplat_jax.utils.platform import describe_gpu, enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX backend is "
                         f"{jax.default_backend()!r}")
    enable_compile_cache()
    device = describe_gpu()
    print("# device:", json.dumps(device), flush=True)
    sizes = [int(n) for n in args.gaussians.split(",")]
    points = {
        str(n): bench_point(n, args.iters, args.chunk, args.raster)
        for n in sizes
    }
    print(json.dumps({
        "metric": f"train-step Mpixels/s @{sizes[-1]} gaussians (1296x840, "
                  "SH deg 3, SSIM+L1, Adam)",
        "value": points[str(sizes[-1])]["mpix_s"],
        "unit": "Mpix/s",
        "detail": {"device": device, "chunk": args.chunk,
                   "raster": args.raster, **points},
    }))


if __name__ == "__main__":
    main()
