"""Single-image overfit on a REAL photograph (BASELINE.json config 2).

The environment has zero egress, so no multi-view real dataset (Mip-NeRF
360 garden etc.) can be obtained; the one real photograph available is the
reference's own README asset. Overfitting it exercises real-image
statistics (texture, edges, exposure) that self-rendered synthetic GT
cannot: 10K Gaussians, SH degree 3 active from the start, no
densification, fixed camera — and reports eval PSNR over iterations.

Usage: python scripts/overfit_real.py [iters] [n_gaussians]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import time

import jax
import jax.numpy as jnp
import numpy as np

from gsplat_jax.io.images import load_image
from gsplat_jax.ops.camera import build_camera_matrices
from gsplat_jax.train.init import GaussianData
from gsplat_jax.train.state import init_state, round_capacity, round_pair_cap
from gsplat_jax.train.step import StepStatics, get_train_step

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
N = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
IMG = "assets/overview.jpg"

gt_np = load_image(IMG)
H, W = gt_np.shape[:2]
print(f"real photo {IMG}: {W}x{H}")

rng = np.random.default_rng(0)
# Gaussians seeded on a plane in front of the camera, colored by the image
# (SfM-free init for a single-view overfit).
z0 = 4.0
focal = W * 0.9
xs = rng.uniform(0, W, N)
ys = rng.uniform(0, H, N)
xyz = np.stack(
    [
        (xs - W / 2) / focal * z0,
        (ys - H / 2) / focal * z0,
        np.full(N, z0) + rng.normal(0, 0.05, N),
    ],
    axis=1,
).astype(np.float32)
C0 = 0.28209479177387814
rgb0 = gt_np[
    np.clip(ys.astype(int), 0, H - 1), np.clip(xs.astype(int), 0, W - 1)
]
g = GaussianData(
    xyz=xyz,
    rgb=((rgb0 - 0.5) / C0).astype(np.float32),
    opacity=np.full(N, 0.0, np.float32),
    scale=np.log(np.full((N, 3), 2.0 * z0 / focal * (10_000 / N) ** 0.5)).astype(
        np.float32
    ),
    quaternion=np.concatenate(
        [np.ones((N, 1)), np.zeros((N, 3))], axis=1
    ).astype(np.float32),
)
state = init_state(g, n_cap=round_capacity(N))
cm = build_camera_matrices(
    np.array([1.0, 0, 0, 0]), np.zeros(3), W, H, focal, focal
)
pair_cap = round_pair_cap(30 * N)
st = StepStatics(
    width=W, height=H, tile=16, chunk=16, pair_cap=pair_cap, l_max=3,
    focal_x=cm.focal_x, focal_y=cm.focal_y,
    tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
    near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
    base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
    quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
    scene_extent=1.0, num_iters=max(ITERS, 1),
)
view, proj = jnp.asarray(cm.view), jnp.asarray(cm.proj)
campos = jnp.asarray(cm.campos)
gt = jnp.asarray(gt_np)
step = get_train_step(st)

t0 = time.time()
for i in range(ITERS):
    state, m = step(
        state, view, proj, campos, gt, jnp.float32(0.0), jnp.int32(i)
    )
    if i % 200 == 0 or i == ITERS - 1:
        print(
            f"iter {i:5d} loss {float(m.loss):.4f} PSNR {float(m.psnr):6.2f} "
            f"pairs {int(m.num_pairs)} ({time.time()-t0:.0f}s)",
            flush=True,
        )
        if int(m.overflow) > st.pair_cap:
            print("  (pair overflow: results undercount)", flush=True)
print(f"final PSNR on the real photo: {float(m.psnr):.2f} dB")
