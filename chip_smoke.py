"""Smoke test of the system on the GPU, through its user entry points.

Usage:
  python chip_smoke.py           one card: phases 1-4
  python chip_smoke.py --multi   four cards: phase 5 only

Phases (any failure ends the run with a nonzero exit and no result line):
1. Device: the GPU platform, the card's name and power limit, the compile
   cache directory.
2. CLI: a seeded synthetic COLMAP scene at 1296x840 (16 views, garden's /4
   layout), the base.yaml schedule with only the dataset and output paths
   changed, trained by ``cli.main`` for 610 iterations: past the first
   densification round (iteration 600), its capacity growth and the
   re-jitted steps after it. The loss must fall and trained.ply load back.
3. Step: bench.py's 1M-Gaussian scene at 1296x840, SH degree 3; a few
   train steps and renders, with their times, and a check that the
   lowered programs call the compiled Triton kernels.
4. Parity at that scene: each Pallas kernel against the plain XLA
   rasterizer (ops/raster_ref.py), and the binning tables against a plain
   key+gid sort of their own pairs, every error printed beside its limit.
5. (--multi) Camera-parallel (--dp 4, identical cameras) and tile-parallel
   (--tp 4) steps against the one-card step, and one densification round
   under DP.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Parity limits (see CHANGES.md): f32 on both sides of the same packed
# stream; the backward's log-space transmittance and the scatter-add's
# run-to-run summation order are the only differences from the reference.
IMAGE_MAX_ABS = 1e-3
FLIP_FRACTION = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_COSINE = 0.9999


def log(*args):
    print(*args, flush=True)


def check(name, value, limit, ok):
    log(f"  {name}: {value:.3e} (limit {limit:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} out of limit")


def phase_device():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit("chip_smoke: no GPU (JAX backend "
                         f"{jax.default_backend()!r})")
    from gsplat_jax.utils.platform import describe_gpu, enable_compile_cache

    cache = enable_compile_cache()
    dev = describe_gpu()
    log(f"[1 device] {dev['kind']} x{dev['count']} ({dev['platform']})")
    log(f"nvidia-smi: {dev['nvidia_smi']}")
    log(f"compile cache: {cache}")
    return dev


def _scene_loss(g, cameras, images, n_views=4):
    """Mean training loss (SSIM+L1) of Gaussians ``g`` over a few views."""
    import jax.numpy as jnp

    from gsplat_jax.io.images import load_image
    from gsplat_jax.ops.camera import build_camera_matrices
    from gsplat_jax.ops.loss import fused_loss
    from gsplat_jax.train.state import init_state
    from gsplat_jax.train.step import StepStatics, get_render_fn

    state = init_state(g)
    cam = cameras[1]
    losses = []
    for im in sorted(images.values(), key=lambda i: i.name)[:n_views]:
        cm = build_camera_matrices(im.qvec, im.tvec, cam.width, cam.height,
                                   cam.focal_x, cam.focal_y)
        st = StepStatics(
            width=cam.width, height=cam.height, tile=16, chunk=16,
            pair_cap=1 << 22, l_max=0, focal_x=cm.focal_x,
            focal_y=cm.focal_y, tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
            near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
            base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
            quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5,
            sh_lr=0.125, scene_extent=2.0, num_iters=1,
        )
        img = get_render_fn(st)(state.params, state.alive,
                                jnp.asarray(cm.view), jnp.asarray(cm.proj),
                                jnp.asarray(cm.campos), jnp.float32(0.0))
        losses.append(float(fused_loss(img, jnp.asarray(load_image(im.name)),
                                       0.2)))
    return float(np.mean(losses))


def phase_cli(tmp: Path, width=1296, height=840):
    from gsplat_jax import cli
    from gsplat_jax.config import parse_config
    from gsplat_jax.io.colmap import read_points3d_binary
    from gsplat_jax.io.ply import load_ply
    from gsplat_jax.tools.synthetic import write_synthetic_dataset
    from gsplat_jax.train.init import GaussianData, initialize_gaussians
    from gsplat_jax.train.trainer import Trainer

    t0 = time.perf_counter()
    scene = write_synthetic_dataset(tmp / "data", n_views=16, width=width,
                                    height=height, downsample_factor=4,
                                    seed=7)
    log(f"[2 cli] synthetic scene written in {time.perf_counter() - t0:.1f} s")
    cfg_path = tmp / "config.yaml"
    text = (REPO / "configs" / "base.yaml").read_text()
    text = re.sub(r"(?m)^dataset_path:.*$", "dataset_path: synthetic", text)
    text = re.sub(r"(?m)^output_dir:.*$", f"output_dir: {tmp / 'out'}", text)
    cfg_path.write_text(text)

    # Count densification rounds and capacity growth on the CLI's path.
    rounds = []
    density_step = Trainer._density_step

    def counted(self):
        cap, n = self.state.capacity, int(self.state.alive.sum())
        density_step(self)
        rounds.append((self.iter, n, int(self.state.alive.sum()), cap,
                       self.state.capacity))

    Trainer._density_step = counted
    try:
        t0 = time.perf_counter()
        rc = cli.main([str(cfg_path), str(tmp / "data"),
                       "--max-iters", "610"])
        train_s = time.perf_counter() - t0
    finally:
        Trainer._density_step = density_step
    if rc != 0:
        raise SystemExit(f"chip_smoke: cli.main returned {rc}")
    log(f"[2 cli] 610 iterations in {train_s:.1f} s (compiles included)")
    for it, n0, n1, c0, c1 in rounds:
        log(f"  densify @{it}: gaussians {n0} -> {n1}, capacity {c0} -> {c1}")
    if len(rounds) != 1:
        raise SystemExit(f"chip_smoke: {len(rounds)} densification rounds")

    config = parse_config(cfg_path)
    pts = read_points3d_binary(tmp / "data" / "synthetic" / "sparse" / "0"
                               / "points3D.bin")
    init = initialize_gaussians(np.stack([p.xyz for p in pts.values()]),
                                np.stack([p.rgb for p in pts.values()]),
                                config)
    ply = load_ply(tmp / "out" / "trained.ply")
    trained = GaussianData(xyz=ply["xyz"], rgb=ply["rgb"],
                           opacity=ply["opacity"], scale=ply["scale"],
                           quaternion=ply["quaternion"])
    loss0 = _scene_loss(init, scene.cameras, scene.images)
    loss1 = _scene_loss(trained, scene.cameras, scene.images)
    log(f"  loss on 4 training views: initial {loss0:.5f} -> trained "
        f"{loss1:.5f}; trained.ply holds {trained.num} gaussians")
    if not (np.isfinite(loss1) and loss1 < 0.8 * loss0):
        raise SystemExit("chip_smoke: training loss did not fall")


def assert_triton(name, fn, args, kernels):
    """The lowered program calls each named Pallas kernel through Triton."""
    hlo = fn.lower(*args).as_text()
    missing = [k for k in kernels if k not in hlo]
    if "triton" not in hlo or missing:
        raise SystemExit(f"chip_smoke: {name} lacks Triton kernels {missing}")


def phase_step(n_gaussians=1_000_000):
    import jax
    import jax.numpy as jnp

    from bench import BG, bench_scene, bench_statics, sized_step
    from gsplat_jax.train.step import get_render_fn, get_train_step

    st, cam, gt = bench_statics()
    t0 = time.perf_counter()
    state, st, metrics = sized_step(bench_scene(n_gaussians), st, cam, gt)
    log(f"[3 step] sized and compiled in {time.perf_counter() - t0:.1f} s: "
        f"{int(metrics.num_pairs)} pairs, pair_cap {st.pair_cap}, "
        f"row_cap {st.row_cap}")
    step, render = get_train_step(st), get_render_fn(st)
    args = (*cam, gt, jnp.float32(BG))
    assert_triton("step", step, (state, *args, jnp.int32(1)),
                  ("gsplat_rasterize_fwd", "gsplat_rasterize_bwd"))
    assert_triton("render", render,
                  (state.params, state.alive, *cam, jnp.float32(BG)),
                  ("gsplat_rasterize_fwd",))
    log("  lowered step and render call the Triton kernels "
        "gsplat_rasterize_fwd/bwd")
    losses = []
    t0 = time.perf_counter()
    for i in range(5):
        state, metrics = step(state, *args, jnp.int32(i + 1))
        losses.append(metrics.loss)
    losses = [float(x) for x in losses]
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    img = render(state.params, state.alive, *cam, jnp.float32(BG))
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    for _ in range(5):
        img = render(state.params, state.alive, *cam, jnp.float32(BG))
    img = np.asarray(img)
    render_ms = (time.perf_counter() - t0) / 5 * 1e3
    if not (np.isfinite(losses).all() and np.isfinite(img).all()
            and img.shape == (st.height, st.width, 3)):
        raise SystemExit("chip_smoke: non-finite step or render")
    log(f"  {n_gaussians} gaussians: {step_ms:.2f} ms/step, {render_ms:.2f} ms/render "
        f"(5 each, host clock), losses {losses[0]:.5f} .. {losses[-1]:.5f}")
    return state, st, cam


def _families(a, b):
    out = {}
    for name, cols in (("uv", slice(0, 2)), ("conic", slice(2, 5)),
                       ("opacity", slice(5, 6)), ("rgb", slice(6, 9))):
        x = a[:, cols].astype(np.float64).ravel()
        y = b[:, cols].astype(np.float64).ravel()
        out[name] = (np.linalg.norm(x - y) / np.linalg.norm(y),
                     x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    return out


def phase_parity(state, st, cam):
    import jax
    import jax.numpy as jnp

    from bench import BG
    from gsplat_jax.kernels import rasterize as kern
    from gsplat_jax.ops import raster_ref
    from gsplat_jax.ops.binning import (
        build_tile_tables, depth_key_bits, quantize_depth, tile_sort,
    )
    from gsplat_jax.ops.render import pack_attrs
    from gsplat_jax.train.step import _per_gaussian

    @jax.jit
    def tables_of(params, alive):
        uv, conic, rgb, mask, radius, z = _per_gaussian(
            params, alive, *cam, st)
        t = build_tile_tables(
            uv, z, radius, mask,
            attrs=pack_attrs(uv, conic, rgb, params["opacity"]),
            num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y,
            tile_size=st.tile, pair_cap=st.pair_cap, row_cap=st.row_cap,
        )
        return t, z

    tables, z = tables_of(state.params, state.alive)
    n = state.capacity
    nt = st.num_tiles_x * st.num_tiles_y
    geom = dict(num_tiles_x=st.num_tiles_x, num_tiles=nt, tile=st.tile,
                k=st.chunk)
    fargs = (tables.stream, tables.tile_start, tables.tile_count,
             jnp.float32(BG))
    log(f"[4 parity] {int(tables.num_pairs)} pairs, {nt} tiles, "
        f"chunk {st.chunk}")
    out_k = jax.jit(lambda *a: kern.rasterize_forward(*a, **geom))(*fargs)
    with jax.default_matmul_precision("highest"):
        out_r = jax.jit(
            lambda *a: raster_ref.raster_forward_ref(*a, **geom))(*fargs)
    out_k, out_r = np.asarray(out_k), np.asarray(out_r)
    check("forward image max|d|", np.abs(out_k[:, :3] - out_r[:, :3]).max(),
          IMAGE_MAX_ABS, np.abs(out_k[:, :3] - out_r[:, :3]).max()
          <= IMAGE_MAX_ABS)
    flips = np.mean((out_k[:, 3] < kern.T_EPS) != (out_r[:, 3] < kern.T_EPS))
    check("T<1e-4 decision flips (fraction of pixels)", flips,
          FLIP_FRACTION, flips < FLIP_FRACTION)

    di = jnp.asarray(np.random.default_rng(5).standard_normal(
        (nt, 3, st.tile ** 2)).astype(np.float32))
    out = jnp.asarray(out_r)
    tfin = out[:, 3:4]
    pix = jnp.concatenate([
        di, tfin, out[:, 4:5], BG * jnp.sum(di, 1, keepdims=True),
        jnp.sum(di * (out[:, 0:3] - tfin * BG), 1, keepdims=True),
        jnp.zeros_like(tfin)], axis=1)
    bargs = (tables.stream, tables.splat_gid, pix, tables.tile_start,
             tables.tile_count)
    scale = (0.5 * st.num_tiles_x * st.tile, 0.5 * st.num_tiles_y * st.tile)
    g_k = jax.jit(lambda *a: kern.rasterize_backward(
        *a, n, **geom, grad_scale=scale))(*bargs)
    with jax.default_matmul_precision("highest"):
        g_r = jax.jit(lambda *a: raster_ref.raster_backward_ref(
            *a, n, **geom, grad_scale=scale))(*bargs)
    for name, (rel, cos) in _families(np.asarray(g_k),
                                      np.asarray(g_r)).items():
        check(f"backward {name} grad rel L2", rel, GRAD_REL_L2,
              rel <= GRAD_REL_L2)
        check(f"backward {name} grad cosine", 1.0 - cos, 1.0 - GRAD_COSINE,
              cos >= GRAD_COSINE)

    # Tables vs a plain key+gid sort of their own (shuffled) pairs.
    qd_bits = depth_key_bits(nt)
    gid = np.asarray(tables.splat_gid)
    start, count = np.asarray(tables.tile_start), np.asarray(tables.tile_count)
    n_pairs = int(tables.num_pairs)
    tile = np.repeat(np.arange(nt, dtype=np.int32), count)
    g = gid[:n_pairs]
    key = (tile << qd_bits) | np.asarray(quantize_depth(z, qd_bits))[g]
    perm = np.random.default_rng(9).permutation(n_pairs)
    k_s, g_s = tile_sort(jnp.asarray(key[perm]), jnp.asarray(g[perm]), ())
    bounds = np.asarray(jnp.searchsorted(
        k_s, jnp.arange(nt + 1, dtype=jnp.int32) << qd_bits))
    bad = int((bounds[:-1] != start).sum() + (np.diff(bounds) != count).sum()
              + (np.asarray(g_s) != g).sum() + (gid[n_pairs:] != -1).sum())
    check("binning table mismatches vs plain sort", float(bad), 0.0,
          bad == 0)


def phase_multi(dev, n_gaussians=1_000_000):
    """DP 4 and TP 4 against the one-card step; densify under DP."""
    import jax
    import jax.numpy as jnp

    from bench import BG, bench_scene, bench_statics, sized_step
    from gsplat_jax.ops.adam import B1
    from gsplat_jax.parallel.data_parallel import get_dp_train_step
    from gsplat_jax.parallel.tile_parallel import get_tp_train_step
    from gsplat_jax.train.density import DensityStatics, get_density_fns
    from gsplat_jax.train.step import get_train_step

    if dev["count"] < 4:
        raise SystemExit(f"chip_smoke --multi needs 4 cards, has "
                         f"{dev['count']}")
    devices = tuple(jax.devices()[:4])
    st, cam, gt = bench_statics()
    state0, st, _ = sized_step(bench_scene(n_gaussians), st, cam, gt)
    it = jnp.int32(1)
    snapshot = jax.tree.map(jnp.copy, state0)
    ref_state, ref_m = get_train_step(st)(
        jax.tree.map(jnp.copy, snapshot), *cam, gt, jnp.float32(BG), it)
    log(f"[5 multi] one-card step: loss {float(ref_m.loss):.6f}")

    def grads(state):
        # The step's gradient, recovered from Adam's first moment. The
        # parameter update itself is no measure of agreement: Adam's step
        # divides each gradient by its own magnitude, so a near-zero
        # gradient whose sign follows the f32 summation order moves its
        # parameter by +-lr either way.
        return {k: (np.asarray(state.adam_m[k], np.float64)
                    - B1 * np.asarray(snapshot.adam_m[k], np.float64))
                / (1.0 - B1) for k in ("xyz", "opacity", "rgb", "scale",
                                       "quat")}

    ref_g = grads(ref_state)

    def compare(tag, state, loss):
        check(f"{tag} loss rel diff",
              abs(float(loss) - float(ref_m.loss)) / abs(float(ref_m.loss)),
              1e-5, abs(float(loss) - float(ref_m.loss))
              <= 1e-5 * abs(float(ref_m.loss)))
        for k, g in grads(state).items():
            a = ref_g[k]
            rel = np.linalg.norm(g - a) / max(np.linalg.norm(a), 1e-30)
            check(f"{tag} {k} grad rel L2", rel, 1e-3, rel <= 1e-3)

    b = 4
    views, projs, campos = (jnp.stack([x] * b) for x in cam)
    gts = jnp.stack([gt] * b)
    bgs = jnp.full((b,), BG, jnp.float32)
    dp = get_dp_train_step(st, devices)
    dp_state, dp_m = dp(jax.tree.map(jnp.copy, snapshot), views, projs,
                        campos, gts, bgs, it)
    compare("dp4", dp_state, dp_m["loss"])
    tp = get_tp_train_step(st, devices)
    tp_state, tp_m = tp(jax.tree.map(jnp.copy, snapshot), *cam, gt,
                        jnp.float32(BG), it)
    compare("tp4", tp_state, tp_m.loss)

    ds = DensityStatics(
        scene_extent=4.0, uv_grad_threshold=2e-4,
        delete_opacity_threshold=0.02, split_scale_factor=1.6,
        max_gaussians=dp_state.capacity, use_split=True, use_clone=True,
        use_delete=True,
    )
    dstep, dsort = get_density_fns(ds)
    dstate, info = dstep(dp_state, jax.random.key(1_000_003))
    dstate = dsort(dstate)
    n0, n1 = int(dp_state.alive.sum()), int(dstate.alive.sum())
    dstate, m = dp(dstate, views, projs, campos, gts, bgs, jnp.int32(2))
    if not np.isfinite(float(m["loss"])):
        raise SystemExit("chip_smoke: non-finite loss after DP densify")
    log(f"  dp4 densify: {n0} -> {n1} gaussians, next step loss "
        f"{float(m['loss']):.6f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card DP/TP phase")
    args = p.parse_args(argv)
    dev = phase_device()
    if args.multi:
        phase_multi(dev)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_cli(Path(tmp))
        state, st, cam = phase_step()
        phase_parity(state, st, cam)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))


if __name__ == "__main__":
    sys.exit(main())
