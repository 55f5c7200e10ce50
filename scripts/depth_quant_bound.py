"""Measure the depth-quantization divergence.

The product tile sort quantizes depth to <= 16-bit log buckets
(ops/binning.py quantize_depth); the reference sorts exact f32 depth
(culling.cu:294-298). This script renders a DENSE adversarial scene (a
tight cluster with heavy per-bucket depth collisions, far denser than any
trained scene's per-tile overlap) twice through the SAME packed pipeline —
default log buckets vs the exact depth-rank fallback mode
(build_tile_tables(depth_rank=...)) — so the ONLY difference is
compositing order. Reports worst-case pixel delta and PSNR; writes
DEPTH_QUANT.json (docs/PARITY.md cites the numbers).

Runs on the real chip. Usage: python scripts/depth_quant_bound.py [n]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scene(n, seed=11):
    from gsplat_jax.train.init import GaussianData
    from gsplat_jax.train.state import init_state, round_capacity

    rng = np.random.default_rng(seed)
    # Tight cluster: ~n/6 Gaussians per tile column on average, with z
    # spread ~1.2 around 5 — a 16-bit log bucket at z=5 is ~1.7e-3 wide,
    # so thousands of (tile, bucket) ties exist per frame.
    g = GaussianData(
        xyz=(rng.normal(size=(n, 3)) * [0.9, 0.7, 0.2] + [0, 0, 5.0]).astype(
            np.float32
        ),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(-1, 2, size=n).astype(np.float32),
        scale=np.log(rng.uniform(0.003, 0.03, size=(n, 3)) * 2.7).astype(
            np.float32
        ),
        quaternion=np.concatenate(
            [np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1
        ).astype(np.float32),
    )
    return init_state(g, n_cap=round_capacity(n))


def main():
    import jax
    import jax.numpy as jnp

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000

    from gsplat_jax.utils.platform import enable_compile_cache

    enable_compile_cache()

    from gsplat_jax.ops.binning import build_tile_tables, depth_key_bits
    from gsplat_jax.ops.camera import build_camera_matrices
    from gsplat_jax.ops.render import pack_attrs, rasterize
    from gsplat_jax.train.step import StepStatics, _per_gaussian

    W, H = 512, 384
    state = build_scene(n)
    cm = build_camera_matrices(
        np.array([1.0, 0, 0, 0]), np.zeros(3), W, H, W * 0.9, W * 0.9
    )
    st = StepStatics(
        width=W, height=H, tile=16, chunk=16, pair_cap=1 << 22,
        row_cap=1 << 21, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0,
        scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=4.0, num_iters=7000,
    )
    view, proj, campos = (jnp.asarray(cm.view), jnp.asarray(cm.proj),
                          jnp.asarray(cm.campos))

    def render(exact_rank: bool):
        def fn(params):
            uv, conic, rgb, mask, radius, z = _per_gaussian(
                params, state.alive, view, proj, campos, st
            )
            attrs = pack_attrs(uv, conic, rgb, params["opacity"])
            rank = None
            if exact_rank:
                order = jnp.argsort(jnp.where(mask, z, jnp.inf))
                rank = (
                    jnp.zeros((z.shape[0],), jnp.int32)
                    .at[order]
                    .set(jnp.arange(z.shape[0], dtype=jnp.int32))
                )
            tables = build_tile_tables(
                uv, z, radius, mask, attrs=attrs,
                num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y,
                tile_size=st.tile, pair_cap=st.pair_cap,
                row_cap=st.row_cap, depth_rank=rank,
            )
            out = rasterize(
                uv, conic, rgb, params["opacity"], tables, jnp.float32(0.0),
                width=W, height=H, tile=st.tile, chunk=st.chunk,
            )
            return out.image, tables.num_pairs
        return jax.jit(fn)(state.params)

    img_q, np_q = render(False)
    img_e, np_e = render(True)
    img_q = np.asarray(img_q)
    img_e = np.asarray(img_e)
    assert int(np_q) == int(np_e), (int(np_q), int(np_e))

    diff = np.abs(img_q - img_e)
    mse = float(np.mean((img_q - img_e) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-20))
    qd_bits = depth_key_bits(st.num_tiles_x * st.num_tiles_y)
    out = {
        "scene": {"n": n, "w": W, "h": H,
                  "num_pairs": int(np_q),
                  "pairs_per_tile_mean": round(
                      int(np_q) / (st.num_tiles_x * st.num_tiles_y), 1)},
        "qd_bits": qd_bits,
        "max_abs_pixel_delta": float(diff.max()),
        "mean_abs_pixel_delta": float(diff.mean()),
        "psnr_db_quantized_vs_exact": round(psnr, 2),
        "pixels_above_half_lsb_8bit": int((diff > 1.0 / 510).sum()),
        "total_pixel_channels": int(diff.size),
    }
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "DEPTH_QUANT.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
