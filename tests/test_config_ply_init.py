"""Config parsing, PLY round-trip, and Gaussian-init tests (S0 gates)."""

import numpy as np
import pytest

from gsplat_jax.config import parse_config
from gsplat_jax.io.ply import load_ply, save_ply
from gsplat_jax.train.init import GaussianData, initialize_gaussians

BASE_YAML = """\
dataset_path: garden
downsample_factor: 4
output_dir: splat_output
print_interval: 100
initial_opacity: 0.2
initial_scale_num_neighbors: 3
initial_scale_factor: 0.8
max_initial_scale: 0.1
near_thresh: 0.3
mh_dist: 3.0
cull_mask_padding: 100
num_iters: 7000
ssim_frac: 0.2
base_lr: 1e-3
xyz_lr_multiplier_init: 1.6e-1
xyz_lr_multiplier_final: 1.6e-3
quat_lr_multiplier: 1.0
scale_lr_multiplier: 5.0
opacity_lr_multiplier: 25
rgb_lr_multiplier: 2.5
sh_lr_multiplier: 0.125
test_eval_interval: 500
test_split_ratio: 8
use_background: true
use_background_end: 2000
reset_opacity_interval: 3000
reset_opacity_value: 0.05
reset_opacity_start: 1050
reset_opacity_end: 5000
use_sh_precompute: true
max_sh_band: 3
add_sh_band_interval: 1000
use_split: true
use_clone: true
use_delete: true
adaptive_control_start: 500
adaptive_control_end: 5000
adaptive_control_interval: 100
max_gaussians: 4250000
delete_opacity_threshold: 0.02
uv_grad_threshold: 0.0002
split_scale_factor: 1.6
"""


def test_parse_config_all_fields(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(BASE_YAML)
    cfg = parse_config(p)
    assert cfg.num_iters == 7000
    assert cfg.ssim_frac == pytest.approx(0.2)
    assert cfg.max_gaussians == 4250000
    assert cfg.use_background is True
    assert cfg.xyz_lr_multiplier_init == pytest.approx(0.16)
    assert cfg.strict_reference is True  # extension default


def test_parse_config_missing_key_raises(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(BASE_YAML.replace("mh_dist: 3.0\n", ""))
    with pytest.raises(KeyError, match="mh_dist"):
        parse_config(p)


def test_parse_config_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_config(tmp_path / "nope.yaml")


@pytest.mark.parametrize("name", ["base.yaml", "extended.yaml"])
def test_flat_parser_matches_yaml(name):
    """The PyYAML-free parser gives exactly what yaml.safe_load gives."""
    yaml = pytest.importorskip("yaml")
    from pathlib import Path

    from gsplat_jax.config import parse_flat_yaml

    text = (Path(__file__).parents[1] / "configs" / name).read_text()
    text += "# trailing comment\nquoted: 'a b'  # note\nempty:\nflag: Off\n"
    want = yaml.safe_load(text)
    got = parse_flat_yaml(text)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()
    }


def test_ppm_roundtrip(tmp_path, rng):
    from gsplat_jax.io.images import load_image, read_ppm, write_ppm

    img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    path = tmp_path / "x.ppm"
    write_ppm(path, img)
    np.testing.assert_array_equal(read_ppm(path), img)
    np.testing.assert_array_equal(load_image(str(path)),
                                  img.astype(np.float32) / 255.0)
    # A header comment is legal PPM.
    data = path.read_bytes().replace(b"P6\n", b"P6\n# made by hand\n", 1)
    path.write_bytes(data)
    np.testing.assert_array_equal(read_ppm(path), img)


def test_ply_roundtrip(tmp_path, rng):
    n = 17
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.normal(size=(n, 3)).astype(np.float32)
    op = rng.normal(size=(n,)).astype(np.float32)
    scale = rng.normal(size=(n, 3)).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    sh = rng.normal(size=(n, 9)).astype(np.float32)
    path = tmp_path / "out.ply"
    save_ply(path, xyz, rgb, op, scale, quat, sh)
    out = load_ply(path)
    np.testing.assert_allclose(out["xyz"], xyz, rtol=1e-6)
    np.testing.assert_allclose(out["rgb"], rgb, rtol=1e-6)
    np.testing.assert_allclose(out["opacity"], op, rtol=1e-6)
    np.testing.assert_allclose(out["scale"], scale, rtol=1e-6)
    np.testing.assert_allclose(out["sh"], sh, rtol=1e-6)
    # Quaternions normalized on write (trainer.cu:1189-1191).
    norms = np.linalg.norm(out["quaternion"], axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    expect = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    np.testing.assert_allclose(out["quaternion"], expect, rtol=1e-4, atol=1e-6)


def test_initialize_gaussians_semantics():
    # 4 points on a unit segment: neighbor distances are known.
    xyz = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [10, 0, 0]], float)
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [128, 128, 128]],
                   dtype=np.uint8)
    g = initialize_gaussians(xyz, rgb)
    assert g.num == 4
    # opacity = logit(0.2) (gaussian.cpp:95)
    np.testing.assert_allclose(
        g.opacity, np.log(0.2) - np.log(0.8), rtol=1e-6
    )
    # DC color = (rgb/255 - 0.5)/Y00 (gaussian.cpp:93-94)
    np.testing.assert_allclose(
        g.rgb[0], (np.array([1.0, 0, 0]) - 0.5) / 0.28209479177387814,
        rtol=1e-5,
    )
    # identity quats
    np.testing.assert_allclose(g.quaternion[:, 0], 1.0)
    np.testing.assert_allclose(g.quaternion[:, 1:], 0.0)
    # isotropic scale = log(mean 3-NN distance): point 0 neighbors at 1, 2, 10.
    np.testing.assert_allclose(
        g.scale[0], np.log((1 + 2 + 10) / 3.0), rtol=1e-5
    )
    assert np.all(g.scale[:, 0] == g.scale[:, 1])


def test_gaussian_append_filter():
    def mk(n, base):
        return GaussianData(
            xyz=np.full((n, 3), base, np.float32),
            rgb=np.zeros((n, 3), np.float32),
            opacity=np.zeros((n,), np.float32),
            scale=np.zeros((n, 3), np.float32),
            quaternion=np.zeros((n, 4), np.float32),
        )
    a, b = mk(3, 1.0), mk(2, 2.0)
    c = a.append(b)
    assert c.num == 5
    kept = c.filter(np.array([1, 0, 1, 0, 1], bool))
    assert kept.num == 3
    np.testing.assert_allclose(kept.xyz[:, 0], [1.0, 1.0, 2.0])
