"""COLMAP reader/writer round-trip + semantics tests.

Mirrors the reference dataloader test strategy (tests/colmap_test.cpp) with
self-generated binary fixtures; also parses the reference's checked-in
test_data when available (read-only integration check).
"""

import math
from pathlib import Path

import numpy as np
import pytest

from gsplat_jax.io import colmap

REF_TEST_DATA = Path("test_data")


def _make_fixture(tmp_path):
    cams = {
        1: colmap.Camera(
            id=1, model="PINHOLE", width=1920, height=1080,
            params=np.array([1000.0, 990.0, 960.0, 540.0]),
        ),
        2: colmap.Camera(
            id=2, model="SIMPLE_PINHOLE", width=640, height=480,
            params=np.array([500.0, 320.0, 240.0]),
        ),
    }
    imgs = {
        7: colmap.Image(
            id=7,
            qvec=np.array([0.7071067811865476, 0.0, 0.7071067811865476, 0.0]),
            tvec=np.array([1.0, -2.0, 3.0]),
            camera_id=1,
            name="photo_a.jpg",
            xys=np.array([[1.5, 2.5], [3.0, 4.0]]),
            point3d_ids=np.array([11, 22], dtype=np.int64),
        ),
        8: colmap.Image(
            id=8,
            qvec=np.array([1.0, 0.0, 0.0, 0.0]),
            tvec=np.zeros(3),
            camera_id=2,
            name="photo_b.jpg",
            xys=np.zeros((0, 2)),
            point3d_ids=np.zeros((0,), dtype=np.int64),
        ),
    }
    pts = {
        11: colmap.Point3D(
            id=11,
            xyz=np.array([0.1, 0.2, 0.3]),
            rgb=np.array([255, 128, 0], dtype=np.uint8),
            error=0.5,
            image_ids=np.array([7], dtype=np.int32),
            point2d_idxs=np.array([0], dtype=np.int32),
        ),
    }
    colmap.write_cameras_binary(cams, tmp_path / "cameras.bin")
    colmap.write_images_binary(imgs, tmp_path / "images.bin")
    colmap.write_points3d_binary(pts, tmp_path / "points3D.bin")
    return cams, imgs, pts


def test_cameras_roundtrip_and_downsample(tmp_path):
    cams, _, _ = _make_fixture(tmp_path)
    out = colmap.read_cameras_binary(tmp_path / "cameras.bin", 1)
    assert set(out) == {1, 2}
    assert out[1].model == "PINHOLE"
    np.testing.assert_allclose(out[1].params, cams[1].params)
    assert out[1].width == 1920 and out[1].height == 1080
    assert out[2].focal_x == out[2].focal_y == 500.0

    # Downsample: params divided, dims round()'d (colmap.cpp:87-92).
    out4 = colmap.read_cameras_binary(tmp_path / "cameras.bin", 4)
    np.testing.assert_allclose(out4[1].params, cams[1].params / 4.0)
    assert out4[1].width == 480 and out4[1].height == 270


def test_images_roundtrip_and_path_synthesis(tmp_path):
    _, imgs, _ = _make_fixture(tmp_path)
    out = colmap.read_images_binary(tmp_path / "images.bin", "root/", 4)
    assert out[7].name == "root/images_4/photo_a.jpg"
    out1 = colmap.read_images_binary(tmp_path / "images.bin", "root/", 1)
    assert out1[7].name == "root/images/photo_a.jpg"
    np.testing.assert_allclose(out[7].qvec, imgs[7].qvec)
    np.testing.assert_allclose(out[7].tvec, imgs[7].tvec)
    np.testing.assert_allclose(out[7].xys, imgs[7].xys)
    np.testing.assert_array_equal(out[7].point3d_ids, imgs[7].point3d_ids)
    assert out[8].xys.shape == (0, 2)


def test_points3d_roundtrip(tmp_path):
    _, _, pts = _make_fixture(tmp_path)
    out = colmap.read_points3d_binary(tmp_path / "points3D.bin")
    p = out[11]
    np.testing.assert_allclose(p.xyz, pts[11].xyz)
    np.testing.assert_array_equal(p.rgb, pts[11].rgb)
    assert p.error == 0.5
    np.testing.assert_array_equal(p.image_ids, [7])


def test_qvec_rotmat_and_campos():
    # 90-degree rotation about +y.
    q = np.array([math.cos(math.pi / 4), 0.0, math.sin(math.pi / 4), 0.0])
    r = colmap.qvec_to_rotmat(q)
    np.testing.assert_allclose(r @ np.array([1.0, 0, 0]), [0, 0, -1], atol=1e-12)
    img = colmap.Image(
        id=0, qvec=q, tvec=np.array([1.0, 2.0, 3.0]), camera_id=0,
        name="", xys=np.zeros((0, 2)), point3d_ids=np.zeros(0, np.int64),
    )
    np.testing.assert_allclose(img.cam_pos(), -r.T @ img.tvec)


def test_compute_max_diagonal():
    def img(q, t, i):
        return colmap.Image(
            id=i, qvec=np.array(q, float), tvec=np.array(t, float),
            camera_id=0, name="", xys=np.zeros((0, 2)),
            point3d_ids=np.zeros(0, np.int64),
        )
    # Identity rotations: centers = -t.
    images = {
        0: img([1, 0, 0, 0], [1.0, 0, 0], 0),
        1: img([1, 0, 0, 0], [-1.0, 0, 0], 1),
        2: img([1, 0, 0, 0], [0, 0, 0], 2),
    }
    assert colmap.compute_max_diagonal(images) == pytest.approx(1.0)
    assert colmap.compute_max_diagonal({}) == 0.0


def test_unsupported_camera_model(tmp_path):
    import struct
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 4, 100, 100))  # OPENCV model
        f.write(struct.pack("<8d", *([1.0] * 8)))
    with pytest.raises(colmap.ColmapError):
        colmap.read_cameras_binary(tmp_path / "bad.bin")


@pytest.mark.skipif(not REF_TEST_DATA.exists(), reason="reference data absent")
def test_reference_fixture_parses():
    cams = colmap.read_cameras_binary(REF_TEST_DATA / "cameras.bin", 1)
    imgs = colmap.read_images_binary(REF_TEST_DATA / "images.bin", "", 1)
    pts = colmap.read_points3d_binary(REF_TEST_DATA / "points3D.bin")
    assert len(cams) >= 1 and len(imgs) >= 1 and len(pts) >= 1
    for cam in cams.values():
        assert cam.model in ("PINHOLE", "SIMPLE_PINHOLE")
        assert cam.width > 0 and cam.height > 0
    for p in pts.values():
        assert p.xyz.shape == (3,)
    expect = 0.0 if len(imgs) == 1 else None
    d = colmap.compute_max_diagonal(imgs)
    assert d == expect if expect is not None else d > 0.0
