"""Gaussian initialization from an SfM point cloud.

Parity with the reference initializer (src/gaussian.cpp:38-104):

- isotropic log-scale from the mean distance to the 3 nearest neighbors
  (k-d tree; 0.01 fallback when a point has no neighbors),
- color converted to the SH DC coefficient ``(rgb/255 - 0.5) / Y00`` with
  ``Y00 = 0.28209479177387814`` (gaussian.cpp:93-94),
- opacity initialized to ``logit(0.2)`` (gaussian.cpp:95),
- identity quaternion.

The reference hardcodes opacity/neighbor-count (its ``initial_*`` config
fields are dead); with ``strict_reference=False`` we honor them
(``initial_opacity``, ``initial_scale_num_neighbors``,
``initial_scale_factor`` multiplier, ``max_initial_scale`` clamp).

Uses scipy's cKDTree in place of nanoflann; a native C++ KNN (native/) is used
when built, for large clouds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ConfigParameters

Y00 = 0.28209479177387814


@dataclasses.dataclass
class GaussianData:
    """Host-side struct-of-arrays Gaussian container (gaussian.hpp:17-33)."""

    xyz: np.ndarray  # (N, 3) float32
    rgb: np.ndarray  # (N, 3) float32 — SH DC coefficients
    opacity: np.ndarray  # (N,) float32 — logits
    scale: np.ndarray  # (N, 3) float32 — log-scales
    quaternion: np.ndarray  # (N, 4) float32 — (w, x, y, z)
    sh: np.ndarray | None = None  # (N, K, 3) float32 higher bands

    @property
    def num(self) -> int:
        return int(self.xyz.shape[0])

    def append(self, other: "GaussianData") -> "GaussianData":
        """Concatenate two containers (gaussian.cpp:106-124 semantics)."""
        if other.num == 0:
            return self
        sh = None
        if self.sh is not None and other.sh is not None:
            sh = np.concatenate([self.sh, other.sh], axis=0)
        return GaussianData(
            xyz=np.concatenate([self.xyz, other.xyz], axis=0),
            rgb=np.concatenate([self.rgb, other.rgb], axis=0),
            opacity=np.concatenate([self.opacity, other.opacity], axis=0),
            scale=np.concatenate([self.scale, other.scale], axis=0),
            quaternion=np.concatenate([self.quaternion, other.quaternion], axis=0),
            sh=sh,
        )

    def filter(self, mask: np.ndarray) -> "GaussianData":
        """Keep rows where mask is True (gaussian.cpp:126-164 semantics)."""
        mask = np.asarray(mask, dtype=bool)
        assert mask.shape[0] == self.num, "Mask size must match"
        return GaussianData(
            xyz=self.xyz[mask],
            rgb=self.rgb[mask],
            opacity=self.opacity[mask],
            scale=self.scale[mask],
            quaternion=self.quaternion[mask],
            sh=None if self.sh is None else self.sh[mask],
        )


def _knn_mean_dist(xyz: np.ndarray, k: int) -> np.ndarray:
    """Mean distance to each point's k nearest neighbors (self excluded).

    Uses the native C++ kd-tree (native/gsplat_native.cpp) when built,
    falling back to scipy's cKDTree."""
    from ..io import native

    if native.available():
        out = native.knn_mean_dist(np.asarray(xyz, np.float64), k)
        if out is not None:
            return out

    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    # k+1 because the query point itself is returned at distance 0.
    dists, _ = tree.query(xyz, k=k + 1, workers=-1)
    neigh = dists[:, 1:]
    valid = np.isfinite(neigh)
    counts = valid.sum(axis=1)
    sums = np.where(valid, neigh, 0.0).sum(axis=1)
    mean = np.where(counts > 0, sums / np.maximum(counts, 1), 0.01)
    return mean.astype(np.float32)


def initialize_gaussians(
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    config: ConfigParameters | None = None,
) -> GaussianData:
    """Build initial Gaussians from SfM points (gaussian.cpp:38-104).

    Args:
      points_xyz: (N, 3) float positions.
      points_rgb: (N, 3) uint8 colors in [0, 255].
    """
    xyz = np.asarray(points_xyz, dtype=np.float64)
    n = xyz.shape[0]
    if n == 0:
        return GaussianData(
            xyz=np.zeros((0, 3), np.float32),
            rgb=np.zeros((0, 3), np.float32),
            opacity=np.zeros((0,), np.float32),
            scale=np.zeros((0, 3), np.float32),
            quaternion=np.zeros((0, 4), np.float32),
        )

    strict = config is None or config.strict_reference
    k = 3 if strict else int(config.initial_scale_num_neighbors)
    opacity0 = 0.2 if strict else float(config.initial_opacity)

    avg_dist = _knn_mean_dist(xyz, k) if n > 1 else np.full((n,), 0.01, np.float32)
    # Reference feeds avg_dist straight into log() — zero distance duplicated
    # points would give -inf; guard with the same 0.01 fallback it uses for
    # isolated points.
    avg_dist = np.where(avg_dist > 0, avg_dist, 0.01).astype(np.float32)
    if not strict:
        avg_dist = avg_dist * float(config.initial_scale_factor)
        avg_dist = np.minimum(avg_dist, float(config.max_initial_scale))

    rgb01 = np.asarray(points_rgb, dtype=np.float32) / 255.0
    dc = (rgb01 - 0.5) / Y00

    quat = np.zeros((n, 4), dtype=np.float32)
    quat[:, 0] = 1.0

    return GaussianData(
        xyz=xyz.astype(np.float32),
        rgb=dc.astype(np.float32),
        opacity=np.full((n,), np.log(opacity0) - np.log(1.0 - opacity0), np.float32),
        scale=np.repeat(np.log(avg_dist)[:, None], 3, axis=1).astype(np.float32),
        quaternion=quat,
    )
