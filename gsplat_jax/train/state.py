"""Training state: fixed-capacity parameter arrays + Adam moments.

Replacement for the reference's CudaDataManager
(include/gsplat_cuda/cuda_data.cuh:11-86, cuda/data.cu):
instead of max_gaussians-sized device pools plus ~50 thrust compact/scatter
passes per step, parameters live in dense (N_cap, d) arrays with an ``alive``
mask. Liveness is consumed by kernels as a mask; densification grows into
padded capacity buckets (powers-of-two-ish) so XLA shapes stay static and
recompiles are amortized — mirroring the reference's own pre-allocated pools
(data.cu:9-21) without per-step compaction.

SH layout: always (N_cap, 15, 3) — the full l=3 budget, as the reference
allocates (data.cu:13). The active band is a static l_max; growing a band is
a pure l_max bump (no data movement), because slots are indexed by (l, m)
rather than re-packed per degree like trainer.cu:377-413.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np

from .init import GaussianData

PARAM_DIMS = {
    "xyz": 3,
    "rgb": 3,
    "opacity": 0,  # (N,)
    "scale": 3,
    "quat": 4,
    "sh": (15, 3),
}


class TrainState(NamedTuple):
    params: dict[str, jnp.ndarray]
    adam_m: dict[str, jnp.ndarray]
    adam_v: dict[str, jnp.ndarray]
    alive: jnp.ndarray  # (N_cap,) bool
    uv_grad_accum: jnp.ndarray  # (N_cap,) float32
    accum_dur: jnp.ndarray  # (N_cap,) int32

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])


def round_pair_cap(n: int, minimum: int = 1 << 20) -> int:
    """Pair-stream capacity bucket: ceil to a 2^19 multiple.

    Power-of-two buckets waste up to 2x; every pair-level op (sorts,
    gathers, scatters, the rasterizer stream) scales with the cap, so
    the finer granularity trades a few more recompiles for less work
    per step.
    """
    g = 1 << 19
    if max(n, minimum) >= g:
        return max(minimum, ((n + g - 1) // g) * g)
    # Below bucket granularity (toy/test scales): next power of two.
    cap = max(minimum, 512)
    while cap < n:
        cap *= 2
    return cap


def round_row_cap(n: int, minimum: int = 2048) -> int:
    """Tile-row expansion capacity bucket: ceil to a 2^18 multiple.

    Rows run ~0.5-0.7x the pair count; a finer granularity than the pair
    cap's 2^19 keeps the level-1 expand + strip math sized to the true row
    count (dead rows cost the same as dead pairs per element).
    """
    g = 1 << 18
    if max(n, minimum) >= g:
        return max(minimum, ((n + g - 1) // g) * g)
    cap = max(minimum, 2048)
    while cap < n:
        cap *= 2
    return cap


def round_capacity(n: int, minimum: int = 4096) -> int:
    """Capacity bucket: next power of two (>= minimum) up to 2^22, then
    2^21-granular steps. Pure doubling would jump 4.19M -> 8.39M, which
    both wastes ~2 GB of param+Adam HBM and trips binning's static
    N < 2^23 gate — the reference's own base.yaml ceiling
    (max_gaussians = 4.25M, config/base.yaml:39) must remain reachable."""
    cap = minimum
    while cap < n and cap < (1 << 22):
        cap *= 2
    while cap < n:
        cap += 1 << 21
    return cap


def _zeros_like_group(n_cap: int) -> dict[str, jnp.ndarray]:
    out = {}
    for name, dim in PARAM_DIMS.items():
        if dim == 0:
            shape: tuple[int, ...] = (n_cap,)
        elif isinstance(dim, tuple):
            shape = (n_cap, *dim)
        else:
            shape = (n_cap, dim)
        out[name] = jnp.zeros(shape, jnp.float32)
    return out


def init_state(
    g: GaussianData, n_cap: int | None = None, max_gaussians: int | None = None
) -> TrainState:
    n = g.num
    if n_cap is None:
        n_cap = round_capacity(n)
        if max_gaussians is not None:
            n_cap = min(n_cap, round_capacity(max_gaussians))
    if n > n_cap:
        raise ValueError(f"{n} gaussians exceed capacity {n_cap}")

    def pad(x: np.ndarray, shape) -> jnp.ndarray:
        out = np.zeros(shape, np.float32)
        out[:n] = x
        return jnp.asarray(out)

    params = _zeros_like_group(n_cap)
    params["xyz"] = pad(g.xyz, (n_cap, 3))
    params["rgb"] = pad(g.rgb, (n_cap, 3))
    params["opacity"] = pad(g.opacity, (n_cap,))
    params["scale"] = pad(g.scale, (n_cap, 3))
    params["quat"] = pad(g.quaternion, (n_cap, 4))
    if g.sh is not None:
        params["sh"] = pad(g.sh, (n_cap, 15, 3))

    alive = jnp.asarray(np.arange(n_cap) < n)
    return TrainState(
        params=params,
        adam_m=_zeros_like_group(n_cap),
        adam_v=_zeros_like_group(n_cap),
        alive=alive,
        uv_grad_accum=jnp.zeros((n_cap,), jnp.float32),
        accum_dur=jnp.zeros((n_cap,), jnp.int32),
    )


def grow_state(state: TrainState, new_cap: int) -> TrainState:
    """Re-bucket to a larger capacity (host-side, between steps)."""
    old = state.capacity
    if new_cap <= old:
        return state

    def pad(x):
        pad_width = [(0, new_cap - old)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width)

    import jax

    return TrainState(
        params=jax.tree.map(pad, state.params),
        adam_m=jax.tree.map(pad, state.adam_m),
        adam_v=jax.tree.map(pad, state.adam_v),
        alive=pad(state.alive),
        uv_grad_accum=pad(state.uv_grad_accum),
        accum_dur=pad(state.accum_dur),
    )


def num_active(state: TrainState) -> int:
    return int(jnp.sum(state.alive))


def to_gaussian_data(state: TrainState, l_max: int) -> GaussianData:
    """Extract live Gaussians to host (for PLY export etc.)."""
    alive = np.asarray(state.alive)
    num_sh = (l_max + 1) ** 2 - 1
    sh = None
    if num_sh > 0:
        sh = np.asarray(state.params["sh"])[alive][:, :num_sh, :]
    return GaussianData(
        xyz=np.asarray(state.params["xyz"])[alive],
        rgb=np.asarray(state.params["rgb"])[alive],
        opacity=np.asarray(state.params["opacity"])[alive],
        scale=np.asarray(state.params["scale"])[alive],
        quaternion=np.asarray(state.params["quat"])[alive],
        sh=sh,
    )


def state_flags(state: TrainState) -> dict[str, Any]:
    return {"capacity": state.capacity}
