"""Worker process for the 2-process multi-host CPU test (test_multihost.py).

Each process contributes 2 virtual CPU devices; jax.distributed stitches
them into one 4-device global mesh, and one dp_train_step runs with real
cross-process collectives (the only multi-host evidence obtainable in a
single-machine environment — SURVEY §2.6 / VERDICT r1 item 5).

Usage: python multihost_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # also selects interpret-mode kernels
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402

from gsplat_jax.utils.platform import enable_compile_cache  # noqa: E402

# The DP program costs minutes to compile on a small host; the shared
# persistent cache makes the 2-process proof affordable.
enable_compile_cache()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> int:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from gsplat_jax.parallel import initialize_multihost, make_mesh
    from gsplat_jax.parallel.data_parallel import dp_train_step
    from gsplat_jax.train.state import init_state

    initialize_multihost(coord, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    from test_train import _synthetic_gaussians, _statics, W, H

    rng = np.random.default_rng(0)  # identical scene on every process
    state = init_state(_synthetic_gaussians(rng, 32), n_cap=64)
    cm, st = _statics()

    b = jax.device_count()
    mesh = make_mesh()  # global mesh over both processes
    shd = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def global_sharded(host_np):
        return jax.make_array_from_callback(
            host_np.shape, shd, lambda idx: host_np[idx]
        )

    views = global_sharded(np.tile(cm.view, (b, 1, 1)).astype(np.float32))
    projs = global_sharded(np.tile(cm.proj, (b, 1, 1)).astype(np.float32))
    campos = global_sharded(np.tile(cm.campos, (b, 1)).astype(np.float32))
    gts = global_sharded(
        np.random.default_rng(1).uniform(0, 1, (b, H, W, 3)).astype(
            np.float32
        )
    )
    bgs = global_sharded(np.zeros((b,), np.float32))
    state = jax.tree.map(
        lambda x: jax.make_array_from_callback(
            x.shape, rep, lambda idx: np.asarray(x)[idx]
        ),
        state,
    )

    step = jax.jit(
        lambda s, v, p, c, g, bg, it: dp_train_step(
            s, v, p, c, g, bg, it, st, mesh
        )
    )
    new_state, metrics = step(state, views, projs, campos, gts, bgs,
                              jnp.int32(0))
    loss = float(metrics["loss"])  # replicated scalar: fetchable everywhere
    moved = float(
        jnp.max(jnp.abs(new_state.params["xyz"] - state.params["xyz"]))
    )
    assert np.isfinite(loss) and moved > 0.0
    print(f"MULTIHOST_OK pid={pid} loss={loss:.6f}", flush=True)

    # ---- 20-iteration DP trainer loop with a densify in the middle ----
    # The replicated-determinism claim at full loop scope: after 20 DP
    # steps and one adaptive-density rebuild + Morton re-sort (all SPMD on
    # the global mesh), every process must hold BYTE-identical parameters.
    from gsplat_jax.train.density import DensityStatics, get_density_fns

    ds = DensityStatics(
        scene_extent=4.0, uv_grad_threshold=1e-6,
        delete_opacity_threshold=0.02, split_scale_factor=1.6,
        max_gaussians=4000,
    )
    dstep, dsort = get_density_fns(ds)
    # Start from the DP step's own output: its shardings match the cached
    # `step` signature exactly (a TP-step output here would force a full
    # recompile of the DP program, ~3 min on this CPU).
    state_l = new_state
    for it in range(20):
        gts_it = global_sharded(
            np.random.default_rng(100 + it)
            .uniform(0, 1, (b, H, W, 3)).astype(np.float32)
        )
        state_l, metrics = step(state_l, views, projs, campos, gts_it,
                                bgs, jnp.int32(2 + it))
        if it == 9:
            key = jax.random.key(1234)
            state_l, info = dstep(state_l, key)
            assert not bool(info.needs_grow)
            state_l = dsort(state_l)
            print(f"MULTIHOST_DENSIFY pid={pid} "
                  f"total={int(info.new_total)} "
                  f"split={int(info.num_split)} "
                  f"clone={int(info.num_cloned)}", flush=True)
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(state_l.params):
        digest.update(np.ascontiguousarray(
            np.asarray(state_l.params[name])).tobytes())
    digest.update(np.asarray(state_l.alive).tobytes())
    print(f"MULTIHOST_LOOP_OK pid={pid} params_sha={digest.hexdigest()}",
          flush=True)

    # ---- TP step across the process boundary (VERDICT r3 task 7) ----
    # One camera, tile rows sharded over the 4 GLOBAL devices: the
    # backward's gradient psum crosses the process boundary over the
    # jax.distributed transport.
    from gsplat_jax.parallel.tile_parallel import get_tp_train_step

    def replicated(host_np):
        host_np = np.asarray(host_np)
        return jax.make_array_from_callback(
            host_np.shape, rep, lambda idx: host_np[idx]
        )

    tp_step = get_tp_train_step(st, tuple(jax.devices()))
    # Runs LAST: get_tp_train_step donates its state argument, so the
    # loop's final state must be hashed before the TP step consumes it.
    tp_state, tp_metrics = tp_step(
        state_l,
        replicated(cm.view), replicated(cm.proj), replicated(cm.campos),
        replicated(np.random.default_rng(2).uniform(
            0, 1, (H, W, 3)).astype(np.float32)),
        replicated(np.float32(0.0)), jnp.int32(1),
    )
    tp_loss = float(tp_metrics.loss)
    assert np.isfinite(tp_loss)
    print(f"MULTIHOST_TP_OK pid={pid} loss={tp_loss:.6f}", flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
