"""Tiny worker for the DEFAULT-SUITE 2-process smoke (test_multihost.py).

Unlike multihost_worker.py (the full DP/TP/densify loop, slow-marked), this
only proves the distributed runtime forms and ONE psum crosses the process
boundary through the product mesh helper (gsplat_jax.parallel.make_mesh):
compile is a few seconds, so the proof runs in every default `pytest -q`.

Usage: python multihost_smoke_worker.py <process_id> <num_processes> <coord>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> int:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from gsplat_jax.parallel import initialize_multihost, make_mesh

    initialize_multihost(coord, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    mesh = make_mesh()  # global "data" mesh spanning both processes
    shd = NamedSharding(mesh, P("data"))
    b = jax.device_count()
    # Each global row i holds the value i; the psum must see ALL rows —
    # including the other process's — on every device.
    host = np.arange(b, dtype=np.float32).reshape(b, 1) * np.ones(
        (b, 8), np.float32
    )
    x = jax.make_array_from_callback(host.shape, shd, lambda idx: host[idx])

    @jax.jit
    def total(v):
        return jax.numpy.sum(v)

    got = float(total(x))
    want = float(host.sum())
    assert got == want, (got, want)
    print(f"SMOKE_OK pid={pid} sum={got}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
