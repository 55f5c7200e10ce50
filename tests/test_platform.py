"""Device and compile-cache choices shared by the entry points."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsplat_jax.utils import platform

REPO = Path(__file__).resolve().parents[1]


def test_kernels_refuse_to_compile_off_the_gpu():
    # No silent emulation: without interpret=True the Pallas rasterizer
    # only compiles for the GPU, and the CPU backend is an error.
    from gsplat_jax.ops.render import _check_device

    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="interpret=True"):
        _check_device("kernel", interpret=False)
    _check_device("kernel", interpret=True)
    _check_device("reference", interpret=False)
    with pytest.raises(ValueError):
        _check_device("bogus", interpret=False)
    # The CPU was asked for explicitly here, so the kernels interpret.
    assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert platform.kernel_interpret() is True


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != platform.CACHE_ENV}
    if env_value is not None:
        env[platform.CACHE_ENV] = env_value
    code = ("from gsplat_jax.utils.platform import enable_compile_cache;"
            "import jax; d = enable_compile_cache();"
            "assert jax.config.jax_compilation_cache_dir == d; print(d)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_compile_cache_dir(tmp_path):
    assert _cache_dir(None) == str(REPO / ".jax_cache")
    assert _cache_dir(str(tmp_path)) == str(tmp_path)


def test_reference_rasterizer_is_explicit_only():
    # impl="reference" runs the plain XLA rasterizer; it must equal the
    # interpret-mode kernel on a small scene.
    from gsplat_jax.ops.binning import build_tile_tables
    from gsplat_jax.ops.render import pack_attrs, rasterize
    from test_render import TILE, _make_scene

    rng = np.random.default_rng(3)
    uv, conic, radius, z, opa, rgb = _make_scene(rng, 40, 64, 32)
    args = [jnp.asarray(x) for x in (uv, conic, rgb, opa)]
    tables = build_tile_tables(
        jnp.asarray(uv), jnp.asarray(z), jnp.asarray(radius),
        jnp.ones(40, bool), attrs=pack_attrs(*args), num_tiles_x=4,
        num_tiles_y=2, tile_size=TILE, pair_cap=2048,
    )
    kw = dict(width=64, height=32, tile=TILE, chunk=8)
    a = rasterize(*args, tables, 0.3, interpret=True, **kw)
    b = rasterize(*args, tables, 0.3, impl="reference", **kw)
    np.testing.assert_allclose(np.asarray(a.image), np.asarray(b.image),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.n_splats),
                                  np.asarray(b.n_splats))
