"""CLI integration test: synthetic COLMAP dataset -> cli.main -> PLY.

Exercises the whole reference entry path (main.cpp:10-98 parity): YAML
config parse, the three COLMAP binary readers, Gaussian init from SfM
points, trainer with split/schedules, and the PLY export — end to end on a
generated on-disk dataset (gsplat_jax.tools.synthetic).
"""

import subprocess
import sys
from pathlib import Path

from gsplat_jax import cli
from gsplat_jax.config import parse_config, parse_flat_yaml
from gsplat_jax.io.ply import load_ply
from gsplat_jax.tools.synthetic import write_synthetic_dataset


def _write_config(path, dataset_name, out_dir, num_iters):
    base = parse_flat_yaml(open("configs/base.yaml").read())
    base.update(
        dataset_path=dataset_name,
        downsample_factor=1,
        output_dir=str(out_dir),
        num_iters=num_iters,
        print_interval=10**9,
        test_eval_interval=10**9,
        test_split_ratio=4,
        adaptive_control_start=4,
        adaptive_control_interval=6,
        adaptive_control_end=num_iters - 2,
        reset_opacity_start=10**9,
        reset_opacity_end=10**9,
        # max_sh_band=0: SH-band growth would recompile every jitted
        # program at l_max=1 — covered by test_multichip's trainer loop;
        # the CLI path's job here is argv->load->train->PLY.
        max_sh_band=0,
        add_sh_band_interval=10,
        max_gaussians=5000,
        use_background=False,
        strict_reference=False,
    )
    with open(path, "w") as f:
        f.writelines(f"{k}: {v}\n" for k, v in base.items())


# All CLI tests share one dataset geometry (views/size/counts): identical
# camera intrinsics + scene extent mean identical StepStatics, so the jitted
# train/render/density programs compile ONCE per pytest process (interpret-
# mode pallas compiles dominate suite wall-clock).
REPO = Path(__file__).resolve().parents[1]
DATASET = dict(
    name="scene", n_views=3, width=48, height=32, n_gaussians=60, n_points=80
)


def test_cli_end_to_end(tmp_path):
    write_synthetic_dataset(tmp_path, **DATASET)
    cfg_path = tmp_path / "config.yaml"
    out_dir = tmp_path / "out"
    _write_config(cfg_path, "scene", out_dir, num_iters=10)

    rc = cli.main([str(cfg_path), str(tmp_path)])
    assert rc == 0

    ply = out_dir / "trained.ply"
    assert ply.is_file()
    data = load_ply(ply)
    assert data["xyz"].shape[1] == 3
    assert data["xyz"].shape[0] > 0

    # The config round-trips through the strict parser too.
    cfg = parse_config(cfg_path)
    assert cfg.num_iters == 10


def test_cli_needs_neither_yaml_nor_pil(tmp_path):
    """The CLI on a synthetic scene (PPM images, the flat config parser)
    runs with PyYAML and Pillow unimportable."""
    code = f"""
import sys
sys.modules["yaml"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {str(Path(__file__).parent)!r})
from test_cli import DATASET, _write_config, cli, write_synthetic_dataset
root = {str(tmp_path)!r}
write_synthetic_dataset(root, **DATASET)
_write_config(root + "/c.yaml", "scene", root + "/out", num_iters=10)
assert cli.main([root + "/c.yaml", root, "--max-iters", "2"]) == 0
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "out" / "trained.ply").is_file()


def test_cli_resume(tmp_path):
    """Interrupt training with --max-iters, then resume from the saved
    checkpoint under the SAME config (shares every jitted program with
    test_cli_end_to_end). Both legs are SHORT (4 + 2 iters via
    --max-iters): the covered surface is the flag parsing, checkpoint
    write/load, and resumed continuation — not another full loop."""
    write_synthetic_dataset(tmp_path, **DATASET)
    cfg_path = tmp_path / "config.yaml"
    out_dir = tmp_path / "out"
    _write_config(cfg_path, "scene", out_dir, num_iters=10)
    assert cli.main([str(cfg_path), str(tmp_path), "--max-iters", "4"]) == 0
    ck = out_dir / "checkpoint.npz"
    assert ck.is_file()
    from gsplat_jax.utils.checkpoint import load_checkpoint

    assert load_checkpoint(ck).iteration == 4
    assert cli.main([str(cfg_path), str(tmp_path), "--resume", str(ck),
                     "--max-iters", "6"]) == 0
    final = load_checkpoint(ck)
    assert final.iteration == 6  # resumed at 4 and continued
    assert final.pair_cap > 0 and final.config_hash


def test_cli_flag_validation_errors(capsys):
    """Malformed flags print usage and return 1 instead of raising
    (review finding: --dp with a missing/non-integer value crashed)."""
    assert cli.main(["cfg.yaml", "root", "--dp"]) == 1
    assert "--dp needs a value" in capsys.readouterr().err
    assert cli.main(["--dp", "cfg.yaml", "root"]) == 1
    assert "non-int" in capsys.readouterr().err
    assert cli.main(["--max-iters"]) == 1
    assert cli.main(["cfg.yaml"]) == 1  # too few positionals
    assert "Usage:" in capsys.readouterr().err
