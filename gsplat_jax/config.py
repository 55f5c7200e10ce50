"""Training configuration.

Mirrors the reference YAML schema exactly (all 40 keys of
include/gsplat/utils.hpp:10-70, parsed by
src/utils.cpp:16-86): every key is required and a missing key
raises, matching ``parseConfig``'s throw-on-missing behavior.

Fields that the reference parses but never reads (see SURVEY.md §5 "dead
config fields") are kept for schema parity and documented below; a few have
optional live extensions gated by ``strict_reference`` so default behavior is
bit-identical to the reference trainer:

- ``initial_opacity`` / ``initial_scale_num_neighbors`` /
  ``initial_scale_factor`` / ``max_initial_scale``: the reference hardcodes
  opacity=0.2, 3 neighbors, no factor/clamp (gaussian.cpp:71,95).  We honor
  them in :mod:`gsplat_jax.train.init` only when ``strict_reference=False``.
- ``use_sh_precompute``: reference always precomputes per-Gaussian SH color
  (raster.cu:78); same here.
- ``use_split`` / ``use_clone`` / ``use_delete``: dead in the reference;
  honored when ``strict_reference=False``.
- ``test_eval_interval``: reference hardcodes eval every 3000 iters
  (trainer.cu:1388); honored when ``strict_reference=False``.
- ``use_background_end``: reference cycles the background forever
  (trainer.cu:1342-1343); honored when ``strict_reference=False``.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class ConfigParameters:
    # File paths and directories
    dataset_path: str
    output_dir: str

    # General settings
    downsample_factor: int
    print_interval: int
    num_iters: int
    ssim_frac: float
    test_eval_interval: int
    test_split_ratio: int

    # Initial Gaussian properties
    initial_opacity: float
    initial_scale_num_neighbors: int
    initial_scale_factor: float
    max_initial_scale: float

    # Rendering thresholds
    near_thresh: float
    mh_dist: float
    cull_mask_padding: int

    # Learning rates
    base_lr: float
    xyz_lr_multiplier_init: float
    xyz_lr_multiplier_final: float
    quat_lr_multiplier: float
    scale_lr_multiplier: float
    opacity_lr_multiplier: float
    rgb_lr_multiplier: float
    sh_lr_multiplier: float

    # Background settings
    use_background: bool
    use_background_end: int

    # Opacity reset settings
    reset_opacity_interval: int
    reset_opacity_value: float
    reset_opacity_start: int
    reset_opacity_end: int

    # Spherical Harmonics settings
    use_sh_precompute: bool
    max_sh_band: int
    add_sh_band_interval: int

    # Densification control
    use_split: bool
    use_clone: bool
    use_delete: bool
    adaptive_control_start: int
    adaptive_control_end: int
    adaptive_control_interval: int
    max_gaussians: int
    delete_opacity_threshold: float
    uv_grad_threshold: float
    split_scale_factor: float

    # --- Extensions (not in the reference schema; all optional) ---
    # When True (default), scheduling matches the reference binary exactly,
    # including its dead config fields. When False, the dead fields above
    # become live.
    strict_reference: bool = True
    # Rasterizer tile size in pixels (reference: 16, render.cu:8).
    tile_size: int = 16
    # Splats per chunk of the rasterizer's walk over a tile's splat range
    # (the backward's (256, K) block). 16 measured fastest on the H100 at
    # 1M Gaussians: 17.9 ms/step against 18.5 at 32, 59 at 64.
    chunk_size: int = 16
    # Initial capacity of the (gaussian, tile) pair stream; grows on overflow.
    pair_cap: int = 0  # 0 = auto
    # Data-parallel batch: cameras per optimizer step (reference: 1).
    cameras_per_step: int = 1
    # RNG seed for image sampling + split sampling.
    seed: int = 0

    def __post_init__(self) -> None:
        if self.tile_size % 4 != 0:
            raise ValueError("tile_size must be a multiple of 4")


_REQUIRED_KEYS = [
    f.name
    for f in dataclasses.fields(ConfigParameters)
    if f.default is dataclasses.MISSING
]

_TYPES = {f.name: f.type for f in dataclasses.fields(ConfigParameters)}


def parse_config(filename: str | Path) -> ConfigParameters:
    """Parse a YAML config; every reference key is required.

    Raises ``FileNotFoundError`` on a missing file and ``KeyError`` naming the
    first missing required key (utils.cpp:9-14 semantics).
    """
    path = Path(filename)
    if not path.is_file():
        raise FileNotFoundError(f"Config file not found: {path}")
    raw = parse_flat_yaml(path.read_text())
    kwargs: dict[str, Any] = {}
    for key in _REQUIRED_KEYS:
        if key not in raw:
            raise KeyError(f"Missing required parameter in YAML file: {key}")
    for key, value in raw.items():
        if key in _TYPES:
            kwargs[key] = _coerce(key, value)
    return ConfigParameters(**kwargs)


# YAML 1.1 plain-scalar resolution (the subset PyYAML's safe loader applies
# to the flat configs): note ``1e-3`` (no dot) stays a string there.
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
)
_SPECIAL = re.compile(r"[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text.lower() in _BOOL and text in (
        text.lower(), text.capitalize(), text.upper()
    ):
        return _BOOL[text.lower()]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _SPECIAL.fullmatch(text):
        return float(text.lower().replace(".", ""))
    return text


def parse_flat_yaml(text: str) -> dict[str, Any]:
    """The flat ``key: value`` YAML of the config files, without PyYAML.

    One mapping of plain or quoted scalars, ``#`` comments and blank
    lines; gives the values ``yaml.safe_load`` gives for such files
    (YAML 1.1's octal, hex and base-60 integers stay strings)."""
    out: dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), 1):
        body = re.sub(r"(^|\s)#.*$", "", line).strip()
        if not body or body == "---":
            continue
        key, sep, value = body.partition(":")
        if not sep or not key or key != key.strip() or line[0].isspace():
            raise ValueError(f"line {n}: expected 'key: value', got {line!r}")
        out[key] = _scalar(value.strip())
    return out


def _coerce(key: str, value: Any) -> Any:
    """Coerce YAML scalars to the annotated field type.

    YAML 1.1 parses ``1e-3`` (no dot) as a string; the reference's
    yaml-cpp ``as<float>()`` accepts it, so we coerce here.
    """
    t = str(_TYPES[key])
    if t == "float" and not isinstance(value, float):
        return float(value)
    if t == "int" and not isinstance(value, int):
        return int(value)
    if t == "bool" and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes", "on")
    return value
