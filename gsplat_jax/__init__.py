"""gsplat_jax — a JAX 3D Gaussian Splatting trainer and renderer.

Built from scratch in JAX/Pallas with the full capabilities of the reference
CUDA implementation (AndrewBoessen/3DGS); see SURVEY.md for the component map
and file:line parity citations throughout the source.
"""

from .config import ConfigParameters, parse_config  # noqa: F401
from .train.init import GaussianData, initialize_gaussians  # noqa: F401

__version__ = "0.1.0"
