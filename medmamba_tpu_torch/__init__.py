"""medmamba_tpu_torch: the PyTorch + CUDA port of medmamba_tpu for NVIDIA Hopper.

Imports torch and numpy only: nothing of JAX and nothing of ``medmamba_tpu``.
"""

__version__ = "0.1.0"

from medmamba_tpu_torch.models.registry import (  # noqa: F401
    MODEL_CONFIGS, create_model, medmamba_b, medmamba_s, medmamba_t,
    medmamba_te)
from medmamba_tpu_torch.models.vssm import VSSM  # noqa: F401
from medmamba_tpu_torch.ops.selective_scan import selective_scan  # noqa: F401
