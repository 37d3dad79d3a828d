"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device to run on; ``cuda`` (the default of every entry point)
    raises when no card is present. Only an explicit ``cpu`` runs there.

    On the card this also fixes the port's precision: float32 stays full
    float32 in matrix products and cuDNN convolutions (TF32 off), so the
    served model computes what the parity checks hold to 1e-4."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
