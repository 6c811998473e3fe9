"""Device selection for the port's entry points.

Every entry point (``GRMAPPOPolicy``, ``Runner``, ``envs.env.reset``) runs on
the card unless the caller names another device.  There is no silent move to
the CPU: asking for the card on a machine without one raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
