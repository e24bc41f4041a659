"""Device selection for the port's entry points.

Entry points run on the card by default.  The CPU runs the kernels' plain
PyTorch versions and is used only when the caller asks for it, as the
tests do; a CUDA request without a card raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
