"""Device choice for the port's entry points.

Entry points (``DMatrix``, ``Booster``, ``train``) run on the CUDA card
unless the caller asks for the CPU with ``device="cpu"``. A request for the
card on a machine without one raises: the port never continues on the CPU
behind the caller's back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card (``cuda``). Only ``cuda`` and ``cpu`` are
    accepted; ``cuda`` without an available device raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
