"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None):
    """The card unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and absent: the
    port never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU"
        )
    return dev
