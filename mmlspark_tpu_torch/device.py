"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument. Left out (``None``), it means
the CUDA card; ``"cpu"`` must be asked for by name. Without a card the
default raises instead of moving the work to the CPU, so a run never
reports CPU numbers under a device's name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: CUDA unless the caller
    names another device. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmlspark_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

