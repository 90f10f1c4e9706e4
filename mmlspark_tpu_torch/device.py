"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument. Left out (``None``), it means
the CUDA card; ``"cpu"`` must be asked for by name. Without a card the
default raises instead of moving the work to the CPU, so a run never
reports CPU numbers under a device's name.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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



@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Float32 convolutions and matmuls in full float32 for the block's
    duration: cuDNN's TF32 (on by PyTorch's default) and cuBLAS's TF32 off,
    the previous settings restored after. The deep models' float32 paths
    run under it, so the card holds the reference's float32 arithmetic
    without a process-wide switch."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
