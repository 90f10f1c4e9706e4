"""Pre-trained model downloader: the port's copy of ``mmlspark_tpu/downloader/``."""

from mmlspark_tpu_torch.downloader.repository import (
    FaultToleranceUtils,
    LocalRepo,
    ModelDownloader,
    ModelSchema,
    RemoteRepo,
    Repository,
)

__all__ = [
    "FaultToleranceUtils",
    "LocalRepo",
    "ModelDownloader",
    "ModelSchema",
    "RemoteRepo",
    "Repository",
]
