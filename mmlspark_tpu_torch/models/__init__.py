"""Built-in model zoo: the port's copy of ``mmlspark_tpu/models/``.

Model families are defined here in PyTorch and their weights are made from
a seed, trained, or loaded from a repository through
:mod:`mmlspark_tpu_torch.downloader`. A payload published by either
package loads in the other.
"""

from mmlspark_tpu_torch.models.resnet import ResNet, init_resnet, resnet_apply
from mmlspark_tpu_torch.models.zoo import (
    load_zoo_params,
    params_from_bytes,
    params_to_bytes,
    publish_model,
    train_resnet_classifier,
)

__all__ = [
    "ResNet", "init_resnet", "resnet_apply", "publish_model", "load_zoo_params",
    "params_to_bytes", "params_from_bytes", "train_resnet_classifier",
]
