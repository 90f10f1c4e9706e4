"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

Runs on an NVIDIA Hopper card (H100) by default; every entry point takes a
``device`` argument and runs on the CPU only when given ``device='cpu'``.
Kernels the JAX package wrote in Pallas for the TPU are CUDA C++ here
(``kernels/csrc``), built at first use. The port imports neither ``jax``
nor ``mmlspark_tpu``, and importing the package itself imports no
``torch``: the stage classes below resolve on first use.
"""

__version__ = "0.1.0"

# The runtime lock witness (MMLSPARK_TPU_LOCKCHECK=1) must wrap
# threading.Lock/RLock before any package module allocates one, so this
# hook runs ahead of every other package import. No-op unless the env
# var is set; analysis.witness imports only the standard library.
from mmlspark_tpu_torch.analysis.witness import install_from_env as _install_lock_witness

_install_lock_witness()

__all__ = [
    "Param",
    "Params",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "Evaluator",
    "Table",
    "clear_compiled_caches",
    "__version__",
]

# name -> module it lives in; resolved by __getattr__ on first use
_LAZY = {
    "Param": "mmlspark_tpu_torch.core.params",
    "Params": "mmlspark_tpu_torch.core.params",
    "PipelineStage": "mmlspark_tpu_torch.core.pipeline",
    "Transformer": "mmlspark_tpu_torch.core.pipeline",
    "Estimator": "mmlspark_tpu_torch.core.pipeline",
    "Model": "mmlspark_tpu_torch.core.pipeline",
    "Pipeline": "mmlspark_tpu_torch.core.pipeline",
    "PipelineModel": "mmlspark_tpu_torch.core.pipeline",
    "Evaluator": "mmlspark_tpu_torch.core.pipeline",
    "Table": "mmlspark_tpu_torch.data.table",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def clear_compiled_caches() -> None:
    """Release the caches the port keeps between calls: its
    ``functools.lru_cache`` tables (histogram launch plans, the boosting
    step's constants, bundle layouts) and, when a card is present, the
    blocks the CUDA caching allocator holds. The counterpart of the JAX
    package's ``clear_compiled_caches``; the port compiles no programs but
    its kernel library, which stays loaded. Safe at any point: every cache
    refills on demand."""
    import functools
    import gc
    import sys

    import torch

    for name, module in list(sys.modules.items()):
        if not name.startswith(__name__ + ".") or module is None:
            continue
        for value in list(vars(module).values()):
            # bounded caches only: the unbounded one holds the kernel library
            if (isinstance(value, functools._lru_cache_wrapper)
                    and value.cache_info().maxsize is not None):
                value.cache_clear()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
