"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

Runs on an NVIDIA Hopper card (H100) by default; every entry point takes a
``device`` argument and runs on the CPU only when given ``device='cpu'``.
Kernels the JAX package wrote in Pallas for the TPU are CUDA C++ here
(``kernels/csrc``), built at first use. The port imports neither ``jax``
nor ``mmlspark_tpu``.
"""

__version__ = "0.1.0"


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
