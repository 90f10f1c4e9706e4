"""Build the port's CUDA kernels from the sources in this package.

The kernels are compiled at first use with ``torch.utils.cpp_extension.load``
for Hopper (``sm_90a``) into ``mmlspark_tpu_torch/kernels/build/``, which is
not under version control. Nothing outside the checkout is read or written.
A failed build raises; no caller falls back to another implementation.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: nvcc flags: Hopper's architecture-specific target (wgmma and setmaxnreg
#: exist only there), full optimisation.
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17")


@functools.cache
def histogram_extension():
    """The compiled histogram kernels (``histogram.cu``, ``u_histogram.cu``,
    ``bin_scatter.cu``) and their pybind11 binding, one module from one
    ``load``. Built once per process; the build directory keeps the objects,
    so a second process with unchanged sources reuses them."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ext = load(
        name="mmlspark_tpu_torch_histogram",
        sources=[
            str(CSRC_DIR / "histogram.cu"),
            str(CSRC_DIR / "u_histogram.cu"),
            str(CSRC_DIR / "bin_scatter.cu"),
            str(CSRC_DIR / "histogram_binding.cpp"),
        ],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O3", "-std=c++17"],
        extra_cuda_cflags=list(CUDA_FLAGS),
        extra_include_paths=[str(CSRC_DIR)],
        verbose=False,
    )
    histogram_extension.build_seconds = time.perf_counter() - t0
    return ext
