"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

Runs on an NVIDIA Hopper card (H100) by default; every entry point takes a
``device`` argument and runs on the CPU only when given ``device='cpu'``.
Kernels the JAX package wrote in Pallas for the TPU are CUDA C++ here
(``kernels/csrc``), built at first use. The port imports neither ``jax``
nor ``mmlspark_tpu``.
"""

__version__ = "0.1.0"
