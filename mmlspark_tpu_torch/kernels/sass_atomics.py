"""The atomic instructions each histogram kernel source compiles to.

    python3 -m mmlspark_tpu_torch.kernels.sass_atomics [CSRC_DIR]

Compiles ``histogram.cu``, ``u_histogram.cu`` and ``bin_scatter.cu`` of
``CSRC_DIR`` (default: this package's ``csrc/``) for ``sm_90a`` with nvcc,
disassembles each with ``cuobjdump -sass`` and prints one JSON line per
source: the count of every atomic and reduction opcode (``ATOMS.*`` in
shared memory, ``ATOMG.*``/``REDG.*`` in device memory). An atomicAdd on a
64-bit shared word compiles to a compare-and-swap loop,
``ATOMS.CAST.SPIN.64``; the kernels add 64-bit sums as two uint32 halves
instead (``packed_hist.cuh``), and ``chip_smoke.py`` fails if a loop is
back. Needs the CUDA toolkit (no card); the cubins go to the git-ignored
``kernels/build/sass/``.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from mmlspark_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, CUDA_FLAGS

SOURCES = ("histogram.cu", "u_histogram.cu", "bin_scatter.cu")
_OPCODE = re.compile(r"\b(?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9._]+")
#: The compare-and-swap loop of an atomic the card has no instruction for.
CAS_LOOP = "ATOMS.CAST.SPIN"


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / name)


def atomics(csrc_dir=CSRC_DIR, sources=SOURCES) -> dict:
    """``{source: {opcode: count}}`` of the atomic opcodes in each source's
    SASS for ``sm_90a``."""
    csrc_dir = Path(csrc_dir)
    out_dir = BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubins = {src: out_dir / (Path(src).stem + ".cubin") for src in sources}
    builds = {src: subprocess.Popen([_tool("nvcc"), *CUDA_FLAGS, "-cubin", "-I", str(csrc_dir),
                                     "-o", str(cubin), str(csrc_dir / src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for src, cubin in cubins.items()}  # all compile at once
    logs = {src: proc.communicate()[0] for src, proc in builds.items()}
    counts = {}
    for src, proc in builds.items():
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[src]}")
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubins[src])], check=True,
                              capture_output=True, text=True).stdout
        counts[src] = dict(sorted(collections.Counter(_OPCODE.findall(sass)).items()))
    return counts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for src, ops in atomics(*argv[:1]).items():
        print(json.dumps({"source": src, "atomics": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
