"""Build and load the hand-written CUDA kernels.

``csrc/mpm_kernels.cu`` exposes a plain C interface, so it is compiled by
``nvcc`` alone into a shared library (no PyTorch headers: seconds, not
minutes) and loaded with ``ctypes``.  The build runs at first use, writes
``drake_tpu_torch/_build/mpm_kernels_<hash>.so`` and is redone whenever the
hash of the source changes.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "mpm_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (pointers and the stream as void*, see the .cu).
SIGNATURES = {
    "mpm_update_grid": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "mpm_update_grid_blocks": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P, _P),
    "mpm_empty": (_I, _I, _P),
    "mpm_p2g_block": (_P, _I, _I, _P, _P, _I, _I, _P, _P),
    "mpm_g2p_block": (_P, _I, _I, _P, _P, _P, _I, _I, _F, _F, _P, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"mpm_kernels_{digest}.so"


def build() -> Path:
    """Compile the kernels unless a library for this source already exists.
    The compiler's output (ptxas resource usage) is kept beside the library
    as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
