"""Build the CUDA sources under ``csrc/`` at first use and load them.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes), written
under ``build/deconv3d_tpu_torch/`` in the checkout, and ``ctypes`` loads
it.  Every pointer and the stream cross as ``c_void_p``.  A missing ``nvcc``
or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "deconv3d_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: toolkit roots searched for bin/nvcc after $CUDA_HOME (then PATH)
CUDA_ROOTS = ("/usr/local/cuda",)

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: compiler output of the last build (ptxas register / shared-memory report)
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``CUDA_ROOTS``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found ($CUDA_HOME, {', '.join(CUDA_ROOTS)}, PATH): the CUDA "
            "kernels of deconv3d_tpu_torch cannot be built"
        )
    return found


def _declare(lib) -> None:
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.mh_sweep_launch.argtypes = (
        [p] * 14 + [i] * 6 + [u] * 3 + [f] * 2 + [p]
    )
    lib.mh_sweep_launch.restype = i
    lib.mh_sweep_scratch_floats.argtypes = [i, i, i]
    lib.mh_sweep_scratch_floats.restype = ctypes.c_longlong


def load_library():
    """The compiled kernel library (built on first call, then cached)."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for src in _sources():
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libdeconv3d_kernels_{digest.hexdigest()[:16]}.so"
        if not out.is_file():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{build_log}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib
