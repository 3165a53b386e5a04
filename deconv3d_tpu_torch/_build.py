"""Build the CUDA sources under ``csrc/`` at first use and load them.

``nvcc`` compiles each ``csrc/*.cu`` into a shared library of its own with
a plain C interface (no PyTorch headers: a build takes seconds, not
minutes); the compilers of all sources run at once, which takes 56% of the
time of one ``nvcc`` over all sources (10 s against 18 s on the 8-core
host of an H100 80GB HBM3, two sources).  The libraries go
under ``build/deconv3d_tpu_torch/`` in the checkout, and ``ctypes`` loads
them.  Every pointer and the stream cross as ``c_void_p``.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
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
#: wall seconds the last build took (0.0 when every library was built)
build_seconds = 0.0
#: compiler output of the last build (ptxas register / shared-memory report)
build_log = ""


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


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
#: (argtypes, restype) of every C function the sources export
_SIGNATURES = {
    "mh_sweep_launch": ([_P] * 15 + [_I] * 7 + [_U, _F, _F, _P], _I),
    "mh_sweep_scratch_floats": ([_I] * 4, ctypes.c_longlong),
    "gibbs_sweep_launch": ([_P] * 16 + [_I] * 7 + [_U, _P], _I),
    "gibbs_sweep_scratch_floats": ([_I] * 4, ctypes.c_longlong),
    "tiled_mh_launch": ([_P] * 15 + [_I] * 9 + [_U, _F, _F, _P], _I),
    "tiled_gibbs_launch": ([_P] * 16 + [_I] * 9 + [_U, _P], _I),
}


def load_library():
    """The compiled kernels (built on first call, then cached): one
    namespace holding every exported C function of every source."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        headers = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for hdr in sorted(CSRC.glob("*.cuh")):
            headers.update(hdr.name.encode())
            headers.update(hdr.read_bytes())
        outs = {}
        for src in sorted(CSRC.glob("*.cu")):
            digest = headers.copy()
            digest.update(src.read_bytes())
            outs[src] = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
        todo = {src: out for src, out in outs.items() if not out.is_file()}
        build_seconds, build_log = 0.0, ""
        if todo:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            procs = {}
            for src, out in todo.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(src)]
                procs[src] = (cmd, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for src, (cmd, tmp, proc) in procs.items():
                log = proc.communicate()[0]
                build_log += log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{log}")
                else:
                    os.replace(tmp, todo[src])
            build_seconds = time.perf_counter() - t0
            if failed:
                raise RuntimeError("\n".join(failed))
        ns = types.SimpleNamespace()
        for out in outs.values():
            lib = ctypes.CDLL(str(out))
            for name, (argtypes, restype) in _SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                    setattr(ns, name, fn)
        _lib = ns
        return ns
