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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
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
    "mh_sweep_launch": ([_P] * 15 + [_I] * 10 + [_U, _F, _F, _P], _I),
    "mh_sweep_scratch_floats": ([_I, ctypes.c_longlong], ctypes.c_longlong),
    "gibbs_sweep_launch": ([_P] * 16 + [_I] * 11 + [_U, _P], _I),
    "gibbs_sweep_scratch_floats": ([_I, ctypes.c_longlong, _I],
                                   ctypes.c_longlong),
    "trunc_normal_launch": ([_P] * 4 + [_I, _P], _I),
    "tiled_mh_launch": ([_P] * 17 + [_I] * 17 + [_U, _F, _F, _P], _I),
    "tiled_gibbs_launch": ([_P] * 18 + [_I] * 18 + [_U, _P], _I),
    "task_phase_clocks": ([_P], _I),
    "resident_mh_launch": ([_P] * 15 + [_I] * 9 + [_U, _F, _F, _P], _I),
    "resident_mh_scratch_floats": ([_I] * 5, ctypes.c_longlong),
    "resident_gibbs_launch": ([_P] * 16 + [_I] * 9 + [_U, _P], _I),
    "resident_gibbs_scratch_floats": ([_I] * 5, ctypes.c_longlong),
    "resident_smem_bytes": ([_I] * 9, ctypes.c_longlong),
    "resident_barrier_launch": ([_I, _I, ctypes.c_longlong, _I, _P], _I),
    "resident_phase_clocks": ([_P], _I),
    "banded_cholesky_launch": ([_P, _P, _I, _I, _I, _F, _P], _I),
    "banded_sample_launch": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "banded_solve_launch": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "banded_segments": ([_I] * 4, _I),
    "chi2_scan_launch": ([_P] * 6 + [_I] * 2 + [_P], _I),
}


def _build_and_load(sources, flags, tag=""):
    """Compile each of ``sources`` (one ``nvcc`` each, all at once) with
    ``flags`` unless a library of the same content is built already, and
    load them: (namespace of their exported C functions, build seconds,
    compiler output)."""
    headers = hashlib.sha256(" ".join(flags).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        headers.update(hdr.name.encode())
        headers.update(hdr.read_bytes())
    outs = {}
    for src in sources:
        digest = headers.copy()
        digest.update(src.read_bytes())
        outs[src] = BUILD_DIR / f"lib{src.stem}{tag}_{digest.hexdigest()[:16]}.so"
    todo = {src: out for src, out in outs.items() if not out.is_file()}
    seconds, log_all = 0.0, ""
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs[src] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for src, (cmd, tmp, proc) in procs.items():
            log = proc.communicate()[0]
            log_all += log
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, todo[src])
        seconds = time.perf_counter() - t0
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
    return ns, seconds, log_all


def load_library():
    """The compiled kernels (built on first call, then cached): one
    namespace holding every exported C function of every source."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            _lib, build_seconds, build_log = _build_and_load(
                sorted(CSRC.glob("*.cu")), NVCC_FLAGS)
        return _lib


def load_variant(stem: str, *defines: str):
    """``csrc/<stem>.cu`` built on its own with ``-D`` ``defines`` (a
    measurement build, e.g. ``resident_sweep`` with
    ``RESIDENT_PHASE_CLOCKS``): the namespace of its C functions."""
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    tag = "".join(f"_{d.lower()}" for d in defines)
    return _build_and_load([CSRC / f"{stem}.cu"], flags, tag)[0]
