"""Build and load the hand-written CUDA kernels.

`nvcc` compiles `tfhe_tpu_torch/csrc/<name>.cu` for sm_90a into a shared
library with a plain C interface, which `ctypes` loads: no PyTorch headers,
so a build takes seconds. Libraries go to `tfhe_tpu_torch/_build/`, named by
a hash of their source, and are built at first use only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it if needed.
    The compiler's output (register and shared-memory use, from
    -Xptxas -v) is kept in LOGS[name] when this call built it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(_CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        lib_path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
            LOGS[name] = proc.stdout + proc.stderr
        _libs[name] = ctypes.CDLL(lib_path)
        return _libs[name]
