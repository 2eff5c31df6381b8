"""Build and load the hand-written CUDA kernels.

`nvcc` compiles `tfhe_tpu_torch/csrc/<name>.cu` for sm_90a into a shared
library with a plain C interface, which `ctypes` loads: no PyTorch headers,
so a build takes seconds. Libraries go to `tfhe_tpu_torch/_build/`, named by
a hash of their source and of the headers in `csrc/`, and are built at first
use only; `build` starts one nvcc per source, all at once.
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
KERNELS = ("blind_rotate", "blind_rotate_rns", "blind_rotate64")

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


def _lib_path(name: str) -> str:
    """Where the library of csrc/<name>.cu goes: named by a hash of the
    source and of every header in csrc/, which a source may include."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        h.update(fname.encode() + b"\0")
        with open(os.path.join(_CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> None:
    """Compile each library of `names` that is not built yet, one nvcc
    process per source, all started together. The compiler's output
    (register and shared-memory use, from -Xptxas -v) is kept in
    LOGS[name]. Raises if any build fails."""
    with _lock:
        procs = {}
        for name in names:
            lib_path = _lib_path(name)
            if os.path.exists(lib_path):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib_path)
        failed = []
        for name, (proc, tmp, lib_path) in procs.items():
            LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu:\n{LOGS[name]}")
            else:
                os.replace(tmp, lib_path)
        if failed:
            raise RuntimeError("\n".join(failed))


def ptxas_report(name: str) -> list[str]:
    """What ptxas said of each kernel in the last build of csrc/<name>.cu:
    the line naming the function, then its stack and spill line and its
    register line."""
    keep = ("Function properties for", "spill", "registers")
    return [ln.strip() for ln in LOGS.get(name, "").splitlines()
            if any(k in ln for k in keep)]


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it if needed."""
    if name not in _libs:
        build((name,))
        with _lock:
            _libs.setdefault(name, ctypes.CDLL(_lib_path(name)))
    return _libs[name]


def max_active_clusters(name: str, N: int) -> int:
    """The most clusters of csrc/<name>.cu's ring-N cluster kernel (N = 8192
    for blind_rotate, 4096 and 8192 for blind_rotate64, 4096, 8192 and 16384
    for blind_rotate_rns) that the current CUDA device runs at once: the
    library's `tfhe_<name>_clusters` (cudaOccupancyMaxActiveClusters)."""
    fn = getattr(load(name), f"tfhe_{name}_clusters")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(N, ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed on {name} at N = {N}: "
                           f"cudaError {err}")
    return out.value
