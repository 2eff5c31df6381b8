"""Native C++ host math core (ctypes binding, compiled on first import).

The reference's CPU layer is C++ (`src/core/lib/math`); this module is its
counterpart here: an OpenMP Shoup NTT engine shared by the host oracle, key
generation, and device-key setup. `ref/ntt.py` routes through it when
available and falls back to pure numpy where it cannot be built.

Compilation is `g++ -O3 -march=native -fopenmp -shared -fPIC`, cached as
`tfhe_tpu_torch/_build/_hostmath.so` (git-ignored) with an mtime check — no build-system
dependency, matching the zero-install constraint of the environment.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostmath.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "_hostmath.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"  # concurrent first builds do not collide
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, _LIB)
            return True
        except (subprocess.SubprocessError, OSError):
            return False


def get_lib():
    """The loaded library, or None when unavailable/disabled."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            fresh = (os.path.exists(_LIB)
                     and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC))
            if not fresh and not _build():
                return None
            lib = ctypes.CDLL(_LIB)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.tfhe_ntt_forward.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_uint64, ctypes.c_uint64]
            lib.tfhe_ntt_inverse.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_uint64, ctypes.c_uint64]
            lib.tfhe_pointwise_mulmod.argtypes = [u64p, u64p, ctypes.c_int64,
                                                  ctypes.c_uint64]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.tfhe_cggi_rotate.argtypes = [
                u64p, i64p, u64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.tfhe_hostmath_version.restype = ctypes.c_int
            if lib.tfhe_hostmath_version() != 1:
                return None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def cggi_rotate(acc, a_scaled, bsk_hat, Q: int, psi: int, g_bits: int,
                digits_eff: int, throw: int):
    """In-place batched CGGI blind rotation on the host (C++ OpenMP).
    acc [B,2,N] u64 coeff-domain, a_scaled [B,n] i64 in [0,2N),
    bsk_hat [n,2,d2,2,N] u64 eval-domain. Returns True when native ran."""
    import ctypes as ct

    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    acc = np.ascontiguousarray(acc)
    a_scaled = np.ascontiguousarray(a_scaled, dtype=np.int64)
    bsk_hat = np.ascontiguousarray(bsk_hat)
    B, _, N = acc.shape
    n = a_scaled.shape[1]
    lib.tfhe_cggi_rotate(
        acc.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        a_scaled.ctypes.data_as(ct.POINTER(ct.c_int64)),
        bsk_hat.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        B, n, N, Q, psi, g_bits, digits_eff, throw)
    return True


def ntt_batch(x, Q: int, psi: int, inverse: bool):
    """In-place batched negacyclic NTT on a contiguous uint64 [..., N] array.
    Returns True when the native path ran."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    x = np.ascontiguousarray(x)
    N = x.shape[-1]
    batch = x.size // N
    ptr = x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    if inverse:
        lib.tfhe_ntt_inverse(ptr, batch, N, Q, psi)
    else:
        lib.tfhe_ntt_forward(ptr, batch, N, Q, psi)
    return True
