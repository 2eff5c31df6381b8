"""The 64-bit blind rotation's hand-written CUDA kernel: key layout,
wrapper, count.

Port of `tfhe_tpu/ops/pallas_rotate64.py`. `rotate64` launches
`csrc/blind_rotate64.cu` for CUDA tensors and runs the plain torch version
(`blindrotate64.blind_rotate64`) for CPU tensors; both read the key in
`pack_bsk64`'s layout. Values cross the kernel boundary as int64: residues
are < Q < 2^54, and the Shoup companions are the int64 view of their u64
bits. The kernel's twiddles are `_twiddles`: `ntt.merged_tables` with their
64-bit companions. Up to N = 2048 one block runs a ciphertext, at N = 4096 a
cluster of two blocks (one a polynomial), at N = 8192 a cluster of four
blocks of 512 threads (two a polynomial, each holding half of its
polynomial's words); the note in `csrc/blind_rotate64.cu` gives the
layouts.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, ntt
from .blindrotate64 import blind_rotate64
from .modmath import shoup64, shoup64_tensor

LAUNCHES = 0  # kernel launches made by `rotate64`
# the ring dimensions the kernel takes: one two-half block per ciphertext up
# to 2048, a cluster of two one-polynomial blocks at 4096, of four blocks
# (two a polynomial) at 8192
RING_DIMS = (256, 512, 1024, 2048, 4096, 8192)


def pack_bsk64(bsk_coeff: np.ndarray, Q: int,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """Coefficient-domain key [n, 2(key), d2, 2(out), N] mod Q -> int64
    [n, 4*d2, N] on `device` of Shoup companions only, row
    (key*2 + out)*d2 + 2l + j (digit l of input poly j), points in the NTT's
    bit-reversed order. The layout of `pallas_rotate64.pack_bsk64` (of the
    key's host NTT mod Q) with each companion in one int64 instead of two
    u32 rows. The NTT (`ntt.forward`, exact 64-bit Shoup products) and the
    companions run on `device`, a few rounds at a time: on a card, the host
    does no more than copy the key there."""
    n, _, d2, _, N = bsk_coeff.shape
    out = torch.empty((n, 4 * d2, N), dtype=torch.int64, device=device)
    # rounds a chunk: 2^24 words on a card, 2^17 (in cache) on the CPU,
    # where that halves the time
    chunk = 1 << (24 if torch.device(device).type == "cuda" else 17)
    step = max(1, chunk // (4 * d2 * N))
    for r in range(0, n, step):
        chunk = np.ascontiguousarray(bsk_coeff[r:r + step], dtype=np.uint64)
        b = torch.from_numpy(chunk.view(np.int64)).to(device)
        bh = ntt.forward(b, Q).transpose(2, 3).reshape(-1, 4 * d2, N)
        out[r:r + step] = shoup64_tensor(bh, Q)
    return out


@functools.lru_cache(maxsize=None)
def _twiddles(N: int, Q: int, device: str) -> torch.Tensor:
    """int64 [2, N, 2]: the forward and the inverse row of
    `ntt.merged_tables`, each entry beside its 64-bit Shoup companion (the
    int64 view of its u64 bits), as `csrc/register_ntt64.cuh` reads them."""
    t = ntt.merged_tables(N, Q)
    return torch.from_numpy(np.stack([t, shoup64(t, Q)], axis=-1)).to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("blind_rotate64").tfhe_blind_rotate64
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_ulonglong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def max_active_clusters(N: int) -> int:
    """The most clusters of the ring-N kernel (two blocks at N = 4096, four
    at 8192) that the current CUDA device runs at once
    (cudaOccupancyMaxActiveClusters)."""
    return _build.max_active_clusters("blind_rotate64", N)


def check_params(N: int, d2: int, Q: int, base_g: int) -> None:
    """Raise ValueError unless the kernel takes these parameters."""
    if N not in RING_DIMS:
        raise ValueError(f"the 64-bit kernel takes N in {RING_DIMS}, not {N}")
    if not (d2 >= 2 and d2 % 2 == 0 and Q % 2 == 1 and Q < (1 << 54)
            and 2 * Q * d2 < (1 << 62)):
        raise ValueError("the 64-bit kernel needs an odd Q < 2^54 and "
                         "2Q * d2 < 2^62 (the lazy external-product sum)")
    if base_g & (base_g - 1) or not 2 <= base_g <= (1 << 27) or base_g >> 1 >= Q:
        raise ValueError("the gadget base must be a power of two in "
                         "[2, 2^27] with base/2 < Q")


def rotate64(acc: torch.Tensor, a_idx: torch.Tensor, key: torch.Tensor,
             Q: int, base_g: int, throw: int = 0) -> torch.Tensor:
    """Batched CGGI blind rotation mod Q < 2^54: acc [B, 2, N] int64
    residues, a_idx [B, n] int32 exponents in [0, 2N), key [n, 4*d2, N]
    int64 from `pack_bsk64` -> acc [B, 2, N] int64 after n rounds."""
    if acc.device.type == "cpu":
        return blind_rotate64(acc, a_idx, key, Q, base_g, throw)
    if acc.device.type != "cuda":
        raise ValueError(f"rotate64 runs on cpu or cuda tensors, not {acc.device}")
    B, two, N = acc.shape
    n, rows, Nk = key.shape
    d2 = rows // 4
    for name, t, dtype in (("acc", acc, torch.int64), ("a_idx", a_idx, torch.int32),
                           ("key", key, torch.int64)):
        if t.device != acc.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {acc.device}")
    if two != 2 or Nk != N or rows != 4 * d2 or tuple(a_idx.shape) != (B, n):
        raise ValueError(f"bad shapes acc {tuple(acc.shape)}, a_idx "
                         f"{tuple(a_idx.shape)}, key {tuple(key.shape)}")
    check_params(N, d2, Q, base_g)
    out = torch.empty_like(acc)
    if B == 0:
        return out
    tw = _twiddles(N, Q, str(acc.device))
    with torch.cuda.device(acc.device):
        # 0, 0: the entry point's Barrett arguments, which the kernel no
        # longer reads
        err = _kernel()(
            acc.data_ptr(), out.data_ptr(), a_idx.data_ptr(), key.data_ptr(),
            tw.data_ptr(), B, N, Q, 0, 0, n,
            base_g.bit_length() - 1, d2 // 2, throw,
            torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate64 kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
