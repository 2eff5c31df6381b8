"""The RNS blind rotation's hand-written CUDA kernel: key layout, wrapper,
count.

Port of `tfhe_tpu/ops/pallas_rotate_rns.py`. `rotate_rns` launches
`csrc/blind_rotate_rns.cu` for CUDA tensors and runs the plain torch version
(`blindrotate_rns.blind_rotate_rns`) for CPU tensors; both read the key in
`pack_bsk_rns`'s layout. Values cross the kernel boundary as int32: lane
residues are < 2^28, and the Shoup companions are the int32 view of their
u32 bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .blindrotate_rns import blind_rotate_rns
from .ntt import forward, merged_tables
from .rotate_kernel import _with_shoup

LAUNCHES = 0  # kernel launches made by `rotate_rns`
# the ring dimensions the kernel takes: one two-lane block per ciphertext up
# to 2048, a cluster of two one-lane blocks at 4096, of four blocks (two a
# lane) at 8192, of eight (four a lane) at 16384
RING_DIMS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def pack_bsk_rns(bsk_coeff: np.ndarray, q1: int, q2: int,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """Coefficient-domain key [n, 2(key), d2, 2(out), N] mod Q = q1*q2 ->
    int32 [n, 8*d2, N] on `device` of per-lane Shoup companions only: lane
    q1's rows, then lane q2's, row (key*2 + out)*d2 + 2*digit + j within a
    lane, points in the NTT's bit-reversed order. The layout of
    `pallas_rotate_rns.pack_bsk_rns`; each lane takes its own NTT of the
    key, so no NTT mod the full Q is needed. The arithmetic runs on
    `device` in int64 (values < Q < 2^54, residues < 2^28), a few rounds at
    a time: on a card, the host does no more than copy the key there."""
    n, _, d2, _, N = bsk_coeff.shape
    out = torch.empty((n, 8 * d2, N), dtype=torch.int32, device=device)
    # rounds a chunk: 2^24 words on a card, 2^17 (in cache) on the CPU
    chunk = 1 << (24 if torch.device(device).type == "cuda" else 17)
    step = max(1, chunk // (4 * d2 * N))
    for r in range(0, n, step):
        chunk = np.ascontiguousarray(bsk_coeff[r:r + step], dtype=np.uint64)
        b = torch.from_numpy(chunk.view(np.int64)).to(device)
        for lane, qi in enumerate((q1, q2)):
            bh = forward(b % qi, qi).transpose(2, 3).reshape(-1, 4 * d2, N)
            sh = (bh << 32) // qi                          # the u32 companion
            out[r:r + step, lane * 4 * d2:(lane + 1) * 4 * d2] = torch.where(
                sh >= 1 << 31, sh - (1 << 32), sh).to(torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def _twiddles(N: int, q1: int, q2: int, device: str) -> torch.Tensor:
    """int32 [2, 4, N]: per lane, the rows forward, forward', inverse,
    inverse' of `merged_tables` (x' = Shoup companion, the int32 view of
    its u32 bits)."""
    lanes = [_with_shoup(torch.from_numpy(merged_tables(N, qi)), qi).reshape(4, N)
             for qi in (q1, q2)]
    return torch.stack(lanes).contiguous().to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("blind_rotate_rns").tfhe_blind_rotate_rns
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_uint] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def max_active_clusters(N: int) -> int:
    """The most clusters of the ring-N kernel (two blocks at N = 4096, four
    at 8192, eight at 16384) that the current CUDA device runs at once
    (cudaOccupancyMaxActiveClusters)."""
    return _build.max_active_clusters("blind_rotate_rns", N)


def check_params(N: int, d2: int, q1: int, q2: int, base_g: int) -> None:
    """Raise ValueError unless the kernel takes these parameters."""
    if N not in RING_DIMS:
        raise ValueError(f"the RNS kernel takes N in {RING_DIMS}, not {N}")
    if not (d2 >= 2 and d2 % 2 == 0 and q2 < q1 < (1 << 28)
            and (2 * q1 - 1) * d2 < (1 << 32)):
        raise ValueError("the RNS kernel needs q2 < q1 < 2^28 and "
                         "(2 q1 - 1) * d2 < 2^32")
    if base_g & (base_g - 1) or not 2 <= base_g <= (1 << 27) or base_g >> 1 >= q2:
        raise ValueError("the gadget base must be a power of two in "
                         "[2, 2^27] with base/2 < q2")


def rotate_rns(acc1: torch.Tensor, acc2: torch.Tensor, a_idx: torch.Tensor,
               key: torch.Tensor, q1: int, q2: int, base_g: int,
               throw: int = 0):
    """Batched CGGI blind rotation mod Q = q1*q2 in two residue lanes:
    acc1, acc2 [B, 2, N] int32 residues mod q1 and q2, a_idx [B, n] int32
    exponents in [0, 2N), key [n, 8*d2, N] int32 from `pack_bsk_rns` ->
    (acc1, acc2) [B, 2, N] int32 after n rounds."""
    if acc1.device.type == "cpu":
        return blind_rotate_rns(acc1, acc2, a_idx, key, q1, q2, base_g, throw)
    if acc1.device.type != "cuda":
        raise ValueError(f"rotate_rns runs on cpu or cuda tensors, not {acc1.device}")
    B, two, N = acc1.shape
    n, rows, Nk = key.shape
    d2 = rows // 8
    for name, t in (("acc1", acc1), ("acc2", acc2), ("a_idx", a_idx), ("key", key)):
        if t.device != acc1.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {acc1.device}")
    if (two != 2 or acc2.shape != acc1.shape or Nk != N or rows != 8 * d2
            or tuple(a_idx.shape) != (B, n)):
        raise ValueError(f"bad shapes acc {tuple(acc1.shape)}/{tuple(acc2.shape)}, "
                         f"a_idx {tuple(a_idx.shape)}, key {tuple(key.shape)}")
    check_params(N, d2, q1, q2, base_g)
    out1, out2 = torch.empty_like(acc1), torch.empty_like(acc2)
    if B == 0:
        return out1, out2
    c12 = pow(q2, -1, q1)
    tw = _twiddles(N, q1, q2, str(acc1.device))
    with torch.cuda.device(acc1.device):
        err = _kernel()(
            acc1.data_ptr(), acc2.data_ptr(), out1.data_ptr(), out2.data_ptr(),
            a_idx.data_ptr(), key.data_ptr(), tw.data_ptr(), B, N, n,
            q1, q2, c12, (c12 << 32) // q1, base_g.bit_length() - 1, d2 // 2,
            throw, torch.cuda.current_stream(acc1.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate_rns kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out1, out2
