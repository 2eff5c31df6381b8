"""The blind rotation's hand-written CUDA kernel: key layout, wrapper, count.

Port of `tfhe_tpu/ops/pallas_rotate.py`. `rotate` launches
`csrc/blind_rotate.cu` for CUDA tensors and runs the plain torch version
(`blindrotate.blind_rotate`) for CPU tensors; both read the key in
`pack_bsk`'s layout. Values cross the kernel boundary as int32: residues are
< Q < 2^28, and the Shoup companions are the int32 view of their u32 bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .ntt_sched import schedule

from . import _build, blindrotate, ntt
from . import modmath as mm

LAUNCHES = 0  # kernel launches made by `rotate`
# the ring dimensions the kernel takes: one block per ciphertext up to
# 4096, a cluster of two blocks at 8192
RING_DIMS = (256, 512, 1024, 2048, 4096, 8192)


def _with_shoup(x: torch.Tensor, Q: int) -> torch.Tensor:
    """Residues [..., N] -> [..., 2, N] int32: the values, then their Shoup
    companions as the int32 view of their u32 bits."""
    pair = torch.stack([x, mm.shoup(x, Q)], dim=-2)
    return torch.where(pair >= 1 << 31, pair - (1 << 32), pair).to(torch.int32)


def pack_bsk(bsk_hat: np.ndarray, Q: int) -> torch.Tensor:
    """Evaluation-domain key [n, 2(key), d2, 2(out), N] in natural order ->
    int32 [n, 8*d2, N]: per round, row ((vs*2 + key)*2 + out)*d2 + 2l + j
    (vs 0 = value, 1 = Shoup companion; digit l of input poly j), points in
    the NTT's bit-reversed order. The layout of `pallas_rotate.pack_bsk`."""
    n, _, d2, _, N = bsk_hat.shape
    b = torch.from_numpy(np.asarray(bsk_hat).astype(np.int64))
    b = b[..., schedule(N, Q)["bitrev"]].transpose(2, 3)   # [n, key, out, d2, N]
    # [n, key, out, d2, vs, N] -> [n, vs, key, out, d2, N]
    return _with_shoup(b, Q).movedim(-2, 1).reshape(n, 8 * d2, N).contiguous()


@functools.lru_cache(maxsize=None)
def _twiddles(N: int, Q: int, device: str) -> torch.Tensor:
    """int32 [4, N]: the rows forward, forward', inverse, inverse' of
    `ntt.merged_tables` (x' = Shoup companion, the int32 view of its u32
    bits)."""
    t = torch.from_numpy(ntt.merged_tables(N, Q))
    return _with_shoup(t, Q).reshape(4, N).to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("blind_rotate").tfhe_blind_rotate
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def max_active_clusters() -> int:
    """The most two-block clusters of the N = 8192 kernel that the current
    CUDA device runs at once (cudaOccupancyMaxActiveClusters)."""
    return _build.max_active_clusters("blind_rotate", 8192)


def rotate(acc: torch.Tensor, a_idx: torch.Tensor, bsk_pack: torch.Tensor,
           Q: int, base_g: int, throw: int = 0) -> torch.Tensor:
    """Batched CGGI blind rotation: acc [B, 2, N] int32 residues mod Q,
    a_idx [B, n] int32 exponents in [0, 2N), bsk_pack [n, 8*d2, N] int32
    from `pack_bsk` -> acc [B, 2, N] int32 after n rounds."""
    if acc.device.type == "cpu":
        return blindrotate.blind_rotate(acc, a_idx, bsk_pack, Q, base_g, throw)
    if acc.device.type != "cuda":
        raise ValueError(f"rotate runs on cpu or cuda tensors, not {acc.device}")
    B, two, N = acc.shape
    n, rows, Nk = bsk_pack.shape
    d2 = rows // 8
    for name, t in (("acc", acc), ("a_idx", a_idx), ("bsk_pack", bsk_pack)):
        if t.device != acc.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {acc.device}")
    if (two != 2 or Nk != N or rows != 8 * d2 or d2 % 2
            or tuple(a_idx.shape) != (B, n) or N not in RING_DIMS):
        raise ValueError(f"bad shapes acc {tuple(acc.shape)}, a_idx "
                         f"{tuple(a_idx.shape)}, bsk_pack {tuple(bsk_pack.shape)}")
    if not (Q < (1 << 28) and (2 * Q - 1) * d2 < (1 << 32)):
        raise ValueError("the kernel needs Q < 2^28 and (2Q - 1) * d2 < 2^32")
    if base_g & (base_g - 1) or base_g < 2:
        raise ValueError("the gadget base must be a power of two")
    out = torch.empty_like(acc)
    if B == 0:
        return out
    tw = _twiddles(N, Q, str(acc.device))
    with torch.cuda.device(acc.device):
        err = _kernel()(
            acc.data_ptr(), out.data_ptr(), a_idx.data_ptr(), bsk_pack.data_ptr(),
            tw.data_ptr(), B, N, n, Q, base_g.bit_length() - 1, d2 // 2, throw,
            torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
